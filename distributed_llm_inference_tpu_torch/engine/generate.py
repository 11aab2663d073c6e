"""Single-device decode: prefill, chunked extend, the early-exit decode
loop and the dense slot fleet's decode (the JAX package's
engine/generate.py in PyTorch).

  * **prefill** runs the (bucket-padded) prompt chunk and samples the
    first token from the logits at the last valid position;
  * **extend** runs a full chunk of a long prompt into the cache with no
    logits (chunked prefill);
  * **decode** is a Python loop of T=1 steps that exits as soon as every
    row is finished, with the JAX loop's output contract: tokens
    [B, max_steps] pad-masked after a stop token (the stop token itself
    excluded), n_gen [B] counting the tokens this loop emitted;
  * **decode_slots** advances the dense slot fleet (continuous batching
    without a block pool) `num_steps` tokens, each row at its own
    position, and **insert_slot** splices a prefilled batch-1 scratch
    row into a free slot and arms it;
  * grammar constraints (constrain/): **decode**'s optional `constraint`
    carry and **decode_slots_constrained** mask each step's logits with
    `fsm_allowed` and advance the FSM states with `fsm_advance`, two
    gathers on the device per step and no host read;
  * **decode_speculative** (prompt-lookup n-gram drafts) and
    **decode_draft_speculative** (a draft model's greedy chain) verify G
    drafted tokens per target forward over [current, draft] (a T = 1 + G
    chunk, the flash kernel's on the card); the search, the accept
    arithmetic and the history write stay on the device and each verify
    iteration reads one (n_emit, finished) pair back;
  * **score_chunk** / **score_post**: teacher-forced log-probabilities of
    a chunk (echo scoring), the top-N alternatives ranked as
    jax.lax.top_k ranks them;
  * **decode_beam**: HF `num_beams` beam search, the cache reordered by
    parent beam each step (`reorder_cache`).

The cache is updated in place; each function returns it for symmetry
with the JAX API. Random draws come from one `torch.Generator` per
request.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..models import api as M
from ..ops.kv_quant import KVQuant
from ..ops.sampling import sample_token, stable_top


class SamplingParams(NamedTuple):
    """Sampling knobs, in ops/sampling.sample_token's positional order."""

    temperature: float
    top_k: int  # <= 0 disables
    top_p: float  # >= 1 disables
    greedy: bool
    min_p: float  # <= 0 disables
    rep_penalty: float  # 1.0 disables
    freq_penalty: float  # 0.0 disables (OpenAI)
    pres_penalty: float  # 0.0 disables (OpenAI)


def default_sampling(
    temperature=0.7, top_k=50, top_p=0.9, greedy=False, min_p=0.0,
    rep_penalty=1.0, freq_penalty=0.0, pres_penalty=0.0,
) -> SamplingParams:
    return SamplingParams(
        float(temperature), int(top_k), float(top_p), bool(greedy),
        float(min_p), float(rep_penalty), float(freq_penalty),
        float(pres_penalty),
    )


def count_update(counts: torch.Tensor, tokens: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Increment tokens [B]'s generated-count in counts [B, V] (OpenAI
    penalty state); active [B] masks rows whose emission did not happen."""
    V = counts.shape[-1]
    hit = (torch.arange(V, device=counts.device)[None, :] == tokens[:, None])
    hit = hit.to(counts.dtype)
    if active is not None:
        hit = hit * active.to(counts.dtype)[:, None]
    return counts + hit


def presence_update(presence: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark tokens [B] as seen in presence [B, V] (repetition penalty)."""
    V = presence.shape[-1]
    return presence | (torch.arange(V, device=presence.device)[None, :] == tokens[:, None])


def fsm_allowed(cmask: torch.Tensor, fsm: torch.Tensor) -> torch.Tensor:
    """Allowed-token mask rows for the current FSM states: one gather
    ([S, V] table x [B] states -> [B, V]), the grammar constraint's whole
    per-token mask cost (constrain/)."""
    return cmask.index_select(0, fsm)


def fsm_advance(ctrans: torch.Tensor, fsm: torch.Tensor, tokens: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """Advance FSM states [B] through the sampled tokens [B] (one element
    of the [S, V] transition table per row); rows with active=False
    (finished or idle slots) keep their state."""
    nxt = ctrans[fsm.long(), tokens.long()].to(fsm.dtype)
    return torch.where(active, nxt, fsm)


def stop_mask(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """True where a token is a stop token (eos or any cfg.stop_token_ids)."""
    m = tokens == cfg.eos_token_id
    for t in cfg.stop_token_ids:
        m = m | (tokens == t)
    return m


def _forward_step(cfg, params, tokens, cache, pos, valid_start=None):
    """One chunk through the stack; logits only at the final position."""
    x = M.embed(cfg, params, tokens, pos)
    x, cache = M.forward_layers(cfg, params["layers"], x, cache, pos,
                                valid_start=valid_start)
    return M.unembed(cfg, params, x[:, -1:, :])[:, 0, :], cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, prompt_len: int, cache,
            generator, sampling: SamplingParams, valid_start=None, pos: int = 0,
            presence=None, bias=None):
    """Run the padded prompt (or the final chunk of a chunked prefill) at
    offset `pos` and sample the first token.

    tokens [B, T_bucket] right-padded (or LEFT-padded for ragged batches,
    with valid_start [B]); prompt_len: valid tokens IN THIS CHUNK.
    presence [B, V]: the prompt's token set (repetition penalty; None =
    off); bias [V] or [B, V]: OpenAI logit_bias (None = off).
    Returns (first_token [B], logits [B, V], cache)."""
    x = M.embed(cfg, params, tokens, pos)
    x, cache = M.forward_layers(cfg, params["layers"], x, cache, pos,
                                valid_start=valid_start)
    last = x[:, prompt_len - 1:prompt_len, :]
    logits = M.unembed(cfg, params, last)[:, 0, :]
    first = sample_token(generator, logits, *sampling, presence=presence, bias=bias)
    return first, logits, cache


@torch.no_grad()
def extend(cfg: ModelConfig, params, tokens, pos: int, cache):
    """Chunked-prefill step: a FULL prompt chunk at offset `pos` into the
    cache, producing no logits."""
    x = M.embed(cfg, params, tokens, pos)
    _, cache = M.forward_layers(cfg, params["layers"], x, cache, pos)
    return cache


@torch.no_grad()
def decode(
    cfg: ModelConfig,
    params,
    first_token: torch.Tensor,
    cache,
    start_pos: int,
    limit: int,
    generator,
    sampling: SamplingParams,
    valid_start=None,
    presence=None,
    counts=None,
    bias=None,
    constraint=None,
    *,
    max_steps: int,
    with_logprobs: bool = False,
):
    """Early-exit decode loop after prefill.

    first_token [B] (already counted as generated token #0 unless a stop
    token); start_pos: where first_token's K/V lands; limit: steps this
    call (clamped to max_steps). Returns (tokens [B, max_steps], n_gen
    [B], cache), plus per-step log-probabilities [B, max_steps] of the
    emitted tokens under the raw model distribution when with_logprobs.
    The loop reads `finished` on the host once per step to exit early.

    constraint: None, or (fsm0 [B] int32, cmask [S, V] bool, ctrans
    [S, V] int32), a grammar constraint (constrain/): each step masks the
    logits with cmask[fsm] and advances fsm = ctrans[fsm, token], on the
    device, with no further host read."""
    B = first_token.shape[0]
    device = first_token.device
    limit = min(int(limit), int(max_steps))
    pad = cfg.pad_token_id
    out = torch.full((B, max_steps), pad, dtype=torch.long, device=device)
    lps = torch.zeros((B, max_steps if with_logprobs else 1),
                      dtype=torch.float32, device=device)
    n_gen = torch.zeros((B,), dtype=torch.long, device=device)
    finished = stop_mask(cfg, first_token)
    token = torch.where(finished, pad, first_token)
    pos = int(start_pos)
    fsm = cmask = ctrans = None
    if constraint is not None:
        fsm, cmask, ctrans = constraint
    for step in range(limit):
        if bool(finished.all()):
            break
        logits, cache = _forward_step(cfg, params, token[:, None], cache, pos,
                                      valid_start)
        nxt = sample_token(
            generator, logits, *sampling, presence=presence, counts=counts,
            bias=bias,
            allowed=fsm_allowed(cmask, fsm) if fsm is not None else None,
        )
        if presence is not None:
            presence = presence_update(presence, nxt)
        finished = finished | stop_mask(cfg, nxt)
        if counts is not None:
            counts = count_update(counts, nxt, ~finished)
        if fsm is not None:
            fsm = fsm_advance(ctrans, fsm, nxt, ~finished)
        out[:, step] = torch.where(finished, pad, nxt)
        if with_logprobs:
            logp = torch.log_softmax(logits.float(), dim=-1)
            lps[:, step] = torch.gather(logp, -1, nxt[:, None])[:, 0]
        n_gen += (~finished).long()
        token = torch.where(finished, pad, nxt)
        pos += 1
    if with_logprobs:
        return out, n_gen, cache, lps
    return out, n_gen, cache


def pick_bucket(buckets: tuple, n: int) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


# -- continuous batching (slot decode) ---------------------------------------
#
# A fixed fleet of B slots decodes in lock-step, each row at its own
# position (models/llama.forward_layers slots mode), with per-slot
# sampling knobs; a new request arms a FREE slot mid-flight. The state is
# a handful of device tensors that the continuous engine chains from one
# launch to the next without reading them back.


class SlotParams(NamedTuple):
    """Per-slot sampling knobs, all [B]-shaped (broadcast row-wise through
    sample_token, so slots with different knobs decode in one step)."""

    temperature: torch.Tensor  # f32 [B]
    top_k: torch.Tensor  # i32 [B]
    top_p: torch.Tensor  # f32 [B]
    greedy: torch.Tensor  # bool [B]
    min_p: torch.Tensor  # f32 [B]
    rep_penalty: torch.Tensor  # f32 [B]
    freq_penalty: torch.Tensor  # f32 [B] (OpenAI frequency_penalty)
    pres_penalty: torch.Tensor  # f32 [B] (OpenAI presence_penalty)


class SlotState(NamedTuple):
    """Device-side per-slot decode state (the JAX package's SlotState).

    token: last emitted token (its K/V not yet written); pad when inactive.
    pos: cache position where `token`'s K/V lands on the next forward.
    active: slot is mid-generation.
    remaining: tokens this slot may still emit.
    presence: [B, V] seen-token set (repetition-penalty state).
    counts: [B, V] generated-token counts (OpenAI penalty state).
    """

    token: torch.Tensor  # i32 [B]
    pos: torch.Tensor  # i32 [B]
    active: torch.Tensor  # bool [B]
    remaining: torch.Tensor  # i32 [B]
    presence: torch.Tensor  # bool [B, V]
    counts: torch.Tensor  # i32 [B, V]


SLOT_PARAM_DTYPES = (torch.float32, torch.int32, torch.float32, torch.bool,
                     torch.float32, torch.float32, torch.float32, torch.float32)


def init_slots(n_slots: int, vocab_size: int, device=None):
    """An idle fleet: (SlotState, SlotParams) with the JAX defaults."""
    z = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    ones = torch.ones((n_slots,), dtype=torch.float32, device=device)
    zeros = torch.zeros((n_slots,), dtype=torch.float32, device=device)
    state = SlotState(
        z, z.clone(), torch.zeros((n_slots,), dtype=torch.bool, device=device),
        z.clone(),
        torch.zeros((n_slots, vocab_size), dtype=torch.bool, device=device),
        torch.zeros((n_slots, vocab_size), dtype=torch.int32, device=device),
    )
    sparams = SlotParams(
        ones, z.clone(), ones.clone(),
        torch.ones((n_slots,), dtype=torch.bool, device=device),
        zeros, ones.clone(), zeros.clone(), zeros.clone(),
    )
    return state, sparams


def slot_step(cfg: ModelConfig, state: SlotState, sparams: SlotParams,
              logits, generator, allowed=None):
    """ONE copy of the per-step slot sampling and bookkeeping (the JAX
    package's slot_step): each row samples with its own knobs, then
    break-before-append EOS, the budget, the pad token on deactivation
    and the presence / count updates. Inactive rows ride along as greedy
    and emit nothing. allowed [B, V]: optional grammar-constraint mask
    rows (slot_step_constrained gathers them from the fleet table).
    Returns (new_state, emit [B], can_emit [B])."""
    pad = cfg.pad_token_id
    nxt = sample_token(
        generator, logits,
        sparams.temperature[:, None], sparams.top_k[:, None],
        sparams.top_p[:, None], sparams.greedy | ~state.active,
        sparams.min_p[:, None], sparams.rep_penalty[:, None],
        sparams.freq_penalty[:, None], sparams.pres_penalty[:, None],
        presence=state.presence, counts=state.counts, allowed=allowed,
    ).to(torch.int32)
    can_emit = state.active & ~stop_mask(cfg, nxt) & (state.remaining > 0)
    emit = torch.where(can_emit, nxt, pad)
    new = SlotState(
        token=emit,
        pos=state.pos + state.active.to(torch.int32),
        active=can_emit & (state.remaining > 1),
        remaining=state.remaining - can_emit.to(torch.int32),
        presence=presence_update(state.presence, nxt),
        counts=count_update(state.counts, nxt, can_emit),
    )
    return new, emit, can_emit


def slot_step_constrained(cfg: ModelConfig, state: SlotState,
                          sparams: SlotParams, logits, generator, fsm, cmask,
                          ctrans):
    """slot_step under the FLEET constraint tables (constrain/fleet.py):
    fsm [B] indexes the combined table, whose row 0 is the free state, so
    unconstrained slots ride the same two gathers as a no-op. Returns
    (new_state, emit [B], can_emit [B], new_fsm [B])."""
    new, emit, can_emit = slot_step(cfg, state, sparams, logits, generator,
                                    allowed=fsm_allowed(cmask, fsm))
    # emit == the sampled token exactly where can_emit; frozen elsewhere
    return new, emit, can_emit, fsm_advance(ctrans, fsm, emit, can_emit)


def arm_slot(cfg, state: SlotState, sparams: SlotParams, slot: int,
             first_token, prompt_len: int, max_tokens: int, temperature,
             top_k, top_p, greedy, min_p, rep_penalty, freq_penalty,
             pres_penalty, presence_row):
    """Arm slot row `slot` after its prompt K/V landed (the JAX package's
    arm_slot): budget max_tokens - 1, or 0 when the first token is a stop
    token; presence = the prompt's set (presence_row [V] bool) + the first
    token; counts = the first token. first_token is an int or a device
    tensor of one element (a prefill's sample): the stop decision is made
    on the device, so arming never reads it back. Returns new (state,
    sparams)."""
    device = state.token.device
    first = torch.as_tensor(first_token, device=device).reshape(()).to(torch.int32)
    budget = torch.where(stop_mask(cfg, first), 0,
                         max(int(max_tokens) - 1, 0)).to(torch.int32)

    def put(t, value):
        t = t.clone()
        t[slot] = value
        return t

    onehot = torch.arange(state.presence.shape[-1], device=device) == first
    state = SlotState(
        token=put(state.token, first), pos=put(state.pos, int(prompt_len)),
        active=put(state.active, budget > 0),
        remaining=put(state.remaining, budget),
        presence=put(state.presence, presence_row.to(device) | onehot),
        counts=put(state.counts, onehot.to(torch.int32)),
    )
    knobs = (temperature, top_k, top_p, greedy, min_p, rep_penalty,
             freq_penalty, pres_penalty)
    sparams = SlotParams(*(put(t, v) for t, v in zip(sparams, knobs)))
    return state, sparams


@torch.no_grad()
def decode_slots(cfg: ModelConfig, params, state: SlotState, cache, generator,
                 sparams: SlotParams, *, num_steps: int):
    """Advance every slot of the dense fleet cache num_steps tokens (the
    JAX scan becomes a Python loop with no host read). Inactive rows ride
    along: they forward their pad token and write K/V at their frozen pos,
    garbage confined to their own cache row and never attended. Returns
    (emitted [num_steps, B] int32, emit_mask [num_steps, B] bool, state,
    cache)."""
    emitted, masks = [], []
    for _ in range(num_steps):
        logits, cache = _forward_step(cfg, params, state.token[:, None], cache,
                                      state.pos)
        state, emit, can_emit = slot_step(cfg, state, sparams, logits, generator)
        emitted.append(emit)
        masks.append(can_emit)
    return torch.stack(emitted), torch.stack(masks), state, cache


@torch.no_grad()
def decode_slots_constrained(cfg: ModelConfig, params, state: SlotState, cache,
                             generator, sparams: SlotParams, fsm, cmask, ctrans,
                             *, num_steps: int):
    """decode_slots under the fleet constraint tables (cmask [S, V] bool,
    ctrans [S, V] int32): the same chunk contract plus the fsm [B] int32
    carry, chained on the device between chunks (admission and release
    set rows from the host; decode never reads it back). The dense fleet
    launches it only while >= 1 constrained slot is active. Returns
    (emitted, emit_mask, state, cache, fsm)."""
    emitted, masks = [], []
    for _ in range(num_steps):
        logits, cache = _forward_step(cfg, params, state.token[:, None], cache,
                                      state.pos)
        state, emit, can_emit, fsm = slot_step_constrained(
            cfg, state, sparams, logits, generator, fsm, cmask, ctrans)
        emitted.append(emit)
        masks.append(can_emit)
    return torch.stack(emitted), torch.stack(masks), state, cache, fsm


@torch.no_grad()
def insert_slot(cfg: ModelConfig, cache, scratch, state: SlotState,
                sparams: SlotParams, slot: int, *arm):
    """Splice a freshly prefilled batch-1 scratch cache (same max_seq as
    the fleet cache) into fleet row `slot` in place, the whole row (stale
    high positions are never attended), then arm its state (arm_slot's
    arguments after `slot`). An int8 cache splices data and scales.
    Returns (cache, state, sparams)."""
    for name in ("k", "v"):
        big, small = cache[name], scratch[name]
        if isinstance(big, KVQuant):
            big.q[:, slot].copy_(small.q[:, 0])
            big.s[:, slot].copy_(small.s[:, 0])
        else:
            big[:, slot].copy_(small[:, 0])
    state, sparams = arm_slot(cfg, state, sparams, slot, *arm)
    return cache, state, sparams


def kill_slot(state: SlotState, slot: int) -> SlotState:
    """Force-deactivate a slot (cancel, deadline, textual stop)."""
    active = state.active.clone()
    active[slot] = False
    return state._replace(active=active)


def pack_chunk(emitted, emit_mask, active):
    """One decode chunk's host-bound results as ONE int32 array [2K+1, B]
    (emitted / mask / final active): one device-to-host copy per chunk."""
    return torch.cat([
        emitted.to(torch.int32), emit_mask.to(torch.int32),
        active.to(torch.int32)[None, :],
    ], dim=0)


# -- speculation, scoring and beam search (the solo engine's features) -------

# the JAX package's NEG_INF_F32: finished and dead beams sit here, so ties
# between them are routine
NEG_INF_F32 = -1e9


def _fetch(loop, *scalars) -> list:
    """A speculation loop's one host read per verify iteration: the 0-d
    device scalars stacked into one device-to-host copy, counted on
    `loop.host_reads`."""
    loop.host_reads += 1
    return torch.stack([t.reshape(()).to(torch.long) for t in scalars]).tolist()


def _accept(cfg, draft, window, limit: int, n_gen: int):
    """The verify arithmetic shared by both speculation loops, on the
    device: the longest draft prefix equal to the target's argmax window,
    plus the correction token, cut before the first stop token (break
    before append) and at the budget. Returns (emit_ok [1+G], n_emit,
    saw_eos), the last two 0-d tensors."""
    G = draft.shape[0]
    j = torch.arange(G + 1, device=window.device)
    n_acc = torch.cumprod((draft == window[:G]).long(), 0).sum()
    valid = j <= n_acc
    cum_eos = torch.cumsum(stop_mask(cfg, window).long(), 0) > 0
    emit_ok = valid & ~cum_eos
    n_emit = torch.clamp(emit_ok.sum(), max=limit - n_gen)
    return emit_ok & (j < n_emit), n_emit, (valid & cum_eos).any()


def _last_emitted(window, n_emit):
    """window[max(n_emit - 1, 0)] as a 0-d device tensor: an index_select
    (indexing with a 0-d tensor would read it back to the host)."""
    return window.index_select(0, torch.clamp(n_emit - 1, min=0).reshape(1))[0]


def _verify_fwd(cfg, params):
    """The target's verify forward: [1, 1+G] tokens at pos -> (logits
    [1, 1+G, V], cache)."""
    def fwd(tokens_in, cache, pos):
        x = M.embed(cfg, params, tokens_in, pos)
        x, cache = M.forward_layers(cfg, params["layers"], x, cache, pos)
        return M.unembed(cfg, params, x), cache
    return fwd


@torch.no_grad()
def decode_speculative(cfg: ModelConfig, params, first_token, cache, hist,
                       hist_len: int, limit: int, *, max_steps: int,
                       draft_len: int = 4):
    """Greedy decode with prompt-lookup (n-gram) self-speculation (the JAX
    package's decode_speculative): each iteration drafts the G tokens that
    followed the most recent earlier occurrence of the current 2-gram in
    the token history, runs ONE forward over [current, draft] and accepts
    the longest prefix equal to the model's own argmax, plus its
    correction token. Every emitted token is the argmax given the
    accepted context: in fp32 the ids equal plain greedy decode's; in bf16
    the T = 1 + G verify chunk (the flash kernel on the card) and T = 1
    steps (the einsum) may resolve a near-tie differently.

    KV discipline: the forward writes K/V for [current, draft] at
    pos..pos+G. Accepted slots hold exactly the accepted tokens' K/V; the
    first rejected slot is overwritten by the next iteration's forward
    (its input starts with the correction token at that position), and
    later stale slots sit beyond the query position until overwritten,
    the never-attended argument of padded prefill. The caller keeps
    pos+G inside the cache (the engine's decode headroom).

    hist [1, H] long: the token history, the prompt in [0, hist_len),
    written in place; H bounds prompt + generated + the draft overshoot.
    Greedy only, B = 1. Returns (out [1, max_steps], n_gen [1], cache)."""
    return spec_loop(cfg, _verify_fwd(cfg, params), first_token, cache, hist,
                     hist_len, limit, max_steps=max_steps, draft_len=draft_len)


def spec_loop(cfg: ModelConfig, fwd, first_token, cache, hist, hist_len: int,
              limit: int, *, max_steps: int, draft_len: int = 4):
    """The prompt-lookup loop behind `decode_speculative` (the JAX
    package's spec_loop, its while_loop a Python loop). `fwd(tokens
    [1, 1+G], cache, pos) -> (logits [1, 1+G, V], cache)` is the verify
    forward. The 2-gram search, the draft gather, the accept arithmetic
    and the history and output writes run on the device; the host reads
    back the first token's stop flag once, then one (n_emit, finished)
    pair per iteration, which also gives it the next position."""
    G = draft_len
    H = hist.shape[1]
    device = first_token.device
    pad = cfg.pad_token_id
    # G+1 columns of scratch: each iteration writes its whole window at the
    # emit offset; rejected tails are overwritten later and sliced off
    out = torch.full((1, max_steps + G + 1), pad, dtype=torch.long, device=device)
    limit = min(int(limit), int(max_steps))
    hist_len = int(hist_len)
    hist[0, hist_len] = first_token[0]
    (stop0,) = _fetch(spec_loop, stop_mask(cfg, first_token[0]))
    finished = bool(stop0) or limit <= 0
    # invariant: `cur` is the last emitted token (counted, its K/V not yet
    # written), `pos` its position, `hlen` = pos + 1 tokens of history
    cur = first_token[0].long()
    pos, hlen, n_gen = hist_len, hist_len + 1, 0
    idx = torch.arange(H - 1, device=device)
    offs = torch.arange(G, device=device)
    while n_gen < limit and not finished:
        c0, c1 = hist[0, max(hlen - 2, 0)], hist[0, hlen - 1]
        # the match must be strictly earlier than the current bigram
        is_match = (hist[0, :H - 1] == c0) & (hist[0, 1:] == c1) & (idx + 2 < hlen)
        last = torch.where(is_match, idx, -1).max()
        # junk drafts (no match, an overrun) are harmless: a token is only
        # accepted when it EQUALS the model's argmax
        dstart = torch.where(last >= 0, last + 2, 0).clamp(max=H - G)
        draft = hist[0].index_select(0, dstart + offs)
        logits, cache = fwd(torch.cat([cur[None], draft])[None, :], cache, pos)
        window = logits[0].argmax(-1)
        emit_ok, n_emit, saw_eos = _accept(cfg, draft, window, limit, n_gen)
        out[0, n_gen:n_gen + G + 1] = torch.where(emit_ok, window, pad)
        # window[j] is the token at position hlen + j
        start = min(hlen, H - (G + 1))
        hist[0, start:start + G + 1] = window
        cur = _last_emitted(window, n_emit)
        n_e, eos = _fetch(spec_loop, n_emit, saw_eos)
        finished = bool(eos) or n_e <= 0
        pos, hlen, n_gen = pos + n_e, hlen + n_e, n_gen + n_e
    return out[:, :max_steps], torch.tensor([n_gen], device=device), cache


spec_loop.host_reads = 0


@torch.no_grad()
def decode_draft_speculative(cfg: ModelConfig, params, dcfg: ModelConfig,
                             dparams, first_token, cache, dcache,
                             start_pos: int, limit: int, *, max_steps: int,
                             draft_len: int = 4):
    """Greedy decode verified against a separate draft model (the JAX
    package's decode_draft_speculative): each iteration the draft proposes
    G tokens by its own greedy chain, the target runs ONE forward over
    [current, draft] and emits the longest matching prefix plus its
    correction token (spec_loop's acceptance).

    KV discipline (both caches hold the prompt on entry): the draft chain
    runs G+1 steps from `cur`, writing draft K/V at pos..pos+G, one step
    more than it proposes, so a full accept plus the bonus token leaves no
    unwritten slot at pos+G for the next chain to attend; the target's
    verify writes pos..pos+G and its rejected slots are overwritten before
    they are attended. Greedy only, B = 1. Returns (out [1, max_steps],
    n_gen [1], cache, dcache)."""
    def dfwd(tok_11, dc, p):
        x = M.embed(dcfg, dparams, tok_11, p)
        x, dc = M.forward_layers(dcfg, dparams["layers"], x, dc, p)
        return M.unembed(dcfg, dparams, x), dc

    return draft_spec_loop(cfg, _verify_fwd(cfg, params), dfwd, first_token,
                           cache, dcache, start_pos, limit, max_steps=max_steps,
                           draft_len=draft_len)


def draft_spec_loop(cfg: ModelConfig, fwd, dfwd, first_token, cache, dcache,
                    start_pos: int, limit: int, *, max_steps: int,
                    draft_len: int = 4):
    """The two-model loop behind `decode_draft_speculative`: `fwd` is the
    target's verify forward, `dfwd(tok [1, 1], dcache, pos)` one draft
    step (T = 1). The chain's argmaxes stay on the device; the host reads
    the first token's stop flag once, then one (n_emit, finished) pair per
    iteration."""
    G = draft_len
    device = first_token.device
    pad = cfg.pad_token_id
    out = torch.full((1, max_steps + G + 1), pad, dtype=torch.long, device=device)
    limit = min(int(limit), int(max_steps))
    (stop0,) = _fetch(draft_spec_loop, stop_mask(cfg, first_token[0]))
    finished = bool(stop0) or limit <= 0
    cur = first_token[0].long()
    pos, n_gen = int(start_pos), 0
    while n_gen < limit and not finished:
        # G+1 draft steps: the last writes d_{G-1}'s K/V; its proposal is
        # discarded
        tok, proposals = cur, []
        for i in range(G + 1):
            lg, dcache = dfwd(tok.reshape(1, 1), dcache, pos + i)
            tok = lg[0, 0].argmax()
            proposals.append(tok)
        draft = torch.stack(proposals[:G])
        logits, cache = fwd(torch.cat([cur[None], draft])[None, :], cache, pos)
        window = logits[0].argmax(-1)
        emit_ok, n_emit, saw_eos = _accept(cfg, draft, window, limit, n_gen)
        out[0, n_gen:n_gen + G + 1] = torch.where(emit_ok, window, pad)
        cur = _last_emitted(window, n_emit)
        n_e, eos = _fetch(draft_spec_loop, n_emit, saw_eos)
        finished = bool(eos) or n_e <= 0
        pos, n_gen = pos + n_e, n_gen + n_e
    return out[:, :max_steps], torch.tensor([n_gen], device=device), cache, dcache


draft_spec_loop.host_reads = 0


@torch.no_grad()
def score_chunk(cfg: ModelConfig, params, tokens, pos: int, cache, *,
                top_n: int = 0):
    """Teacher-forced scoring of one chunk at offset `pos` (the JAX
    package's score_chunk): the log-probability of every within-chunk
    token given its prefix. tokens [B, T] (right-padded only in the final
    chunk); a T > 1 chunk at a scalar pos, so the flash kernel's on the
    card. Returns (within_lp [B, T-1], top_v [B, T-1, top_n], top_i,
    last_lp [B, V], cache): last_lp scores the next chunk's first token
    across the boundary."""
    x = M.embed(cfg, params, tokens, pos)
    x, cache = M.forward_layers(cfg, params["layers"], x, cache, pos)
    return score_post(M.unembed(cfg, params, x), tokens, top_n) + (cache,)


def score_post(logits, tokens, top_n: int):
    """The scoring tail: [B, T, V] teacher-forced logits -> (within_lp,
    top_v, top_i, last_lp), log-softmax in fp32; the top-N alternatives
    in jax.lax.top_k's order (`stable_top`)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    within = torch.gather(lp[:, :-1, :], -1, tokens[:, 1:, None].long())[..., 0]
    if top_n > 0:
        top_v, top_i = stable_top(lp[:, :-1, :], top_n)
    else:
        B, Tm1 = within.shape
        top_v = torch.zeros((B, Tm1, 0), dtype=torch.float32, device=lp.device)
        top_i = torch.zeros((B, Tm1, 0), dtype=torch.long, device=lp.device)
    return within, top_v, top_i, lp[:, -1, :]


def map_cache(cache, fn):
    """fn over every tensor of a {"k", "v"} cache, an int8 leaf's data and
    scales alike (their batch axis is 1 and their sequence axis 3 in
    both)."""
    return {name: KVQuant(fn(x.q), fn(x.s)) if isinstance(x, KVQuant) else fn(x)
            for name, x in cache.items()}


def tile_cache(cache, n: int):
    """A batch-1 cache repeated to n rows on the batch axis: every beam
    starts from the same prompt."""
    return map_cache(cache, lambda x: x.repeat((1, n) + (1,) * (x.dim() - 2)))


def reorder_cache(cache, parents: torch.Tensor):
    """Every cache row gathered from its parent beam (parents [nb] on the
    cache's device): one index_select per tensor, on the device."""
    return map_cache(cache, lambda x: x.index_select(1, parents))


@torch.no_grad()
def decode_beam(cfg: ModelConfig, params, logits0, cache, start_pos: int,
                limit: int, length_penalty: float, *, max_steps: int,
                num_beams: int, early_stopping: bool = False):
    """Deterministic beam search after the prompt's prefill (HF
    `generate(num_beams=N, do_sample=False)` semantics, the JAX package's
    decode_beam). logits0 [num_beams, V] (identical rows), cache
    [L, num_beams, ...] (identical rows). Returns (tokens [num_beams,
    max_steps], the final beams best first, pad-masked after each one's
    length (a stop token excluded), n_gen [num_beams], scores
    [num_beams], cache)."""
    return beam_loop(
        cfg, lambda last, c, pos: _forward_step(cfg, params, last, c, pos),
        logits0, cache, start_pos, limit, length_penalty, max_steps=max_steps,
        num_beams=num_beams, early_stopping=early_stopping,
    )


def beam_loop(cfg: ModelConfig, fwd, logits0, cache, start_pos: int, limit: int,
              length_penalty: float, *, max_steps: int, num_beams: int,
              early_stopping: bool = False):
    """The beam-search loop behind `decode_beam` (the JAX package's
    beam_loop). `fwd(last [nb, 1], cache, pos) -> (logits [nb, V], cache)`
    is one T = 1 step. The first expansion takes row 0's top num_beams
    tokens; each later step expands every alive beam by the whole vocab,
    keeps the best 2 x num_beams candidates, retires stop candidates into
    a finished pool scored sum_logprobs / len**length_penalty (HF
    BeamSearchScorer), keeps the best num_beams alive ones and reorders
    the cache by parent beam. early_stopping=True stops once num_beams
    hypotheses finished; False while an alive beam could still beat the
    worst finished score. Every ranking is a stable descending sort, so
    ties (routine at NEG_INF_F32) resolve as the JAX package's do. The
    loop's condition is read on the host once per step."""
    nb = num_beams
    V = logits0.shape[-1]
    device = logits0.device
    pad = cfg.pad_token_id
    limit = min(int(limit), int(max_steps))
    lpen = torch.tensor(float(length_penalty), dtype=torch.float32, device=device)

    seed_scores, seed_tokens = stable_top(torch.log_softmax(logits0[0].float(), -1), nb)
    out0 = torch.full((nb, max_steps), pad, dtype=torch.long, device=device)
    alive_out = out0.clone()
    alive_out[:, 0] = seed_tokens
    alive_len = torch.ones((nb,), dtype=torch.long, device=device)
    fin_out, fin_len = out0, torch.zeros((nb,), dtype=torch.long, device=device)
    # seed beams that ARE stop tokens retire at once, as 0-token text
    seed_stop = stop_mask(cfg, seed_tokens)
    fin_scores = torch.where(seed_stop, seed_scores / (1.0 ** lpen), NEG_INF_F32)
    alive_scores = torch.where(seed_stop, NEG_INF_F32, seed_scores)
    order = torch.argsort(-fin_scores, stable=True)
    fin_scores, fin_out, fin_len = fin_scores[order], fin_out[order], fin_len[order]

    def more(step: int) -> bool:
        if early_stopping:
            m = (fin_scores <= NEG_INF_F32 / 2).any()
        else:
            steps = torch.tensor(float(max(step, 1)), device=device)
            m = fin_scores.min() < alive_scores.max() / steps ** lpen
        return bool(m & (alive_scores > NEG_INF_F32 / 2).any())

    step, pos = 1, int(start_pos)
    rows2 = torch.arange(2 * nb, device=device)
    while step < limit and more(step):
        last = torch.gather(alive_out, 1, (alive_len - 1)[:, None])
        logits, cache = fwd(last, cache, pos)
        cand = alive_scores[:, None] + torch.log_softmax(logits.float(), -1)
        # 2 x nb candidates guarantee nb non-stop continuations survive
        top_scores, top_idx = stable_top(cand.reshape(nb * V), 2 * nb)
        parent, token = top_idx // V, top_idx % V
        is_stop = stop_mask(cfg, token)
        cand_out, cand_len = alive_out[parent], alive_len[parent]
        ext_out = cand_out.clone()
        ext_out[rows2, cand_len.clamp(0, max_steps - 1)] = token
        # finished pool: the kept nb plus this step's stop candidates (the
        # stop token excluded from their text)
        new_fin = torch.where(is_stop, top_scores / cand_len.float() ** lpen,
                              NEG_INF_F32)
        pool = torch.cat([fin_scores, new_fin])
        keep = torch.argsort(-pool, stable=True)[:nb]
        fin_scores = pool[keep]
        fin_out = torch.cat([fin_out, cand_out])[keep]
        fin_len = torch.cat([fin_len, cand_len])[keep]
        # alive pool: the best nb non-stop candidates
        rank = torch.where(is_stop, NEG_INF_F32, top_scores)
        keep_a = torch.argsort(-rank, stable=True)[:nb]
        alive_scores, alive_out = rank[keep_a], ext_out[keep_a]
        alive_len = cand_len[keep_a] + 1
        cache = reorder_cache(cache, parent[keep_a])
        step, pos = step + 1, pos + 1

    # unfinished alive beams count as hypotheses of their length (the
    # budget ran out: HF's final add of running beams)
    alive_final = alive_scores / alive_len.float().clamp(min=1.0) ** lpen
    all_scores = torch.cat([fin_scores, alive_final])
    best = torch.argsort(-all_scores, stable=True)[:nb]
    out = torch.cat([fin_out, alive_out])[best]
    n_gen = torch.cat([fin_len, alive_len])[best]
    col = torch.arange(max_steps, device=device)[None, :]
    return torch.where(col < n_gen[:, None], out, pad), n_gen, all_scores[best], cache
