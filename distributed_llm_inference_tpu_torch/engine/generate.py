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
    gathers on the device per step and no host read.

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
from ..ops.sampling import sample_token


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
