"""The microbatched 1F1B pipeline schedule (the JAX package's
parallel/schedule.py: MicrobatchPipelineBackend), and the pure planning of
the multi-process MPMD runtime (serving/stage_runtime.py: `plan_stages`,
`mpmd_1f1b_order`).

MicrobatchPipelineBackend splits a fleet of rows into M >= pp
microbatches that chase each other around the pp ring. In microstep t:

    stage 0 embeds microbatch     t mod M (its current token)
    stage s runs its layers on    (t - s) mod M, on that microbatch's
                                  rows of its cache
    one ring shift moves every stage's output to the next stage (the last
    stage's to stage 0), under the int8 wire when it is on
    one sample event takes        (t - S + 1) mod M: stage 0's landed
                                  [b_m, 1, D] window reaches every pp rank
                                  (the masked broadcast), the vocab shards
                                  are gathered, every rank samples

With M == S the token sampled in microstep t re-enters stage 0 in t + 1,
so in steady state every stage computes in every microstep: the bubble
of the recv-driven chain (parallel/pipeline.py), where the stages run in
turn, is gone.

Each method is one program on every rank, as in parallel/pipeline.py;
every rank keeps the same per-microbatch state (token, position,
finished rows, emit count) and evaluates the same gates, so every rank
makes the same collectives in the same order. Where the JAX program
computes every microstep and discards the gated-off work, a rank of the
port skips it: a stage whose microbatch is gated off neither computes
nor sends, the stage after it, which knows the gate, receives nothing,
and the sample event runs only where the JAX program keeps its result.
Bytes counted: the shifts on the "1f1b" path, the sample events'
broadcasts on "broadcast" (the JAX link table's paths), as each rank
really sent them.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from ..engine.generate import stop_mask
from ..models import api as M
from ..ops.kv_quant import KVQuant
from ..ops.sampling import sample_token
from ..ops.wire_quant import masked_psum, wire_shift
from .pipeline import PipelineBackend
from .vocab import unembed_sharded


class MicrobatchPipelineBackend(PipelineBackend):
    """PipelineBackend whose fleet-shaped calls run the 1F1B schedule.

    A prefill or a decode whose row count is a multiple of
    batch_granularity (dp x M) and that carries no variant operand
    (presence, counts, bias, constraint, log-probabilities) runs the
    microstep loop; every other call (solo rows, beams, the variant
    programs, chunked prefill, the continuous fleets' slot programs) runs
    the inherited plain-ring programs, identical to PipelineBackend's.

    Batch contract on the 1F1B path: rows are grouped [dp block]
    [microbatch block][rows] and come back in the same order.

    Sampling: greedy rows equal the plain pipeline's id for id. Sampled
    fleet rows draw from a stream per (microbatch, emit index) derived
    from the request's generator (the JAX `fold_in` per microbatch and
    emit index): reproducible on this backend, and not the sequential
    stream the plain ring draws."""

    name = "pipeline-1f1b"
    supports_ragged = True

    def __init__(self, cfg, params, mesh, n_microbatches: Optional[int] = None,
                 return_prefill_logits: bool = False, wire_quant=None, seed: int = 0,
                 store=None):
        self.n_microbatches = self.check(mesh.cfg, n_microbatches)
        # prefill returns zero-width [rows, 0] logits unless asked: the
        # engine only reads the sampled first tokens
        self.return_prefill_logits = bool(return_prefill_logits)
        super().__init__(cfg, params, mesh, wire_quant=wire_quant, seed=seed, store=store)

    @staticmethod
    def check(mesh_cfg, n_microbatches: Optional[int]) -> int:
        """The microbatch count (default pp), refused below pp in the JAX
        constructor's words (the runtime checks before it spawns a rank)."""
        pp = mesh_cfg.pp
        n = int(n_microbatches or pp)
        if n < pp:
            raise ValueError(
                f"n_microbatches={n} must be >= pp={pp}: "
                "a microbatch must vacate stage 0 before its next token returns"
            )
        return n

    @property
    def batch_granularity(self) -> int:
        """The row-count quantum of the 1F1B path: the engine pads a
        fleet up to a multiple (engine.batch_buckets_for)."""
        return self.dp * self.n_microbatches

    def health(self) -> list[dict]:
        return [dict(line, microbatches=self.n_microbatches)
                for line in super().health()]

    def _fleet(self, rows: int) -> bool:
        return rows % self.batch_granularity == 0

    def prefill(self, tokens, prompt_len, cache, generator, sampling,
                valid_start=None, presence=None, bias=None):
        if not self._fleet(tokens.shape[0]) or presence is not None or bias is not None:
            return super().prefill(tokens, prompt_len, cache, generator, sampling,
                                   valid_start, presence, bias)
        return self._run("schedule:prefill_1f1b", tokens, prompt_len, cache,
                         generator, sampling, valid_start, self.n_microbatches,
                         self.return_prefill_logits)

    def decode(self, first_token, cache, start_pos, limit, generator, sampling,
               valid_start=None, presence=None, counts=None, bias=None,
               constraint=None, *, max_steps, with_logprobs=False):
        extras = (presence is not None or counts is not None or bias is not None
                  or constraint is not None or with_logprobs)
        if not self._fleet(first_token.shape[0]) or extras:
            return super().decode(first_token, cache, start_pos, limit, generator,
                                  sampling, valid_start, presence, counts, bias,
                                  constraint, max_steps=max_steps,
                                  with_logprobs=with_logprobs)
        return self._run("schedule:decode_1f1b", first_token, cache, start_pos, limit,
                         generator, sampling, valid_start, self.n_microbatches,
                         max_steps=max_steps)


# -- the rank side: each function one program's body on a rank -------------------


def _streams(generator: torch.Generator):
    """A generator per tuple of ids, derived from `generator`'s state (the
    same on every rank of the pp ring)."""
    base = generator.get_state().cpu().numpy().tobytes()

    def at(*ids) -> torch.Generator:
        h = hashlib.blake2b(base + b"".join(int(i).to_bytes(8, "little") for i in ids),
                            digest_size=8).digest()
        g = torch.Generator(device=generator.device)
        g.manual_seed(int.from_bytes(h, "little") >> 1)
        return g

    return at


def _microbatch_rows(cache: dict, row0: int, n: int) -> dict:
    """Views of rows [row0, row0 + n) of every leaf (batch axis 1): the
    layers write the microbatch's K/V through them in place."""
    def rows(leaf):
        if isinstance(leaf, KVQuant):
            return KVQuant(leaf.q.narrow(1, row0, n), leaf.s.narrow(1, row0, n))
        return leaf.narrow(1, row0, n)

    return {k: rows(v) for k, v in cache.items()}


def _stage_apply(rp, x, cache, pos, m: int, b_m: int, vs):
    """The rank's layers on microbatch m's rows of its cache (the JAX
    `_stage_apply`)."""
    st = rp.stage
    y, _ = M.family(rp.cfg).forward_layers(
        rp.cfg, st.layers, x, _microbatch_rows(cache, m * b_m, b_m), pos,
        valid_start=None if vs is None else vs[m], tp_group=st.tp, ep_axis=st.ep)
    return y


def _stage0_sample(rp, last, generator, sampling):
    """Stage 0's landed window [b_m, 1, D] on every pp rank (the masked
    broadcast), the vocab shards gathered, the same token sampled on every
    rank (the JAX `_stage0_sample`). Returns (tok [b_m], logits [b_m, V])."""
    st = rp.stage
    last = masked_psum(last, st.pp, 0, quant=st.quant)
    logits = unembed_sharded(rp.cfg, st.shared, last, st.pp)[:, 0, :]
    return sample_token(generator, logits, *sampling), logits


@torch.no_grad()
def prefill_1f1b(rp, tokens, prompt_len, cache, generator, sampling, valid_start,
                 n_mb: int, with_logits: bool):
    """The 1F1B ingest: M + S - 1 microsteps; microbatch m's first token
    is sampled in microstep m + S - 1 from stage 0's landed window at
    prompt_len - 1."""
    cfg, st = rp.cfg, rp.stage
    S, s = st.S, st.s
    B = tokens.shape[0]
    toks, vs = rp._rows(tokens, B), rp._rows(valid_start, B)
    rows, bucket = toks.shape
    b_m = rows // n_mb
    if vs is not None:
        vs = vs.reshape(n_mb, b_m)
    stream = _streams(generator)
    dev = toks.device
    first = torch.zeros(rows, dtype=torch.long, device=dev)
    logits = torch.zeros((rows, cfg.vocab_size if with_logits else 0),
                         dtype=torch.float32, device=dev)
    like = torch.empty((b_m, bucket, cfg.dim), dtype=cfg.torch_dtype, device=dev)
    buf = None
    for t in range(n_mb + S - 1):
        x = buf
        if t < n_mb:
            # every pp rank sums its vocab shard of stage 0's embedding
            x_in = st.embed(toks[t * b_m:(t + 1) * b_m], 0)
            if s == 0:
                x = x_in
        y = None
        if 0 <= t - s < n_mb:
            y = _stage_apply(rp, x, cache, 0, t - s, b_m, vs)
        prev = (s - 1) % S
        buf = wire_shift(y, st.pp, like if 0 <= t - prev < n_mb else None,
                         quant=st.quant)
        m = t - (S - 1)
        if 0 <= m < n_mb:
            last = (buf[:, prompt_len - 1:prompt_len] if s == 0
                    else like.new_zeros((b_m, 1, cfg.dim)))
            tok, lg = _stage0_sample(rp, last, stream(m), sampling)
            first[m * b_m:(m + 1) * b_m] = tok
            if with_logits:
                logits[m * b_m:(m + 1) * b_m] = lg
    return rp._cat(first), rp._cat(logits), cache


@torch.no_grad()
def decode_1f1b(rp, first_token, cache, start_pos, limit, generator, sampling,
                valid_start, n_mb: int, *, max_steps: int):
    """The 1F1B decode: microsteps until every microbatch is done (its rows
    finished, or `limit` tokens emitted) or S - 1 + limit x M have run;
    each sample event emits one token for its microbatch's rows.

    Whether a microbatch's rows have all finished stays on the device and
    is read once a round of M microsteps, where the JAX loop reads it in
    every sample event: until that read a finished microbatch runs on,
    pads in and pads out, so the tokens and counts are the same."""
    cfg, st = rp.cfg, rp.stage
    S, s = st.S, st.s
    B = first_token.shape[0]
    ft, vs = rp._rows(first_token, B), rp._rows(valid_start, B)
    rows = ft.shape[0]
    b_m = rows // n_mb
    if vs is not None:
        vs = vs.reshape(n_mb, b_m)
    limit = min(int(limit), int(max_steps))
    pad = cfg.pad_token_id
    dev = ft.device
    stream = _streams(generator)
    finished = stop_mask(cfg, ft).reshape(n_mb, b_m)
    cur = torch.where(finished, pad, ft.reshape(n_mb, b_m))
    done = [bool(f) or limit <= 0 for f in finished.all(dim=1).tolist()]
    pos = [int(start_pos)] * n_mb
    emitted = [0] * n_mb
    out = torch.full((n_mb, b_m, max_steps), pad, dtype=torch.long, device=dev)
    n_gen = torch.zeros((n_mb, b_m), dtype=torch.long, device=dev)
    like = torch.empty((b_m, 1, cfg.dim), dtype=cfg.torch_dtype, device=dev)

    def gate(stage: int, t: int) -> bool:  # the JAX (t >= s) & ~done[m_here]
        return t >= stage and not done[(t - stage) % n_mb]

    buf = None
    t = 0
    while t < S - 1 + limit * n_mb and not all(done):
        x = buf
        m_in = t % n_mb
        if not done[m_in]:
            x_in = st.embed(cur[m_in][:, None], pos[m_in])
            if s == 0:
                x = x_in
        y = None
        if gate(s, t):
            m = (t - s) % n_mb
            y = _stage_apply(rp, x, cache, pos[m], m, b_m, vs)
        buf = wire_shift(y, st.pp, like if gate((s - 1) % S, t) else None,
                         quant=st.quant)
        m = (t - (S - 1)) % n_mb
        if gate(S - 1, t):
            last = buf if s == 0 else torch.zeros_like(like)
            k = emitted[m]
            tok, _ = _stage0_sample(rp, last, stream(m, k), sampling)
            newly = finished[m] | stop_mask(cfg, tok)
            out[m, :, k] = torch.where(newly, pad, tok)
            n_gen[m] += (~newly).long()
            cur[m] = torch.where(newly, pad, tok)
            finished[m] = newly
            pos[m] += 1
            emitted[m] = k + 1
            done[m] = emitted[m] >= limit
        t += 1
        if t % n_mb == 0:  # every rank reads the same rows at the same t
            done = [d or f for d, f in zip(done, finished.all(dim=1).tolist())]
    return rp._cat(out.reshape(rows, max_steps)), rp._cat(n_gen.reshape(rows)), cache


# -- MPMD glue (pure, host-side) ----------------------------------------------------
# The multi-process MPMD runtime (serving/stage_runtime.py) drives
# microbatches through stage PROCESSES over the stage transport; these
# helpers are its pure planning half.



def plan_stages(n_layers: int, n_stages: int) -> list:
    """Contiguous [lo, hi) layer ranges for each of `n_stages` stages.

    Remainder layers go to the EARLIEST stages (stage 0 also pays the
    embed, but the alternative — loading the tail stage, which already
    owns final_norm + lm_head — is strictly worse)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"need 1 <= n_stages ({n_stages}) <= n_layers ({n_layers})"
        )
    base, rem = divmod(n_layers, n_stages)
    ranges, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def mpmd_1f1b_order(n_stages: int, n_microbatches: int) -> list:
    """The 1F1B wavefront as an explicit event list: [(tick, stage,
    microbatch), ...] such that microbatch m hits stage s at tick m + s.

    Properties the runtime (and tests) rely on:
      * per-stage order is FIFO in microbatch id — so a stage worker
        draining a queue in arrival order IS this schedule;
      * stage s+1 sees microbatch m strictly after stage s does — the
        dependency chain is the tick ordering;
      * makespan is n_microbatches + n_stages - 1 ticks (the classic
        fill-drain trapezoid)."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("n_stages and n_microbatches must be >= 1")
    events = [
        (m + s, s, m)
        for m in range(n_microbatches)
        for s in range(n_stages)
    ]
    events.sort()
    return events
