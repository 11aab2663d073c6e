"""The context-parallel backend: the SEQUENCE is the sharded axis (the JAX
package's parallel/context.py: ContextParallelBackend).

An `sp` ring of ranks splits the context:

  * prefill: the bucket's tokens shard over sp, and every layer runs
    `ring_attend` or `ulysses_attend` (parallel/ring.py) on the rank's
    chunk, writing the chunk's K/V at the rank's slots [0, Tc); each rank
    holds seq/sp of the activations and of the cache;
  * decode: the one-token activation is the same on every rank, the cache
    stays sharded: each rank attends its position-tagged slot set and the
    partials merge with one pmax/psum log-sum-exp per layer
    (`cp_decode_attend`); each new token goes to the least-filled shard;
  * both phases put their attention into the decoder layer through the
    family's attn_hook seam (llama and gpt2): the same block and weights,
    another cache topology.

The cache carries, per rank, `pos_ids` [1, Sc] (the absolute position of
each local slot, -1 empty) and `fill` [1, 1] (the local slot count), with
Sc = local_slots(max_seq) = ceil(max_seq / sp) + 1.

Composes with dp (batch rows), tp (head shards) and pp: the layers shard
over the pipeline (parallel/pipeline.py's recv-driven stage chain), with
the sequence still sharded over sp inside each stage (every stage's
layers run the ring collectives on its chunk). The sampled window: the
last prompt position's activation lives on one sp rank of the last stage;
it reaches every rank by a broadcast over sp there (int8 under
pp_wire_quant: the JAX program's one masked psum over (sp, pp)) and an
exact one over pp.

Each method is one program on every rank. This path launches no kernel:
its attention is ring.py's plain PyTorch, as the JAX path is jnp. The
bytes the ring rotates (or the all-to-alls re-shard) are counted on the
"sp" path, the pp hand-offs on "microstep", the sampled window's
broadcasts on "broadcast", as each rank really sent them.

As in the JAX package the backend serves the solo engine and batched
requests, not the continuous fleets (no supports_slots).
"""

from __future__ import annotations

import torch

from ..engine import generate as G
from ..models import api as M
from ..ops.kv_quant import KVQuant, quantize_chunk
from ..ops.kv_quant import dequantize as kv_dequantize
from ..ops.sampling import sample_token
from ..ops.wire_quant import masked_psum
from .mesh import AXIS_PP, AXIS_SP
from .partition import local_config
from .pipeline import SPMDBackendBase
from .ring import cp_decode_attend, cp_gather_fills, cp_kv_write, cp_scale_write
from .ring import cp_select_slot
from .ring import ring_attend, ulysses_attend
from .vocab import unembed_sharded


class ContextParallelBackend(SPMDBackendBase):
    """dp x sp x tp (x pp) backend with a sequence-sharded KV cache."""

    name = "context-parallel"

    def __init__(self, cfg, params, mesh, sp_strategy: str = "ring",
                 wire_quant=None, seed: int = 0, store=None):
        self.check(cfg, mesh.cfg, sp_strategy)
        self.sp_strategy = sp_strategy
        super().__init__(cfg, params, mesh, wire_quant=wire_quant, seed=seed, store=store)
        # the sampled window's broadcast crosses the sp axis (sp >= 2: a
        # real transfer), so the wire knob applies whatever pp is
        self._wire_bcast = wire_quant is not None
        self.n_stages = self.pp if self.pp > 1 else self.sp
        # /workers: the pipeline stages when there are several, else the
        # context shards
        self._worker_axis = AXIS_PP if self.pp > 1 else AXIS_SP

    @staticmethod
    def check(cfg, mesh_cfg, sp_strategy: str = "ring"):
        """The JAX constructor's refusals, in its order and words (the
        runtime runs them before it spawns a rank)."""
        if sp_strategy not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_strategy must be 'ring' or 'ulysses', got {sp_strategy!r}"
            )
        if cfg.arch not in ("llama", "gpt2"):
            raise NotImplementedError(
                f"context parallelism needs the shared attn_hook seam "
                f"(llama/gpt2 families); got arch={cfg.arch!r}"
            )
        sp = mesh_cfg.sp
        if sp < 2:
            raise ValueError("ContextParallelBackend needs sp >= 2")
        # the all-to-all splits the tp-LOCAL head counts
        tp = mesh_cfg.tp
        if sp_strategy == "ulysses" and (
            (cfg.n_heads // tp) % sp or (cfg.n_kv_heads // tp) % sp
        ):
            raise ValueError(
                f"ulysses scatters heads over sp={sp}: needs the LOCAL "
                f"head counts (n_heads {cfg.n_heads} / tp {tp} = "
                f"{cfg.n_heads // tp}, n_kv_heads {cfg.n_kv_heads} / tp {tp} "
                f"= {cfg.n_kv_heads // tp}) divisible by sp "
                f"(use sp_strategy='ring')"
            )
        pp = mesh_cfg.pp
        if pp > 1 and cfg.n_layers % pp:
            raise NotImplementedError(
                f"sp x pp needs n_layers ({cfg.n_layers}) divisible by "
                f"pp ({pp}) for now (uneven stage splits pad layer slots, "
                f"which the context-sharded cache does not model yet)"
            )

    # the solo request surface (penalties, logit_bias, log-probabilities)
    # is local ops on the replicated logits; no slot programs (fleets),
    # constraints, beams or speculation: the capability flags stay unset

    @property
    def supports_ragged(self) -> bool:
        """Left-padded batches: valid_start rides the ring and merge masks
        on absolute positions; llama only (gpt2's learned positions are
        not shift-invariant)."""
        return self.cfg.arch == "llama"

    @property
    def supports_score(self) -> bool:
        """Echo scoring on an sp-only mesh; an sp x pp mesh refuses it."""
        return self.pp == 1

    def health(self) -> list[dict]:
        role = "pipeline-stage+context-ring" if self.pp > 1 else "context-shard"
        return [dict(line, role=role) for line in super().health()]

    # -- cache ------------------------------------------------------------------------
    def local_slots(self, max_seq: int) -> int:
        """Per-rank slot count: an even share of max_seq plus one slot of
        slack (decode appends differ by at most one across the ring)."""
        return -(-max_seq // self.sp) + 1

    def init_cache(self, batch: int, max_seq: int):
        if batch % self.dp:
            raise ValueError(f"batch={batch} not divisible by dp={self.dp}")
        ref = next(self._refs)
        return self._handle(self._run("context:init_cache", ref, batch,
                                      self.local_slots(max_seq)), ref)

    # -- programs ---------------------------------------------------------------------
    def prefill(self, tokens, prompt_len, cache, generator, sampling,
                valid_start=None, presence=None, bias=None):
        if tokens.shape[1] % self.sp:
            raise ValueError(
                f"prefill bucket {tokens.shape[1]} not divisible by sp={self.sp}; "
                f"pick prefill_buckets that are multiples of the ring size"
            )
        if tokens.shape[0] % self.dp:
            raise ValueError(f"batch={tokens.shape[0]} not divisible by dp={self.dp}")
        return self._run("context:prefill", tokens, int(prompt_len), cache, generator,
                         sampling, valid_start, presence, bias, self.sp_strategy,
                         self._wire_bcast)

    def decode(self, first_token, cache, start_pos, limit, generator, sampling,
               valid_start=None, presence=None, counts=None, bias=None,
               constraint=None, *, max_steps, with_logprobs=False):
        if constraint is not None:
            raise NotImplementedError(
                f"{self.name} does not serve grammar-constrained decode")
        return self._run("context:decode", first_token, cache, int(start_pos),
                         int(limit), generator, sampling, valid_start, presence,
                         counts, bias, max_steps=max_steps, with_logprobs=with_logprobs)

    def score_chunk(self, tokens, pos, cache, *, top_n=0):
        """Single-chunk echo scoring on the ring: the chunk shards over sp,
        each rank computes its teacher-forced logits, and the gathered
        [B, T, V] go through score_post on every rank."""
        if self.pp > 1:
            raise NotImplementedError(
                f"{self.name} echo-scoring does not run on sp x pp meshes "
                f"yet (the score program is whole-model per ring member); "
                f"score on an sp-only or pp server"
            )
        if int(pos) != 0:
            raise ValueError(
                f"{self.name} scores single-bucket prompts only (chunked "
                f"scoring needs a running cache offset the ring prefill "
                f"does not expose); raise prefill_buckets or score on a "
                f"pp/single-chip server"
            )
        if tokens.shape[1] % self.sp:
            raise ValueError(
                f"score bucket {tokens.shape[1]} not divisible by "
                f"sp={self.sp}"
            )
        return self._run("context:score_chunk", tokens, cache, top_n,
                         self.sp_strategy)


# -- the rank side: each function one program's body on a rank -------------------


def init_cache(rp, ref: int, batch: int, slots: int):
    """This rank's cache: its layers, its dp rows, its kv heads, Sc slots,
    and the slot bookkeeping."""
    lcfg = local_config(rp.cfg, rp.mesh_cfg.tp)
    kv = M.init_kv_cache(lcfg, batch // rp.dpg.size, max_seq=slots,
                         n_layers=rp._n_layers, device=rp.device)
    cache = {"k": kv["k"], "v": kv["v"],
             "pos_ids": torch.full((1, slots), -1, dtype=torch.int32, device=rp.device),
             "fill": torch.zeros((1, 1), dtype=torch.int32, device=rp.device)}
    return rp.keep(ref, cache)


def _layer_window(cfg, window_flag):
    """The layer's window for the ring masks: the static cfg.attn_window,
    or for a mixed pattern (a window_flag leaf) a 0-d width, an
    unreachable one on the full-attention layers."""
    if window_flag is None or cfg.attn_window is None:
        return cfg.attn_window
    return torch.where(window_flag > 0, cfg.attn_window, 1 << 30)


def _ring_hook(rp, strategy: str):
    """The prefill attn_hook: sequence-parallel attention over the chunk
    (ring or ulysses) and the chunk's K/V written at local slots [0, Tc).
    An int8 cache stores the quantized chunk, and its int8 rows and scales
    ride the collective; a raw cache under pp_wire_quant ships int8 too."""
    cfg, spg = rp.cfg, rp.stage.sp
    attend = ulysses_attend if strategy == "ulysses" else ring_attend
    wire = rp.stage.wire_quant is not None

    def hook(cfg_, q, k, v, ck, cv, pos, mask, gate=None, valid_start=None,
             window_flag=None):
        kw = dict(scale=cfg.query_scale, softcap=cfg.attn_softcap,
                  window=_layer_window(cfg, window_flag), valid_start=valid_start)
        Tc = q.shape[1]
        if isinstance(ck, KVQuant):
            qk, sk = quantize_chunk(k)
            qv, sv = quantize_chunk(v)
            attn = attend(q, qk, qv, spg, k_scale=sk, v_scale=sv, **kw)
            ck.q[:, :, :Tc] = qk.transpose(1, 2)
            ck.s[:, :, :Tc] = sk.transpose(1, 2)
            cv.q[:, :, :Tc] = qv.transpose(1, 2)
            cv.s[:, :, :Tc] = sv.transpose(1, 2)
            return attn, ck, cv
        attn = attend(q, k, v, spg, wire=wire, **kw)
        ck[:, :, :Tc] = k.to(ck.dtype).transpose(1, 2)
        cv[:, :, :Tc] = v.to(cv.dtype).transpose(1, 2)
        return attn, ck, cv

    return hook


def _chunk(rp, tokens):
    """This rank's dp rows and sp chunk of a [B, T] bucket: (local tokens,
    chunk_start)."""
    spg = rp.stage.sp
    toks = rp._rows(tokens, tokens.shape[0])
    Tc = toks.shape[1] // spg.size
    start = spg.rank * Tc
    return toks[:, start:start + Tc], start


@torch.no_grad()
def prefill(rp, tokens, prompt_len: int, cache, generator, sampling, valid_start,
            presence, bias, strategy: str, wire_bcast: bool):
    cfg, st = rp.cfg, rp.stage
    spg = st.sp
    B = tokens.shape[0]
    local, start = _chunk(rp, tokens)
    Tc = local.shape[1]
    vs, presence = rp._rows(valid_start, B), rp._rows(presence, B)
    x = st.embed(local, start)
    kv = {"k": cache["k"], "v": cache["v"]}
    x, _ = st.forward_layers(x, kv, start, valid_start=vs,
                             attn_hook=_ring_hook(rp, strategy))
    # slots [0, Tc) hold this chunk's positions; pads (>= prompt_len)
    # stay untagged. Ragged batches keep their left pads tagged: valid_start
    # masks them per row at attention time
    lpos = start + torch.arange(Tc, dtype=torch.int32, device=local.device)
    cache["pos_ids"].fill_(-1)
    cache["pos_ids"][0, :Tc] = torch.where(lpos < prompt_len, lpos, -1)
    cache["fill"].fill_(min(max(prompt_len - start, 0), Tc))
    # the last prompt position's activation: one sp rank of the last stage
    li = min(max(prompt_len - 1 - start, 0), Tc - 1)
    last = x[:, li:li + 1]
    if st.s == st.S - 1:
        last = masked_psum(last, spg, (prompt_len - 1) // Tc, quant=wire_bcast)
    if st.S > 1:
        last = st.pp.broadcast(last, st.S - 1, "broadcast")
    logits = unembed_sharded(cfg, st.shared, last, st.pp)[:, 0, :]
    first = sample_token(generator, logits, *sampling, presence=presence, bias=bias)
    return rp._cat(first), rp._cat(logits), cache


def _cp_hook(rp, pids, slot: int, owner: bool):
    """The decode attn_hook of one step: the owner writes the token's K/V
    (quantized for an int8 cache) at `slot`, and every rank attends its
    tagged slots, merged over the ring."""
    cfg, spg = rp.cfg, rp.stage.sp

    def hook(cfg_, q, k, v, ck, cv, pos, mask, gate=None, valid_start=None,
             window_flag=None):
        kw = dict(scale=cfg.query_scale, softcap=cfg.attn_softcap,
                  window=_layer_window(cfg, window_flag), valid_start=valid_start)
        if isinstance(ck, KVQuant):
            qk, sk = quantize_chunk(k)
            qv, sv = quantize_chunk(v)
            cp_kv_write(ck.q, cv.q, qk, qv, slot, owner)
            cp_scale_write(ck.s, sk, slot, owner)
            cp_scale_write(cv.s, sv, slot, owner)
            attn = cp_decode_attend(q, kv_dequantize(ck), kv_dequantize(cv), pids, pos,
                                    spg, **kw)
            return attn, ck, cv
        cp_kv_write(ck, cv, k, v, slot, owner)
        return cp_decode_attend(q, ck, cv, pids, pos, spg, **kw), ck, cv

    return hook


@torch.no_grad()
def decode(rp, first_token, cache, start_pos: int, limit: int, generator, sampling,
           valid_start, presence, counts, bias, *, max_steps: int,
           with_logprobs: bool = False):
    """engine/generate.decode's loop with the context-sharded cache: each
    step picks the least-filled shard for its token; when even that one is
    full the token is not stored, the rows finish and the loop stops (no
    silent eviction)."""
    cfg, st = rp.cfg, rp.stage
    spg = st.sp
    B = first_token.shape[0]
    r = rp._rows
    ft, vs, presence, counts = r(first_token, B), r(valid_start, B), r(presence, B), r(counts, B)
    rows, dev = ft.shape[0], ft.device
    limit = min(int(limit), int(max_steps))
    pad = cfg.pad_token_id
    out = torch.full((rows, max_steps), pad, dtype=torch.long, device=dev)
    lps = torch.zeros((rows, max_steps if with_logprobs else 1), dtype=torch.float32,
                      device=dev)
    n_gen = torch.zeros((rows,), dtype=torch.long, device=dev)
    finished = G.stop_mask(cfg, ft)
    token = torch.where(finished, pad, ft)
    pids = cache["pos_ids"][0]
    # every shard's fill, gathered once: each step's placement then
    # follows on every rank from the same list
    fills = cp_gather_fills(int(cache["fill"][0, 0]), spg, dev)
    kv = {"k": cache["k"], "v": cache["v"]}
    pos = int(start_pos)
    for step in range(limit):
        if bool(finished.all()):
            break
        slot, owner, overflow = cp_select_slot(fills, spg.rank, pids, pos)
        x = st.embed(token[:, None], pos)
        x, _ = st.forward_layers(x, kv, pos, valid_start=vs,
                                 attn_hook=_cp_hook(rp, pids, slot, owner))
        logits = st.unembed(x[:, -1:, :])[:, 0, :]
        nxt = sample_token(generator, logits, *sampling, presence=presence,
                           counts=counts, bias=bias)
        if presence is not None:
            presence = G.presence_update(presence, nxt)
        # overflow: the token was not stored, so this step's attention
        # missed it; every row finishes without emitting it
        finished = finished | G.stop_mask(cfg, nxt) | overflow
        if counts is not None:
            counts = G.count_update(counts, nxt, ~finished)
        out[:, step] = torch.where(finished, pad, nxt)
        if with_logprobs:
            logp = torch.log_softmax(logits.float(), dim=-1)
            lps[:, step] = torch.gather(logp, -1, nxt[:, None])[:, 0]
        n_gen += (~finished).long()
        token = torch.where(finished, pad, nxt)
        pos += 1
    cache["fill"].fill_(fills[spg.rank])
    res = (rp._cat(out), rp._cat(n_gen), cache)
    return res + (rp._cat(lps),) if with_logprobs else res


@torch.no_grad()
def score_chunk(rp, tokens, cache, top_n: int, strategy: str):
    """Teacher-forced scoring of one bucket at offset 0 (sp-only mesh):
    the local chunk's logits, gathered over sp with the tokens, then the
    shared score_post tail on every rank."""
    cfg, st = rp.cfg, rp.stage
    spg = st.sp
    local, start = _chunk(rp, tokens)
    x = st.embed(local, start)
    kv = {"k": cache["k"], "v": cache["v"]}
    x, _ = st.forward_layers(x, kv, start, attn_hook=_ring_hook(rp, strategy))
    logits = spg.all_gather(unembed_sharded(cfg, st.shared, x, st.pp), dim=1)
    toks = spg.all_gather(local, dim=1)
    out = G.score_post(logits, toks, top_n)
    return tuple(rp._cat(t) for t in out) + (cache,)
