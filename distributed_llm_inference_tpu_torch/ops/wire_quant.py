"""int8 wire format for inter-stage activation hand-offs (the JAX
package's ops/wire_quant.py in PyTorch).

The ONE implementation of the symmetric per-token-row int8 quantize /
dequantize that both wire consumers share:

  * the KV cache (ops/kv_quant.py) — `quantize_chunk` delegates to
    `quantize_rows` here, so cache quantization and wire quantization can
    never drift numerically;
  * the MPMD stage transport (serving/stage_runtime.py,
    `--wire-quant int8`) — hidden-state bodies ship int8 rows plus one
    fp32 scale per row, dequantized on landing.

The functions take tensors on any device (the KV cache quantizes on the
card; the stage plane quantizes the window it fetched, on the host). q
and s are bit-equal to the JAX package's for the same input (fp32
division, round half to even, the same 1e-12 floor).

The mesh's hand-offs (parallel/pipeline.py) go through the collectives
below, over a parallel/comm.Group: a stage sends its activation to the
next (`wire_send` / `wire_recv`, the recv-driven form of the JAX ring's
`wire_ppermute`), and the last stage's
window reaches every rank (`masked_psum`, a broadcast from its owner where
the JAX package psums a one-hot-masked operand). With quant=False each is
the plain collective, bit for bit; with quant=True it ships int8 rows plus
fp32 scales and dequantizes on landing, one `wire_roundtrip` per crossing.
`proxy_stage_generate` / `proxy_stage_match` replay those numerics on one
device, as the JAX proxy does.
"""

from __future__ import annotations

import math

import torch


class WireQuant:
    """int8 wire leaf: q [..., D] int8 data + s [...] fp32 per-row scales."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    def __repr__(self):
        return (f"WireQuant(q={tuple(self.q.shape)}@{self.q.dtype}, "
                f"s={tuple(self.s.shape)})")


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the LAST axis, one fp32 scale per leading row:
    x [..., D] -> (q [..., D] int8, s [...] fp32).

    Per-row granularity keeps the quantization error independent of
    content elsewhere in the batch/sequence — a single outlier token
    poisons only its own row, never the whole tensor (the same argument
    as the KV cache's per-(token, head) scales, which are this exact
    function applied to [B, T, KV, Dh] chunks)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-12)  # all-zero rows stay zero
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def wire_encode(x: torch.Tensor) -> WireQuant:
    """Quantize an activation for the wire."""
    return WireQuant(*quantize_rows(x))


def wire_decode(w: WireQuant, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize on landing, restoring the sender's dtype."""
    return (w.q.float() * w.s[..., None]).to(dtype)


def wire_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The numerics of ONE wire crossing — what a receiving stage sees of
    `x`."""
    return wire_decode(wire_encode(x), x.dtype)


def wire_send(x: torch.Tensor, group, dst: int, *, quant: bool):
    """A stage's hand-off to group rank `dst`: x as it is, or its int8
    rows then their fp32 scales (counted on the "microstep" path)."""
    if not quant:
        group.send(x, dst, "microstep")
        return
    w = wire_encode(x)
    group.send(w.q, dst, "microstep")
    group.send(w.s, dst, "microstep")


def wire_recv(like: torch.Tensor, group, src: int, *, quant: bool) -> torch.Tensor:
    """The activation group rank `src` sent with wire_send, shaped and
    typed like `like` (dequantized to like's dtype when quant)."""
    if not quant:
        return group.recv(like, src)
    q = group.recv(torch.empty(like.shape, dtype=torch.int8, device=like.device), src)
    s = group.recv(torch.empty(like.shape[:-1], dtype=torch.float32,
                               device=like.device), src)
    return wire_decode(WireQuant(q, s), like.dtype)


def wire_shift(x, group, like, *, quant: bool, path: str = "1f1b"):
    """One step of the ring over `group` (the JAX `wire_ppermute` of a
    ring): x (or None: nothing to send) to the next rank, and what the
    previous rank sent, shaped and typed like `like` (None: nothing to
    receive). quant ships int8 rows then fp32 scales and dequantizes on
    landing."""
    if not quant:
        return group.shift(x, like, path)
    w = None if x is None else wire_encode(x)
    q = group.shift(None if w is None else w.q, None if like is None else torch.empty(
        like.shape, dtype=torch.int8, device=like.device), path)
    s = group.shift(None if w is None else w.s, None if like is None else torch.empty(
        like.shape[:-1], dtype=torch.float32, device=like.device), path)
    return None if like is None else wire_decode(WireQuant(q, s), like.dtype)


def masked_psum(x: torch.Tensor, group, owner: int, *, quant: bool) -> torch.Tensor:
    """The single-owner broadcast: group rank `owner`'s x on every rank
    (the other ranks' x gives the shape; counted on the "broadcast"
    path). quant ships the owner's int8 rows and fp32 scales."""
    if not quant:
        return group.broadcast(x, owner, "broadcast")
    w = wire_encode(x)
    q = group.broadcast(w.q, owner, "broadcast")
    s = group.broadcast(w.s, owner, "broadcast")
    return wire_decode(WireQuant(q, s), x.dtype)


def _stage_ranges(cfg, n_stages: int) -> list:
    from ..config import stage_layer_range

    return [stage_layer_range(cfg.n_layers, n_stages, s) for s in range(n_stages)]


def _stage_forward(cfg, params, tokens, pos, caches, ranges, quant: bool):
    """Embed, each stage's layer slice (one wire round trip after each:
    the stage's hand-off, the last stage's the ring's hop home), one more
    for the broadcast, then the head."""
    from ..models import api as M

    x = M.embed(cfg, params, tokens, pos)
    for (lo, hi), cache in zip(ranges, caches):
        layers = {k: v[lo:hi] for k, v in params["layers"].items()}
        x, _ = M.forward_layers(cfg, layers, x, cache, pos)
        if quant:
            x = wire_roundtrip(x)
    if quant:
        x = wire_roundtrip(x)
    return M.unembed(cfg, params, x)


@torch.no_grad()
def proxy_stage_generate(cfg, params, prompt_ids, max_new: int, n_stages: int,
                         *, quant: bool = True, device=None) -> list:
    """One-device proxy of the pipeline mesh's WIRE NUMERICS: greedy
    prefill and decode where the activation passes one wire_roundtrip
    after each of `n_stages` stage slices plus one for the broadcast. The
    round trip is row-local, so the whole window's round trip sliced equals
    the slice's. quant=False runs the same stage-sliced forward with no
    round trip: the single device's greedy output."""
    from ..models import api as M

    device = device or params["embed"].device
    ranges = _stage_ranges(cfg, n_stages)
    T = len(prompt_ids)
    caches = [M.init_kv_cache(cfg, 1, max_seq=T + max_new, n_layers=hi - lo,
                              device=device) for lo, hi in ranges]
    toks = torch.tensor([prompt_ids], dtype=torch.long, device=device)
    logits = _stage_forward(cfg, params, toks, 0, caches, ranges, quant)
    tok = int(torch.argmax(logits[0, T - 1]))
    out = [tok]
    for i in range(max_new - 1):
        logits = _stage_forward(cfg, params, torch.tensor([[tok]], device=device),
                                T + i, caches, ranges, quant)
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
    return out


@torch.no_grad()
def proxy_stage_match(cfg, params, prompt_ids, max_new: int, n_stages: int,
                      *, device=None) -> float:
    """Teacher-forced greedy match rate of the wire-quantized forward
    against the exact one over the exact continuation (per decision: one
    early flip does not cascade)."""
    from ..models import api as M

    device = device or params["embed"].device
    exact = proxy_stage_generate(cfg, params, prompt_ids, max_new, n_stages,
                                 quant=False, device=device)
    T = len(prompt_ids)
    full = list(prompt_ids) + exact
    ranges = _stage_ranges(cfg, n_stages)
    caches = [M.init_kv_cache(cfg, 1, max_seq=len(full), n_layers=hi - lo,
                              device=device) for lo, hi in ranges]
    logits = _stage_forward(cfg, params, torch.tensor([full], device=device), 0,
                            caches, ranges, True)
    pred = torch.argmax(logits[0], dim=-1)
    return sum(int(pred[T - 1 + i]) == exact[i] for i in range(max_new)) / max_new


def wire_bytes(shape, itemsize: int, hops: int, *, quant: bool) -> int:
    """Host-side static wire accounting: bytes one activation of `shape`
    costs crossing `hops` hand-offs. Quantized, a [..., D] tensor ships D
    int8 plus one fp32 scale per leading row. The JAX package evaluates
    the same formula in analysis/comms.wire_link_bytes."""
    n = math.prod(shape)
    rows = n // shape[-1]
    per_hop = n + 4 * rows if quant else n * itemsize
    return per_hop * hops
