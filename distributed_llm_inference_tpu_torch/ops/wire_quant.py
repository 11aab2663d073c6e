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

The in-mesh hand-offs of the JAX module (`wire_ppermute`, `masked_psum`)
and its one-device proxy of the mesh's wire numerics
(`proxy_stage_generate`, `proxy_stage_match`) belong to the meshes, which
are not ported (the Multi-GPU SPMD item of ROADMAP.md).
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


def wire_bytes(shape, itemsize: int, hops: int, *, quant: bool) -> int:
    """Host-side static wire accounting: bytes one activation of `shape`
    costs crossing `hops` hand-offs. Quantized, a [..., D] tensor ships D
    int8 plus one fp32 scale per leading row. The JAX package evaluates
    the same formula in analysis/comms.wire_link_bytes."""
    n = math.prod(shape)
    rows = n // shape[-1]
    per_hop = n + 4 * rows if quant else n * itemsize
    return per_hop * hops
