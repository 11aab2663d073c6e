"""int8 KV cache: per-(token, head) symmetric scales (the JAX package's
ops/kv_quant.py in PyTorch).

K/V are stored as int8 with one fp32 scale per (token, kv-head), which
halves the cache's device-memory bytes (int8 data + 1/head_dim scale
overhead). A cache or pool leaf is a `KVQuant` of two tensors, q int8
[..., S, Dh] and s fp32 [..., S]: the batch / block and layer axes sit at
the same positions in both, so `leaf[i]` (one layer's slice) and
`leaf.shape` work where the engine handles a raw tensor.

Writes quantize the chunk and store data and scale IN PLACE, as the raw
cache's ops/attention.py writes do; reads dequantize to fp32
(`dequantize`) or hand both leaves to an attention kernel, which
dequantizes in its tile prologue (ops/flash_attention.py,
ops/paged_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from .wire_quant import quantize_rows


class KVQuant:
    """int8 cache leaf: q [..., S, Dh] int8, s [..., S] fp32 scales."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def dtype(self):
        return self.q.dtype

    def __getitem__(self, idx):
        """Slice both leaves on their shared leading axes."""
        return KVQuant(self.q[idx], self.s[idx])

    def __repr__(self):
        return f"KVQuant(q={tuple(self.q.shape)}@{self.q.dtype}, s={tuple(self.s.shape)})"


def init_quant_cache(n_layers: int, batch: int, n_kv: int, max_seq: int,
                     head_dim: int, device=None) -> dict:
    """Zeroed int8 cache, same dict shape as the raw one ({"k", "v"})."""
    q = (n_layers, batch, n_kv, max_seq, head_dim)

    def leaf():
        return KVQuant(torch.zeros(q, dtype=torch.int8, device=device),
                       torch.zeros(q[:-1], dtype=torch.float32, device=device))

    return {"k": leaf(), "v": leaf()}


def quantize_chunk(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head_dim axis: x [B, T, KV, Dh] ->
    (q [B, T, KV, Dh] int8, s [B, T, KV] fp32). The symmetric per-row
    primitive is shared with the stage wire format (ops/wire_quant.py), so
    cache and wire quantization cannot drift numerically."""
    return quantize_rows(x)


def dequantize(leaf: KVQuant) -> torch.Tensor:
    """[..., S, Dh] fp32 view of an int8 leaf."""
    return leaf.q.float() * leaf.s[..., None]


def update_cache(leaf: KVQuant, x_new: torch.Tensor, pos: int,
                 gate: Optional[torch.Tensor] = None) -> KVQuant:
    """Quantize-and-write a chunk x_new [B, T, KV, Dh] at scalar offset
    `pos`, in place (prefill / shared decode). With a bool `gate` the
    written slice keeps its old content where the gate is False (the JAX
    package's gated read-modify-write). Caller contract as in
    ops/attention.update_kv_cache: pos + T <= max_seq, else it raises."""
    T = x_new.shape[1]
    S = leaf.q.shape[2]
    pos = int(pos)
    if pos < 0 or pos + T > S:
        raise ValueError(f"cache write [{pos}, {pos + T}) outside capacity {S}")
    qn, sn = quantize_chunk(x_new)
    qn = qn.transpose(1, 2)  # [B, KV, T, Dh]
    sn = sn.transpose(1, 2)  # [B, KV, T]
    if gate is not None:
        qn = torch.where(gate, qn, leaf.q[:, :, pos:pos + T])
        sn = torch.where(gate, sn, leaf.s[:, :, pos:pos + T])
    leaf.q[:, :, pos:pos + T] = qn
    leaf.s[:, :, pos:pos + T] = sn
    return leaf


def update_cache_slots(leaf: KVQuant, x_new: torch.Tensor, pos: torch.Tensor,
                       gate: Optional[torch.Tensor] = None) -> KVQuant:
    """Per-row quantize-and-write of x_new [B, T, KV, Dh] at per-row
    offsets pos [B] (int32, on the device), in place. As the JAX
    package's dynamic_update_slice does, an offset that would run past
    the cache clamps to max_seq - T."""
    B, T = x_new.shape[:2]
    S = leaf.q.shape[2]
    qn, sn = quantize_chunk(x_new)  # [B, T, KV, Dh], [B, T, KV]
    start = pos.long().clamp(0, S - T)
    cols = start[:, None] + torch.arange(T, device=pos.device)[None, :]  # [B, T]
    rows = torch.arange(B, device=pos.device)[:, None]
    # [B, KV, S, ...] viewed as [B, S, KV, ...]: one (row, position) pair
    # per written token
    q_view, s_view = leaf.q.transpose(1, 2), leaf.s.transpose(1, 2)
    if gate is not None:
        qn = torch.where(gate, qn, q_view[rows, cols])
        sn = torch.where(gate, sn, s_view[rows, cols])
    q_view[rows, cols] = qn
    s_view[rows, cols] = sn
    return leaf
