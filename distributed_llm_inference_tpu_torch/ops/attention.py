"""Causal attention with GQA over a static-shape KV cache (the JAX
package's ops/attention.py in PyTorch).

This is the T=1 decode path of the solo engine and the reference that
every attention kernel's plain twin is held to.

Shapes (B=batch, T=chunk len, S=max_seq, H=q heads, KV=kv heads, Dh=head_dim):
  q           [B, T, H, Dh]
  k_new/v_new [B, T, KV, Dh]
  cache_k/v   [B, KV, S, Dh]

Unlike the JAX package, whose arrays are immutable, the cache is written
IN PLACE: a prefill or decode step updates the one resident buffer rather
than producing a copy of a cache that can be gigabytes.
"""

from __future__ import annotations

import torch

NEG = torch.finfo(torch.float32).min


def update_kv_cache(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the new K/V chunk at offset `pos` in place; returns the caches.

    Caller contract: pos + T <= max_seq (the engine enforces it). An
    out-of-range write raises here, where the JAX version would clamp."""
    T = k_new.shape[1]
    if pos < 0 or pos + T > cache_k.shape[2]:
        raise ValueError(
            f"cache write [{pos}, {pos + T}) outside capacity "
            f"{cache_k.shape[2]}"
        )
    # [B, T, KV, Dh] chunk -> [B, KV, T, Dh] cache layout
    cache_k[:, :, pos:pos + T] = k_new.transpose(1, 2)
    cache_v[:, :, pos:pos + T] = v_new.transpose(1, 2)
    return cache_k, cache_v


def causal_mask(pos: int, chunk_len: int, max_seq: int, window=None,
                device=None) -> torch.Tensor:
    """[T, S] bool: query at absolute position pos+t attends cache slots
    0..pos+t; with `window` only q_pos - window < kv_pos <= q_pos."""
    q_pos = pos + torch.arange(chunk_len, dtype=torch.int32, device=device)
    kv_pos = torch.arange(max_seq, dtype=torch.int32, device=device)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def slot_causal_mask(pos: torch.Tensor, chunk_len: int, max_seq: int,
                     window=None) -> torch.Tensor:
    """[B, T, S] mask for PER-ROW query offsets (continuous batching):
    row b's query at pos[b]+t attends cache slots 0..pos[b]+t (with
    `window`, only those > q_pos - window). pos: int32 [B] on the
    device; nothing is read back to the host."""
    device = pos.device
    q_pos = pos[:, None] + torch.arange(chunk_len, dtype=torch.int32,
                                        device=device)[None, :]  # [B, T]
    kv_pos = torch.arange(max_seq, dtype=torch.int32, device=device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    return mask


def update_kv_cache_slots(cache_k, cache_v, k_new, v_new, pos: torch.Tensor):
    """Write each row's chunk at its own offset pos [B] (int32, on the
    device), in place. As the JAX package's dynamic_update_slice does,
    an offset that would run past the cache clamps to max_seq - T; the
    continuous engine keeps every slot inside its budget."""
    B, T = k_new.shape[:2]
    S = cache_k.shape[2]
    start = pos.long().clamp(0, S - T)
    cols = start[:, None] + torch.arange(T, device=pos.device)[None, :]  # [B, T]
    rows = torch.arange(B, device=pos.device)[:, None]
    # [B, KV, S, Dh] viewed as [B, S, KV, Dh]: one (row, position) index
    # pair per written token, the chunk keeps its [B, T, KV, Dh] layout
    cache_k.transpose(1, 2)[rows, cols] = k_new
    cache_v.transpose(1, 2)[rows, cols] = v_new
    return cache_k, cache_v


def ragged_causal_mask(
    pos: int, chunk_len: int, max_seq: int, valid_start: torch.Tensor,
    window=None,
) -> torch.Tensor:
    """[B, T, S] mask for LEFT-padded batches: causal AND slot >= the row's
    first real slot (valid_start [B])."""
    device = valid_start.device
    causal = causal_mask(pos, chunk_len, max_seq, window, device=device)
    kv_pos = torch.arange(max_seq, dtype=torch.int32, device=device)
    valid = kv_pos[None, None, :] >= valid_start[:, None, None]  # [B, 1, S]
    return causal[None, :, :] & valid


def attend(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    mask: torch.Tensor,
    scale=None,
    softcap=None,
) -> torch.Tensor:
    """Grouped-query attention over the (already updated) cache.

    mask: [T, S] (shared) or [B, T, S] (per-row). Softmax in fp32, output
    cast back to q.dtype; returns [B, T, H, Dh]. softcap applies
    cap*tanh(scores/cap) BEFORE masking (HF Gemma2 order)."""
    B, T, H, Dh = q.shape
    KV = cache_k.shape[1]
    group = H // KV
    qg = q.reshape(B, T, KV, group, Dh)
    if scale is None:
        scale = Dh ** -0.5
    scores = torch.einsum(
        "btkgd,bksd->bkgts", qg.float(), cache_k.float()
    ) * scale  # [B, KV, group, T, S]
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    bmask = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    scores = torch.where(bmask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", probs, cache_v.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)
