"""Ring attention and context-parallel decode over the sequence (`sp`)
ring (the JAX package's parallel/ring.py, which is jnp code, not a Pallas
kernel: this port is plain PyTorch too).

  * `ring_attend`: causal flash attention where Q stays put and the K/V
    chunks rotate around the sp ring (one Group.shift per hop), with an
    online-softmax merge; each rank holds seq/sp of the context.
  * `ulysses_attend`: two all-to-alls instead of a ring: sequence shards
    to head shards, full causal attention over H/sp heads in key blocks,
    and back.
  * `cp_decode_attend`: decode attention over a context-sharded cache,
    each rank's slots an unordered set of (key, value, position); local
    partials merge with one pmax and two psums (log-sum-exp).
  * `cp_gather_fills` / `cp_select_slot` / `cp_kv_write` /
    `cp_scale_write` / `cp_cache_append`: the owner-gated slot bookkeeping
    of decode appends.

Every function takes the rank's sp Group (parallel/comm.Group) where the
JAX one takes the axis name. The arithmetic follows the JAX functions
step for step in fp32; only the order of the sums inside each einsum
differs.

Shapes (Tc = local query chunk, Sc = local cache slots, G = H // KV):
  q_local    [B, Tc, H, Dh]
  k/v_local  [B, Tc, KV, Dh]   (ring_attend: this rank's seq chunk)
  cache_k/v  [B, KV, Sc, Dh]   (cp_decode_attend: local slot set)
  pos_ids    [Sc] int32        (absolute position per slot, -1 = empty)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.wire_quant import quantize_rows

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
# the bytes the ring and the all-to-alls move are counted on this path
SP_PATH = "sp"


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,T,KV,G,Dh] x k [B,Tk,KV,Dh] -> [B,KV,G,T,Tk] fp32 (unscaled)."""
    return torch.einsum("btkgd,bskd->bkgts", q, k.float())


def _bc(mask: torch.Tensor) -> torch.Tensor:
    """A [T, Tk] (shared) or [B, T, Tk] (per-row) mask over scores
    [B, KV, G, T, Tk]."""
    return mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]


def _raggedize(mask, kv_pos, valid_start):
    """Fold a per-row first valid position into a shared [T, Tk] mask,
    giving [B, T, Tk]; kv_pos are absolute positions."""
    if valid_start is None:
        return mask
    return mask[None] & (kv_pos[None, None, :] >= valid_start.to(kv_pos.dtype)[:, None, None])


def _window(mask, kv_pos, q_pos, window):
    """A sliding window (an int, or a 0-d tensor: a mixed pattern's
    per-layer width)."""
    if window is None:
        return mask
    return mask & (kv_pos[None, :] > q_pos[:, None] - window)


def _merge_block(qg, m, l, acc, kc, vc, mask, softcap):
    """One online-softmax update with a key block (the body both prefill
    strategies share)."""
    scores = _gqa_scores(qg, kc)
    if softcap is not None:  # Gemma-2 logit capping, before the mask
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(_bc(mask), scores, _NEG)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    p = torch.where(_bc(mask), p, 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgts,bskd->bkgtd", p, vc.float())
    return m_new, l, acc


def _deq(c, s):
    return c if s is None else c.float() * s[..., None]


def ring_attend(q, k, v, group, k_scale=None, v_scale=None, *,
                scale: Optional[float] = None, softcap=None, window=None,
                valid_start=None, wire: bool = False) -> torch.Tensor:
    """Causal ring attention on sequence-sharded chunks: rank i holds the
    queries and keys of positions [i*Tc, (i+1)*Tc); the K/V chunks rotate
    sp - 1 hops and every query sees every key by absolute position.

    k_scale / v_scale [B, Tc, KV] (an int8 cache): k / v are int8 and
    the scales rotate with them, dequantized at use. wire
    (pp_wire_quant): raw K/V are quantized once at entry the same way, so
    every hop ships int8 (a no-op when k_scale is given). valid_start [B]:
    keys before row b's first valid position are masked for row b."""
    sp, my = group.size, group.rank
    B, Tc, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = Dh ** -0.5
    if wire and k_scale is None:
        k, k_scale = quantize_rows(k)
        v, v_scale = quantize_rows(v)
    quant = k_scale is not None
    dev = q.device
    qg = (q.float() * scale).reshape(B, Tc, KV, G, Dh)
    ar = torch.arange(Tc, dtype=torch.int32, device=dev)
    q_pos = my * Tc + ar
    m = torch.full((B, KV, G, Tc, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Tc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Tc, Dh), dtype=torch.float32, device=dev)
    chunk = [k, v] + ([k_scale, v_scale] if quant else [])
    for step in range(sp):
        if step:
            # rotate first: the chunk held locally is the one sp - step
            # ranks back, so only the sp - 1 needed hops are sent
            chunk = [group.shift(c, c, SP_PATH) for c in chunk]
        src = (my - step) % sp
        kv_pos = src * Tc + ar
        mask = kv_pos[None, :] <= q_pos[:, None]
        mask = _raggedize(_window(mask, kv_pos, q_pos, window), kv_pos, valid_start)
        kc, vc = chunk[0], chunk[1]
        ks, vs = (chunk[2], chunk[3]) if quant else (None, None)
        m, l, acc = _merge_block(qg, m, l, acc, _deq(kc, ks), _deq(vc, vs), mask,
                                 softcap)
    l = torch.where(l == 0.0, 1.0, l)  # only padding rows see no key
    out = acc / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tc, H, Dh).to(q.dtype)


def ulysses_attend(q, k, v, group, k_scale=None, v_scale=None, *,
                   scale: Optional[float] = None, softcap=None, window=None,
                   valid_start=None, wire: bool = False) -> torch.Tensor:
    """Ulysses sequence parallelism: an all-to-all re-shards the chunks
    from sequence to heads (every rank then holds the whole sequence for
    H/sp heads), causal attention runs locally in key blocks of Tc with
    an online softmax, and a second all-to-all restores the sequence
    shards. Needs the local head counts divisible by sp. int8 chunks and
    `wire` as in ring_attend; the queries stay in their dtype."""
    sp = group.size
    B, Tc, H, Dh = q.shape
    if wire and k_scale is None:
        k, k_scale = quantize_rows(k)
        v, v_scale = quantize_rows(v)
    quant = k_scale is not None
    # the K/V chunks (and their scales) are counted, as the JAX link
    # table counts the ring's; the queries stay in their dtype
    qh = group.all_to_all(q, 2, 1)
    kh = group.all_to_all(k, 2, 1, SP_PATH)
    vh = group.all_to_all(v, 2, 1, SP_PATH)
    if quant:
        ksh = group.all_to_all(k_scale, 2, 1, SP_PATH)
        vsh = group.all_to_all(v_scale, 2, 1, SP_PATH)
    T = qh.shape[1]
    Hl, KVl = qh.shape[2], kh.shape[2]
    G = Hl // KVl
    if scale is None:
        scale = Dh ** -0.5
    dev = q.device
    qg = (qh.float() * scale).reshape(B, T, KVl, G, Dh)
    q_pos = torch.arange(T, dtype=torch.int32, device=dev)
    m = torch.full((B, KVl, G, T, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVl, G, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVl, G, T, Dh), dtype=torch.float32, device=dev)
    for s in range(sp):
        blk = slice(s * Tc, (s + 1) * Tc)
        kc, vc = kh[:, blk], vh[:, blk]
        if quant:
            kc, vc = _deq(kc, ksh[:, blk]), _deq(vc, vsh[:, blk])
        kv_pos = s * Tc + torch.arange(Tc, dtype=torch.int32, device=dev)
        mask = kv_pos[None, :] <= q_pos[:, None]
        mask = _raggedize(_window(mask, kv_pos, q_pos, window), kv_pos, valid_start)
        m, l, acc = _merge_block(qg, m, l, acc, kc, vc, mask, softcap)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, T, Hl, Dh).to(q.dtype)
    # heads back to sequence shards: the output stays in its dtype
    return group.all_to_all(out, 1, 2)


def cp_decode_attend(q, cache_k, cache_v, pos_ids, pos, group, *,
                     scale: Optional[float] = None, softcap=None, window=None,
                     valid_start=None) -> torch.Tensor:
    """Decode attention over a context-sharded cache: a slot takes part
    iff 0 <= pos_ids[slot] <= the query's absolute position; the local
    partials (m, l, acc) merge over the group with one pmax and two psums.

    q [B, T, H, Dh] (the same on every rank), cache_k / cache_v
    [B, KV, Sc, Dh], pos_ids [Sc], pos: the first query's position ->
    [B, T, H, Dh] (the same on every rank)."""
    B, T, H, Dh = q.shape
    KV = cache_k.shape[1]
    G = H // KV
    if scale is None:
        scale = Dh ** -0.5
    qg = (q.float() * scale).reshape(B, T, KV, G, Dh)
    q_abs = int(pos) + torch.arange(T, dtype=torch.int32, device=q.device)
    pos_ids = pos_ids.to(torch.int32)
    mask = (pos_ids >= 0)[None, :] & (pos_ids[None, :] <= q_abs[:, None])
    mask = _raggedize(_window(mask, pos_ids, q_abs, window), pos_ids, valid_start)
    scores = torch.einsum("btkgd,bksd->bkgts", qg, cache_k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(_bc(mask), scores, _NEG)
    m_loc = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m_loc)
    p = torch.where(_bc(mask), p, 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    acc_loc = torch.einsum("bkgts,bksd->bkgtd", p, cache_v.float())
    # the log-sum-exp merge over the ring: one pmax, two psums
    m_glb = group.pmax(m_loc)
    w = torch.exp(m_loc - m_glb)
    l_glb = group.psum(l_loc * w)
    acc_glb = group.psum(acc_loc * w)
    l_glb = torch.where(l_glb == 0.0, 1.0, l_glb)
    out = acc_glb / l_glb
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).to(q.dtype)


def cp_gather_fills(fill: int, group, device) -> list:
    """Every ring member's slot count, the same list on every rank (one
    all_gather on `device`, where the group's collectives run)."""
    return group.all_gather(torch.tensor([int(fill)], dtype=torch.int64, device=device),
                            dim=0).tolist()


def cp_select_slot(fills: list, rank: int, pos_ids, pos: int):
    """The ring member that stores the next decoded token: the least
    filled (ties to the lowest index), so a cache of ceil(max_seq/sp) + 1
    slots per rank never overflows behind a prefill-heavy shard. The owner
    tags its slot of pos_ids [Sc] with `pos`.

    fills: every rank's count (cp_gather_fills), advanced in place, so
    every rank keeps the same list step after step where the JAX function
    gathers it each step -> (slot, owner: True on the selected rank,
    overflow: True on every rank when even the least filled shard is full;
    nothing was then stored and the caller must stop. No silent eviction)."""
    Sc = pos_ids.shape[-1]
    slot = min(fills[rank], Sc - 1)
    owner_idx = min(range(len(fills)), key=lambda i: (fills[i], i))
    overflow = fills[owner_idx] >= Sc
    owner = owner_idx == rank and not overflow
    if not overflow:
        fills[owner_idx] += 1
    if owner:
        pos_ids[slot] = int(pos)
    return slot, owner, overflow


def cp_kv_write(cache_k, cache_v, k_new, v_new, slot: int, owner: bool):
    """The owner's write of one token's K/V [B, 1, KV, Dh] at local slot
    `slot` of cache_k / cache_v [B, KV, Sc, Dh], in place (the other
    ranks keep their slot as it is)."""
    if owner:
        cache_k[:, :, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, :, slot] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def cp_scale_write(cache_s, s_new, slot: int, owner: bool):
    """The owner's write of one token's int8 scales s_new [B, 1, KV] at
    local slot `slot` of cache_s [B, KV, Sc], in place."""
    if owner:
        cache_s[:, :, slot] = s_new[:, 0]
    return cache_s


def cp_cache_append(cache_k, cache_v, pos_ids, k_new, v_new, pos: int, fill: int,
                    group):
    """Append one decoded token's K/V to the context-sharded cache (the
    JAX one-shot form: gather the fills, select and tag the slot, write).
    Returns (cache_k, cache_v, pos_ids, fill, overflow)."""
    fills = cp_gather_fills(fill, group, cache_k.device)
    slot, owner, overflow = cp_select_slot(fills, group.rank, pos_ids, pos)
    cp_kv_write(cache_k, cache_v, k_new, v_new, slot, owner)
    return cache_k, cache_v, pos_ids, fills[group.rank], overflow
