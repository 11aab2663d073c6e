"""Attention over the block-paged KV pool and the dense slot cache: the
three CUDA kernels' wrappers and their plain PyTorch twins.

`ragged_paged_attend`, `paged_flash_attend` and `flash_attend_slots` are
the ports of the JAX package's ops/paged_attention.py functions of the
same names, each a hand-written Hopper kernel (each source's note says
what bounds it and what its design does about it). All three are bound
by bytes: each live K/V row is read once per KV head against ~16 FLOPs
per byte at tinyllama's group of 8 (a full prompt tile ~8x that), far
below what the tensor cores need to be the limit; what keeps them from
that bound at the fleet's sizes is how few blocks one per (row or tile,
KV head) would put on the card, each walking its keys in series.

`ragged_paged_attend` (csrc/paged_attention.cu) runs the tensor-core
flash walk that `flash_attend` runs (csrc/flash_walk.cuh) through the
block table: a block owns a query tile's folded rows for one KV head and
is one rank of a thread-block cluster that splits the tile's live key
tiles; `ragged_plan` fixes the cluster on the host from the shapes alone
so that G * KV * cluster covers the SMs, and the ranks of a short tile
agree on the device, from the same meta[g], to walk with fewer ranks.
The ranks merge in a fixed order in one launch (repeats are bit-equal).
The two T=1 decode kernels share one split-KV walk
(csrc/decode_walk.cuh): each row's live key range is shared by
`n_split` blocks, fixed on the host from the shapes alone
(`_paged_splits`, `_slots_splits`), whose fp32 partials go to a
workspace this module allocates and are merged in a fixed order by a
second kernel. `paged_flash_attend` walks the pool through the block
table (csrc/paged_attention.cu); `flash_attend_slots` walks the dense
cache (csrc/slots_attention.cu). The pool keeps the JAX layout, one
layer's slice [N, KV, bs, Dh]: key position p of a table row lives in
physical block table[row, p // bs] at slot p % bs; an id outside [0, N)
reads block 0, the trash block.

  * ragged_paged_attend(q [W, H, Dh], pool_k, pool_v, table [R, MB] int32,
    meta [G, 4] int32, window_dyn=None, *, window, scale, softcap): the
    mixed prefill + decode launch. The flat query axis is cut into G tiles
    of tq = W // G; tile g is meta[g] = (row, q_start, q_len, kind) —
    engine/paged.build_ragged_meta's plan. Query t < q_len of the tile sits
    at q_start + t of fleet row `row` (clamped to [0, R)); a tile with
    q_len == 0 (launch padding) and rows with t >= q_len output zeros.
    `kind` is accounting only: the math is uniform.
  * paged_flash_attend(q [B, 1, H, Dh], pool_k, pool_v, table [B, MB],
    pos [B] int32, window_dyn=None, *, window, scale, softcap): T=1
    decode, one query per row at pos[b]; a row at pos >= MB * bs attends
    all MB * bs keys.
  * flash_attend_slots(q [B, 1, H, Dh], cache_k, cache_v [B, KV, S, Dh],
    pos [B] int32, *, block_k=0, window=None): T=1 decode over the dense
    slot-fleet cache, row b at pos[b] over its own cache row; keys at
    positions < S only (a finished slot frozen at pos >= S attends all
    S). scale is Dh**-0.5 and there is no softcap, as in the JAX kernel;
    raw caches only (the JAX kernel has no int8 variant). block_k is the
    JAX kernel's DMA tile and does not change the result. The serving
    hook never selects it (the dense fleet decodes through the einsum, as
    the JAX package's models/llama.default_attn_hook does).

All three attend keys at positions <= the query's own, and with a window
(static `window`, or for the paged two the one-element int32 device
tensor `window_dyn`, <= 0 = full causal) only those > q_pos - window;
scale defaults to Dh**-0.5 and softcap caps the scores before the mask.
Returns q's shape and dtype.

The pools may be int8 (ops/kv_quant.KVQuant leaves: q [N, KV, bs, Dh]
int8 and fp32 scales s [N, KV, bs]); the kernels dequantize on the SM and
count those launches in `<wrapper>.launches_int8`, raw-dtype launches in
`<wrapper>.launches`.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs its plain twin. The kernels read meta, table and pos on the card,
so a launch never syncs the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..kernels import bind, load_library
from .flash_attention import (
    FLASH_MAX_CLUSTER,
    FLASH_ROWS,
    MAX_HEAD_DIM,
    NEG,
    _sm_count,
    check_cache_leaves,
    count_launch,
    fp32_leaf,
    kv_operands,
    resolve_kernel,
    walk_tiles,
)
from .kv_quant import KVQuant

RAGGED_PREFILL = 0  # meta `kind`: a prompt-chunk row (length >= 1)
RAGGED_DECODE = 1  # meta `kind`: a single-token decode row

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points' argument types (csrc/paged_attention.cu, and
# csrc/slots_attention.cu for dli_flash_attend_slots)
SIGNATURES = {
    "dli_ragged_paged_attend": [
        _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
        _i32, _i32, _i32, _vp, _vp, _i32, _vp, _f32, _f32, _i32, _i32, _i32,
        _i32, _vp,
    ],
    "dli_paged_flash_attend": [
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32,
        _i32, _i32, _vp, _vp, _i32, _vp, _f32, _f32, _i32, _vp,
    ],
    "dli_flash_attend_slots": [
        _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _i32,
        _f32, _i32, _vp,
    ],
}
_SLOTS = "dli_flash_attend_slots"
SLOTS_TILE = 64  # keys per tile of the decode walk (32 for fp32 at Dh 256)


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("paged_attention"),
                {n: s for n, s in SIGNATURES.items() if n != _SLOTS})


@functools.cache
def _slots_library() -> ctypes.CDLL:
    return bind(load_library("slots_attention"), {_SLOTS: SIGNATURES[_SLOTS]})


def _slots_splits(B, KV, S, sm_count):
    """How many blocks share each (row, KV head)'s live key range in the
    slots kernel: enough that B * KV * n_split fills every SM twice, and
    never more than the cache's 64-key tiles. Fixed on the host from the
    shapes alone, so a launch reads nothing back and can be captured."""
    want = -(-2 * sm_count // (B * KV))
    return max(1, min(want, -(-S // SLOTS_TILE)))


def _paged_splits(B, KV, MB, bs, sm_count):
    """How many blocks share each (row, KV head)'s live key range in the
    paged decode kernel: the slots kernel's rule over the MB * bs keys a
    table row can hold. A function of the shapes alone: a launch reads
    nothing back and is captured in the fleet's decode-chunk graph."""
    return _slots_splits(B, KV, MB * bs, sm_count)


# the live key tiles each rank of a ragged tile keeps at least: a tile
# with fewer walks with fewer ranks (chip_smoke.py --only r sweeps it)
RAGGED_MIN_SHARE = 2


class RaggedPlan(NamedTuple):
    """The ragged kernel's launch: `rows` folded query rows per block,
    tiles of `bn` keys through a ring of `stages`, `row_tiles` blocks per
    (query tile, KV head), each a cluster of `cluster` ranks that split the
    tile's live key tiles, every rank keeping at least `min_share` of them
    (the ranks agree on the device to walk with fewer where a tile has
    fewer live tiles; 0: every rank walks its share); `blocks` in all."""

    rows: int
    bn: int
    stages: int
    row_tiles: int
    cluster: int
    blocks: int
    min_share: int


def ragged_plan(G, tq, H, KV, MB, bs, Dh, sm_count, esize=2, kv_esize=None) -> RaggedPlan:
    """The plan of one ragged_paged_attend launch, from the shapes alone
    (a tile's live length is read on the device, so a call reads nothing
    back and can be captured): the flash walk's tiles and ring
    (`walk_tiles`, which the entry point checks against its build), and
    the smallest cluster of 1, 2, 4 or 8 ranks whose G * KV * row_tiles *
    cluster blocks cover every SM, but no larger than leaves each rank
    two of the MB * bs keys' tiles that a table row can hold."""
    bn, stages = walk_tiles(Dh, esize, kv_esize)
    row_tiles = -(-tq * (H // KV) // FLASH_ROWS)
    base = G * KV * row_tiles
    tiles = -(-MB * bs // bn)
    cluster = 1
    while (cluster < FLASH_MAX_CLUSTER and base * cluster < sm_count
           and 4 * cluster <= tiles):
        cluster *= 2
    return RaggedPlan(FLASH_ROWS, bn, stages, row_tiles, cluster, base * cluster,
                      RAGGED_MIN_SHARE)


def _attend_blocks(q5, blocks, pool_k, pool_v, q_pos, live, window_dyn,
                   window, scale, softcap):
    """Shared twin core. q5 [G, tq, KV, group, Dh]; blocks [G, MB] the
    physical ids of each tile's row; q_pos / live [G, tq]. fp32 math over
    the gathered [G, KV, MB*bs, Dh] view (an int8 pool: gathered, then
    dequantized); rows with no live key get zeros."""
    G, tq, KV, group, Dh = q5.shape
    N, _, bs, _ = pool_k.shape
    MB = blocks.shape[1]
    S = MB * bs
    blocks = blocks.long()
    blocks = torch.where((blocks >= 0) & (blocks < N), blocks, 0)

    def view(pool):  # [G, MB, KV, bs, Dh] -> [G, KV, S, Dh]
        return fp32_leaf(pool[blocks]).permute(0, 2, 1, 3, 4).reshape(G, KV, S, Dh)

    s = torch.einsum("gtkhd,gksd->gkhts", q5.float() * scale, view(pool_k))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = torch.arange(S, dtype=torch.int32, device=q5.device)
    mask = live[:, :, None] & (kv_pos[None, None, :] <= q_pos[:, :, None])
    if window_dyn is not None:
        w = window_dyn.reshape(())
        mask = mask & ((w <= 0) | (kv_pos[None, None, :] > q_pos[:, :, None] - w))
    elif window is not None and window > 0:
        mask = mask & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
    mask = mask[:, None, None]  # [G, 1, 1, tq, S]
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)  # no live key: zeros
    o = torch.einsum("gkhts,gksd->gtkhd", p / denom, view(pool_v))
    return o  # [G, tq, KV, group, Dh] fp32


def ragged_paged_attend_plain(q, pool_k, pool_v, table, meta, window_dyn=None,
                              *, window=None, scale=None, softcap=None):
    """The ragged kernel's plain twin (same signature): gather each
    tile's row of blocks into a contiguous view, then masked fp32
    attention — the contract of the JAX package's `_ragged_attend_xla`,
    with the kernel's zeros for padding rows."""
    W, H, Dh = q.shape
    G = meta.shape[0]
    tq = W // G
    KV = pool_k.shape[1]
    scale = Dh ** -0.5 if scale is None else scale
    meta = meta.long()
    rows = meta[:, 0].clamp(0, table.shape[0] - 1)
    t = torch.arange(tq, device=q.device)
    q_pos = (meta[:, 1:2] + t[None, :]).to(torch.int32)
    live = t[None, :] < meta[:, 2:3]
    o = _attend_blocks(
        q.reshape(G, tq, KV, H // KV, Dh), table[rows], pool_k, pool_v,
        q_pos, live, window_dyn, window, scale, softcap,
    )
    return o.reshape(W, H, Dh).to(q.dtype)


def paged_flash_attend_plain(q, pool_k, pool_v, table, pos, window_dyn=None,
                             *, window=None, scale=None, softcap=None):
    """The decode kernel's plain twin (same signature): the gather path
    of the JAX package's engine/paged.make_paged_hook with the mask
    derived from pos and the window."""
    B, _, H, Dh = q.shape
    KV = pool_k.shape[1]
    scale = Dh ** -0.5 if scale is None else scale
    live = torch.ones((B, 1), dtype=torch.bool, device=q.device)
    o = _attend_blocks(
        q.reshape(B, 1, KV, H // KV, Dh), table, pool_k, pool_v,
        pos.to(torch.int32)[:, None], live, window_dyn, window, scale, softcap,
    )
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def ragged_paged_attend(q, pool_k, pool_v, table, meta, window_dyn=None, *,
                        window=None, scale=None, softcap=None, plan=None):
    """Mixed prefill + decode attention over the (already updated) pool;
    see the module docstring. Counts its kernel launches in
    `ragged_paged_attend.launches` (raw pool) and
    `ragged_paged_attend.launches_int8` (int8 pool). `plan`: a RaggedPlan
    to launch instead of `ragged_plan`'s (chip_smoke's sweep); the CPU
    twin ignores it."""
    if not resolve_kernel(q.device):
        return ragged_paged_attend_plain(
            q, pool_k, pool_v, table, meta, window_dyn,
            window=window, scale=scale, softcap=softcap,
        )
    W, H, Dh = q.shape
    G = meta.shape[0]
    if q.dim() != 3 or meta.shape != (G, 4) or G == 0 or W % G != 0:
        raise ValueError(
            f"ragged_paged_attend wants q [W,H,Dh] and meta [G,4] with G "
            f"dividing W; got {tuple(q.shape)}, {tuple(meta.shape)}"
        )
    N, KV, bs = _check("ragged_paged_attend", q, pool_k, pool_v, table,
                       window_dyn, (("meta", meta, G * 4),))
    R, MB = table.shape
    if plan is None:
        plan = ragged_plan(G, W // G, H, KV, MB, bs, Dh, _sm_count(q.device),
                           q.element_size(), 1 if isinstance(pool_k, KVQuant) else None)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dli_ragged_paged_attend(
            q.data_ptr(), *kv_operands(pool_k, pool_v),
            out.data_ptr(), _DTYPE_CODES[q.dtype], G, W // G, H, KV, N, bs,
            R, MB, Dh, table.data_ptr(), meta.data_ptr(),
            int(window) if window is not None else -1,
            window_dyn.data_ptr() if window_dyn is not None else None,
            float(Dh ** -0.5 if scale is None else scale),
            float(softcap) if softcap is not None else 0.0,
            plan.bn, plan.stages, plan.cluster, plan.min_share, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attend kernel launch failed: CUDA error {rc}")
    count_launch(ragged_paged_attend, pool_k)
    return out


ragged_paged_attend.launches = 0
ragged_paged_attend.launches_int8 = 0


def paged_flash_attend(q, pool_k, pool_v, table, pos, window_dyn=None, *,
                       window=None, scale=None, softcap=None):
    """T=1 decode attention over the (already updated) pool; see the
    module docstring. Counts its kernel launches in
    `paged_flash_attend.launches` (raw pool) and
    `paged_flash_attend.launches_int8` (int8 pool)."""
    if not resolve_kernel(q.device):
        return paged_flash_attend_plain(
            q, pool_k, pool_v, table, pos, window_dyn,
            window=window, scale=scale, softcap=softcap,
        )
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(
            f"paged_flash_attend serves T=1 decode: q [B,1,H,Dh], got "
            f"{tuple(q.shape)}"
        )
    B, _, H, Dh = q.shape
    if table.shape[0] != B:
        raise ValueError(f"paged_flash_attend: table has {table.shape[0]} rows for B={B}")
    N, KV, bs = _check("paged_flash_attend", q, pool_k, pool_v, table,
                       window_dyn, (("pos", pos, B),))
    MB = table.shape[1]
    n_split = _paged_splits(B, KV, MB, bs, _sm_count(q.device))
    out = torch.empty_like(q)
    # per (row, KV head, split): acc [group, Dh], then (m, l) [group, 2]
    ws = torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dli_paged_flash_attend(
            q.data_ptr(), *kv_operands(pool_k, pool_v), out.data_ptr(),
            ws.data_ptr(), _DTYPE_CODES[q.dtype], B, H, KV, N, bs, MB, Dh,
            table.data_ptr(), pos.data_ptr(),
            int(window) if window is not None else -1,
            window_dyn.data_ptr() if window_dyn is not None else None,
            float(Dh ** -0.5 if scale is None else scale),
            float(softcap) if softcap is not None else 0.0, n_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_flash_attend kernel launch failed: CUDA error {rc}")
    count_launch(paged_flash_attend, pool_k)
    return out


paged_flash_attend.launches = 0
paged_flash_attend.launches_int8 = 0


def _slots_window(window):
    if window is not None and int(window) <= 0:
        raise ValueError(f"flash_attend_slots: window must be None or > 0, got {window}")
    return None if window is None else int(window)


def flash_attend_slots_plain(q, cache_k, cache_v, pos, *, block_k=0, window=None):
    """The slots kernel's twin (same signature): ops/attention.attend over
    the dense cache with slot_causal_mask(pos, 1, S, window), the function
    the JAX package's tests hold its kernel to. They differ only for a row
    with no live key (pos < 0, or a window that ends before S): the
    kernels give zeros, attend the mean of V; the fleet never has one."""
    from .attention import attend, slot_causal_mask

    del block_k  # the JAX kernel's DMA tile; the function does not depend on it
    S = cache_k.shape[2]
    mask = slot_causal_mask(pos.to(torch.int32), 1, S, _slots_window(window))
    return attend(q, cache_k, cache_v, mask, scale=q.shape[-1] ** -0.5)


def flash_attend_slots(q, cache_k, cache_v, pos, *, block_k=0, window=None):
    """T=1 decode attention over the dense slot-fleet cache, one position
    per row; see the module docstring. Counts its kernel launches in
    `flash_attend_slots.launches`."""
    window = _slots_window(window)
    if not resolve_kernel(q.device):
        return flash_attend_slots_plain(q, cache_k, cache_v, pos,
                                        block_k=block_k, window=window)
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.ndim != 4 \
            or cache_v.shape != cache_k.shape:
        raise ValueError(
            f"flash_attend_slots wants q [B,1,H,Dh] and caches [B,KV,S,Dh]; got "
            f"{tuple(q.shape)}, {tuple(cache_k.shape)}, {tuple(cache_v.shape)}"
        )
    B, _, H, Dh = q.shape
    _, KV, S, cDh = cache_k.shape
    if cache_k.shape[0] != B or cDh != Dh or H % KV != 0 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attend_slots shape mismatch: q {tuple(q.shape)} "
                         f"vs cache {tuple(cache_k.shape)} (Dh <= {MAX_HEAD_DIM})")
    if isinstance(cache_k, KVQuant) or isinstance(cache_v, KVQuant):
        raise TypeError("flash_attend_slots takes a raw cache (the JAX kernel "
                        "has no int8 variant)")
    check_cache_leaves("flash_attend_slots", q, cache_k, cache_v)
    if pos.device != q.device or pos.dtype != torch.int32 \
            or pos.numel() != B or not pos.is_contiguous():
        raise ValueError(f"flash_attend_slots: pos must be a contiguous int32 "
                         f"tensor of {B} element(s) on {q.device}")
    n_split = _slots_splits(B, KV, S, _sm_count(q.device))
    out = torch.empty_like(q)
    # per (row, KV head, split): acc [group, Dh], then (m, l) [group, 2]
    ws = torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32, device=q.device)
    lib = _slots_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dli_flash_attend_slots(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
            ws.data_ptr(), _DTYPE_CODES[q.dtype], B, H, KV, S, Dh, pos.data_ptr(),
            window if window is not None else -1, float(Dh ** -0.5), n_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attend_slots kernel launch failed: CUDA error {rc}")
    flash_attend_slots.launches += 1
    return out


flash_attend_slots.launches = 0


def _check(name, q, pool_k, pool_v, table, window_dyn, int_operands):
    """Validate what the kernel takes from shapes, dtypes and devices
    alone (nothing is read back from the card); returns (N, KV, bs)."""
    if pool_k.ndim != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"{name} wants pools [N,KV,bs,Dh]; got {tuple(pool_k.shape)}, "
            f"{tuple(pool_v.shape)}"
        )
    N, KV, bs, Dh = pool_k.shape
    H = q.shape[-2]
    if q.shape[-1] != Dh or H % KV != 0:
        raise ValueError(f"{name} shape mismatch: q {tuple(q.shape)} vs pool "
                         f"{tuple(pool_k.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"{name} takes Dh <= {MAX_HEAD_DIM}, got {Dh}")
    check_cache_leaves(name, q, pool_k, pool_v)
    checks = (("table", table, table.numel()), ("window_dyn", window_dyn, 1)) \
        + tuple(int_operands)
    for tname, t, n in checks:
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.int32 \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(
                f"{name}: {tname} must be a contiguous int32 tensor of {n} "
                f"element(s) on {q.device}"
            )
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be [R, MB], got {tuple(table.shape)}")
    return N, KV, bs
