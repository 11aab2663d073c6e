"""Flash attention of a query chunk over the dense KV cache: the CUDA
kernel's wrapper, its plain PyTorch twin, and the switch between them.

`flash_attend` is the port of the JAX package's ops/flash_attention.py
`flash_attend`, whose Pallas body `_flash_kernel` becomes the hand-written
Hopper kernel in csrc/flash_attention.cu over the tensor-core walk of
csrc/flash_walk.cuh (the two source notes say what bounds it and what its
design does about it). Same contract as
`attention.attend` with the mask derived from `pos`, `valid_start` and
the window instead of passed in:

  q [B, T, H, Dh], cache_k / cache_v [B, KV, S, Dh], pos an int (the
  chunk's first absolute position), valid_start an optional int32 [B]
  (each row's first real slot in a left-padded batch), window a static
  sliding width or window_dyn a one-element int32 tensor (<= 0 = full
  causal; per-layer window patterns pass the layer's width as a tensor so
  no host sync is needed), scale (None = Dh**-0.5) and softcap.
  Returns [B, T, H, Dh] in q.dtype; a query row with no live key gets
  zeros, as in the TPU kernel.

  The cache may be int8 (ops/kv_quant.KVQuant leaves: q [B, KV, S, Dh]
  int8 and fp32 scales s [B, KV, S]); the kernel dequantizes each tile in
  its prologue and counts those launches in `flash_attend.launches_int8`,
  raw-dtype launches in `flash_attend.launches`.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain twin `flash_attend_plain` — the CPU tests hold
that twin to the JAX kernel in interpret mode, and chip_smoke.py holds
the kernel to the twin on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..kernels import bind, load_library
from .kv_quant import KVQuant, dequantize

NEG = -0.7 * torch.finfo(torch.float32).max  # the TPU kernel's mask fill
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def resolve_kernel(device) -> bool:
    """The one switch between every kernel and its plain twin (the
    counterpart of the JAX package's resolve_interpret): True — launch
    the CUDA kernel — for a CUDA device, False — run the plain twin — for
    the CPU. Any other device raises: there is no third path."""
    kind = torch.device(device).type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no attention kernel for device type {kind!r}")


_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry point's argument types (csrc/flash_attention.cu)
SIGNATURES = {"dli_flash_attend": [
    _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
    _vp, _i32, _vp, _f32, _f32, _i32, _i32, _i32, _vp,
]}

FLASH_ROWS = 64  # folded query rows per block: four warps of 16 (the kernel's BM)
FLASH_MAX_CLUSTER = 8  # the portable thread-block cluster size


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class FlashPlan(NamedTuple):
    """The flash kernel's launch: `rows` folded query rows per block,
    tiles of `bn` keys through a ring of `stages`, `row_tiles` query tiles
    per (batch row, KV head), each a cluster of `cluster` blocks that
    split its live key tiles evenly; `blocks` in all."""

    rows: int
    bn: int
    stages: int
    row_tiles: int
    cluster: int
    blocks: int


def walk_tiles(Dh, esize=2, kv_esize=None):
    """(bn, stages) of the flash walk (csrc/flash_walk.cuh `Plan`) for a
    head dim, q's element size and the K/V rows' (1 for int8; default
    q's): keys per tile, 32 where a 64-key tile's row of q's type would
    pass 512 bytes, and 3 ring stages where three fit in 64 KB, else 2."""
    kv_esize = esize if kv_esize is None else kv_esize
    dhp = 64 if Dh <= 64 else 128 if Dh <= 128 else 256
    bn = 32 if esize * dhp >= 512 else 64
    stage = 2 * bn * (dhp + 16 // kv_esize) * kv_esize + (2 * bn * 4 if kv_esize == 1 else 0)
    return bn, 3 if 3 * stage <= 64 * 1024 else 2


def flash_plan(B, T, H, KV, S, Dh, sm_count, esize=2, kv_esize=None,
               pos=None) -> FlashPlan:
    """The plan of one flash_attend launch, from the shapes and the
    chunk's position alone (so a call reads nothing back and can be
    captured). `esize`: q's element size; `kv_esize`: the cache's (1 for
    int8; default q's); `pos`: the chunk's first position (None: a chunk
    that ends at S). `bn` and `stages` mirror the kernel's compile-time
    `Plan` (the entry point refuses a plan that differs). The cluster is
    the smallest power of two <= 8 whose blocks cover every SM, but no
    larger than leaves each rank two of the live tiles of the chunk's
    last query: on an H100 the cluster's merge costs more than a split of
    one or two tiles saves (chip_smoke.py --only b sweeps the sizes).
    valid_start and a window can only shorten the live range."""
    bn, stages = walk_tiles(Dh, esize, kv_esize)
    row_tiles = -(-T * (H // KV) // FLASH_ROWS)
    base = row_tiles * KV * B
    live = -(-(S if pos is None else pos + T) // bn)
    cluster = 1
    while (cluster < FLASH_MAX_CLUSTER and base * cluster < sm_count
           and 4 * cluster <= live):
        cluster *= 2
    return FlashPlan(FLASH_ROWS, bn, stages, row_tiles, cluster, base * cluster)


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("flash_attention"), SIGNATURES)


def _window_tensor(window, window_dyn, device):
    if window_dyn is not None:
        return window_dyn
    return torch.tensor(window if window is not None else -1,
                        dtype=torch.int32, device=device)


def raw_leaf(leaf):
    """A raw-dtype cache leaf as it is, or raise for a bare int8 tensor:
    an int8 cache comes as a KVQuant (data and scales)."""
    if leaf.dtype == torch.int8:
        raise TypeError(
            "an int8 KV cache is passed as ops/kv_quant.KVQuant leaves (int8 "
            "data and fp32 scales), not as a bare int8 tensor"
        )
    return leaf


def fp32_leaf(leaf):
    """A cache leaf in fp32: a KVQuant dequantized, a raw tensor cast."""
    return dequantize(leaf) if isinstance(leaf, KVQuant) else raw_leaf(leaf).float()


def flash_attend_plain(q, cache_k, cache_v, pos, valid_start=None,
                       window_dyn=None, *, window=None, scale=None,
                       softcap=None):
    """The kernel's plain twin: the same function in PyTorch, fp32 math,
    the whole [T, S] score matrix at once (an int8 cache dequantized
    first). Same signature as `flash_attend`."""
    B, T, H, Dh = q.shape
    KV, S = cache_k.shape[1], cache_k.shape[2]
    group = H // KV
    device = q.device
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, T, KV, group, Dh).float() * scale
    s = torch.einsum("btkgd,bksd->bkgts", qg, fp32_leaf(cache_k))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = int(pos) + torch.arange(T, dtype=torch.int32, device=device)
    kv_pos = torch.arange(S, dtype=torch.int32, device=device)
    win = _window_tensor(window, window_dyn, device).reshape(())
    mask = kv_pos[None, :] <= q_pos[:, None]  # [T, S]
    mask = mask & ((win <= 0) | (kv_pos[None, :] > q_pos[:, None] - win))
    if valid_start is None:
        mask = mask[None]  # [1, T, S]
    else:
        mask = mask[None] & (kv_pos[None, None, :] >= valid_start[:, None, None])
    mask = mask[:, None, None]  # [B|1, 1, 1, T, S]
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)  # no live key: zeros
    o = torch.einsum("bkgts,bksd->btkgd", p, fp32_leaf(cache_v))
    o = o / denom.permute(0, 3, 1, 2, 4)  # [B, T, KV, group, 1]
    return o.reshape(B, T, H, Dh).to(q.dtype)


def flash_attend(q, cache_k, cache_v, pos, valid_start=None,
                 window_dyn=None, *, window=None, scale=None, softcap=None,
                 plan=None):
    """Causal GQA flash attention over the (already updated) cache; see
    the module docstring for the contract. Counts its kernel launches in
    `flash_attend.launches` (raw cache) and `flash_attend.launches_int8`
    (int8 cache). `plan`: a FlashPlan to launch instead of `flash_plan`'s
    (chip_smoke's sweep of cluster sizes); the CPU twin ignores it."""
    if not resolve_kernel(q.device):
        return flash_attend_plain(
            q, cache_k, cache_v, pos, valid_start, window_dyn,
            window=window, scale=scale, softcap=softcap,
        )
    B, T, H, Dh = _check(q, cache_k, cache_v, pos, valid_start, window_dyn)
    KV, S = cache_k.shape[1], cache_k.shape[2]
    if plan is None:
        plan = flash_plan(B, T, H, KV, S, Dh, _sm_count(q.device), q.element_size(),
                          1 if isinstance(cache_k, KVQuant) else None, int(pos))
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dli_flash_attend(
            q.data_ptr(), *kv_operands(cache_k, cache_v),
            out.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, KV, S, Dh,
            int(pos),
            valid_start.data_ptr() if valid_start is not None else None,
            int(window) if window is not None else -1,
            window_dyn.data_ptr() if window_dyn is not None else None,
            float(Dh ** -0.5 if scale is None else scale),
            float(softcap) if softcap is not None else 0.0,
            plan.bn, plan.stages, plan.cluster, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attend kernel launch failed: CUDA error {rc}")
    count_launch(flash_attend, cache_k)
    return out


flash_attend.launches = 0
flash_attend.launches_int8 = 0


def count_launch(wrapper, cache_k):
    """One launch on the wrapper's count for the cache's storage type
    (`launches` raw, `launches_int8` int8)."""
    if isinstance(cache_k, KVQuant):
        wrapper.launches_int8 += 1
    else:
        wrapper.launches += 1


def kv_operands(cache_k, cache_v):
    """(k, v, k_scale, v_scale) data pointers for an attention kernel; the
    scales are None for a raw cache or pool."""
    if isinstance(cache_k, KVQuant):
        return (cache_k.q.data_ptr(), cache_v.q.data_ptr(),
                cache_k.s.data_ptr(), cache_v.s.data_ptr())
    return cache_k.data_ptr(), cache_v.data_ptr(), None, None


def check_cache_leaves(name, q, cache_k, cache_v):
    """Validate a pair of raw or int8 (KVQuant) cache leaves against q,
    from shapes, dtypes and devices alone: raw leaves share q's dtype;
    int8 leaves are int8 data with fp32 scales of the data's shape less
    its last axis; every tensor is contiguous on q's device."""
    if isinstance(cache_k, KVQuant) != isinstance(cache_v, KVQuant):
        raise TypeError(f"{name}: k and v must both be raw or both int8")
    if isinstance(cache_k, KVQuant):
        tensors = (("k", cache_k.q), ("v", cache_v.q), ("k scales", cache_k.s),
                   ("v scales", cache_v.s))
        if cache_k.q.dtype != torch.int8 or cache_v.q.dtype != torch.int8 \
                or cache_k.s.dtype != torch.float32 \
                or cache_v.s.dtype != torch.float32 \
                or cache_k.s.shape != cache_k.q.shape[:-1] \
                or cache_v.s.shape != cache_v.q.shape[:-1]:
            raise TypeError(
                f"{name}: an int8 cache is int8 data with fp32 scales of its "
                f"shape less the last axis; got {cache_k}, {cache_v}"
            )
        ok = q.dtype in _DTYPE_CODES
    else:
        tensors = (("k", raw_leaf(cache_k)), ("v", raw_leaf(cache_v)))
        ok = q.dtype in _DTYPE_CODES and cache_k.dtype == q.dtype \
            and cache_v.dtype == q.dtype
    if not ok:
        raise TypeError(
            f"{name} takes float32/bfloat16/float16 q and caches of q's "
            f"dtype or int8; got {q.dtype}, {cache_k.dtype}, {cache_v.dtype}"
        )
    for tname, t in (("q", q),) + tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous on {q.device}")


def _check(q, cache_k, cache_v, pos, valid_start, window_dyn):
    """Validate what the kernel takes; returns (B, T, H, Dh)."""
    if q.dim() != 4 or cache_k.ndim != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(
            f"flash_attend wants q [B,T,H,Dh] and caches [B,KV,S,Dh]; got "
            f"{tuple(q.shape)}, {tuple(cache_k.shape)}, {tuple(cache_v.shape)}"
        )
    B, T, H, Dh = q.shape
    _, KV, S, cDh = cache_k.shape
    if cache_k.shape[0] != B or cDh != Dh or H % KV != 0:
        raise ValueError(
            f"flash_attend shape mismatch: q {tuple(q.shape)} vs cache "
            f"{tuple(cache_k.shape)}"
        )
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attend takes Dh <= {MAX_HEAD_DIM}, got {Dh}")
    check_cache_leaves("flash_attend", q, cache_k, cache_v)
    for name, t, n in (("valid_start", valid_start, B),
                       ("window_dyn", window_dyn, 1)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.int32 \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(
                f"flash_attend: {name} must be a contiguous int32 tensor of "
                f"{n} element(s) on {q.device}"
            )
    if not (0 <= int(pos) and int(pos) + T <= S):
        raise ValueError(f"flash_attend: chunk [{pos}, {int(pos) + T}) outside S={S}")
    return B, T, H, Dh
