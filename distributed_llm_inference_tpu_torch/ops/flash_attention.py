"""Flash attention of a query chunk over the dense KV cache: the CUDA
kernel's wrapper, its plain PyTorch twin, and the switch between them.

`flash_attend` is the port of the JAX package's ops/flash_attention.py
`flash_attend`, whose Pallas body `_flash_kernel` becomes the hand-written
Hopper kernel in csrc/flash_attention.cu (the source note there says what
bounds it and what its design does about it). Same contract as
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

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain twin `flash_attend_plain` — the CPU tests hold
that twin to the JAX kernel in interpret mode, and chip_smoke.py holds
the kernel to the twin on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import load_library

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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.dli_flash_attend
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
                   vp, i32, vp, ctypes.c_float, ctypes.c_float, vp]
    fn.restype = i32
    return lib


def _window_tensor(window, window_dyn, device):
    if window_dyn is not None:
        return window_dyn
    return torch.tensor(window if window is not None else -1,
                        dtype=torch.int32, device=device)


def flash_attend_plain(q, cache_k, cache_v, pos, valid_start=None,
                       window_dyn=None, *, window=None, scale=None,
                       softcap=None):
    """The kernel's plain twin: the same function in PyTorch, fp32 math,
    the whole [T, S] score matrix at once. Same signature as
    `flash_attend`."""
    B, T, H, Dh = q.shape
    KV, S = cache_k.shape[1], cache_k.shape[2]
    group = H // KV
    device = q.device
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, T, KV, group, Dh).float() * scale
    s = torch.einsum("btkgd,bksd->bkgts", qg, cache_k.float())
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
    o = torch.einsum("bkgts,bksd->btkgd", p, cache_v.float())
    o = o / denom.permute(0, 3, 1, 2, 4)  # [B, T, KV, group, 1]
    return o.reshape(B, T, H, Dh).to(q.dtype)


def flash_attend(q, cache_k, cache_v, pos, valid_start=None,
                 window_dyn=None, *, window=None, scale=None, softcap=None):
    """Causal GQA flash attention over the (already updated) cache; see
    the module docstring for the contract. Counts its kernel launches in
    `flash_attend.launches`."""
    if cache_k.dtype == torch.int8 or cache_v.dtype == torch.int8:
        raise NotImplementedError(
            "flash_attend on an int8 KV cache: the dequantizing prologue "
            "waits for the ops/kv_quant.py port (ROADMAP.md "
            "\"Quantization\")"
        )
    if not resolve_kernel(q.device):
        return flash_attend_plain(
            q, cache_k, cache_v, pos, valid_start, window_dyn,
            window=window, scale=scale, softcap=softcap,
        )
    B, T, H, Dh = _check(q, cache_k, cache_v, pos, valid_start, window_dyn)
    KV, S = cache_k.shape[1], cache_k.shape[2]
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dli_flash_attend(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, KV, S, Dh,
            int(pos),
            valid_start.data_ptr() if valid_start is not None else None,
            int(window) if window is not None else -1,
            window_dyn.data_ptr() if window_dyn is not None else None,
            float(Dh ** -0.5 if scale is None else scale),
            float(softcap) if softcap is not None else 0.0,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attend kernel launch failed: CUDA error {rc}")
    flash_attend.launches += 1
    return out


flash_attend.launches = 0


def _check(q, cache_k, cache_v, pos, valid_start, window_dyn):
    """Validate what the kernel takes; returns (B, T, H, Dh)."""
    if q.dim() != 4 or cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
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
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise TypeError(
            f"flash_attend takes float32/bfloat16/float16 q and caches of "
            f"one dtype; got {q.dtype}, {cache_k.dtype}, {cache_v.dtype}"
        )
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.device != q.device:
            raise ValueError(f"flash_attend: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attend: {name} must be contiguous")
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
