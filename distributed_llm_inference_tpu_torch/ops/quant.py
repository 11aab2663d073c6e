"""Weight-only quantization (int8 and int4) and the int4 row kernel's
wrapper: the JAX package's ops/quant.py in PyTorch.

  * int8 (`QTensor`): q int8 [..., in, out] with one fp32 scale per output
    channel s [..., out]; y = (x @ q.to(x.dtype)) * s, a plain
    torch.matmul, as the JAX package leaves it to XLA.
  * int4 (`Q4Tensor`): two signed 4-bit values per byte along the group
    row axis, q int8 [..., G, g/2, out] (group row i in the LOW nibble,
    row i + g/2 in the HIGH: halves, not interleaved pairs), with one fp32
    scale per (group, output channel) s [..., G, out].

`matmul(x, w)` sends an int4 projection of at most 32 rows to
`q4_matmul_rows` — the port of the JAX package's Pallas kernel of the
same name (`_q4_rows_kernel`), a hand-written Hopper kernel in
csrc/q4_matmul.cu (tensor-core products, one launch: the blocks that
share a column tile split the groups and sum in a thread-block cluster;
`q4_plan` fixes that grid from the shapes) whose source note says what
bounds it — under the JAX package's own gate (`_q4_kernel_ok`); above it
(prefill chunks, the mixed launch's projections) it keeps the JAX
package's einsum formulation: per-group partial products in x's dtype,
scaled, summed over groups.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs its plain twin `q4_matmul_rows_plain`. Both tensor classes
slice every leaf with `w[i]` (one layer of the stacked [L, ...] weights).
Embeddings, norms and biases stay dense. An MoE expert bank [L, E, in,
out] becomes an int8 QTensor with per-(layer, expert, out-channel) scales
under int8 (`expert_einsum` carries it through the MoE einsums) and stays
dense under int4, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..kernels import bind, load_library
from .flash_attention import _sm_count, resolve_kernel

# stacked matmul weights eligible for quantization, per family; OUTPUT
# channels are the last axis of every one (weights are stored [L, in, out]
# / [in, out], expert banks [L, E, in, out])
_QUANT_KEYS = {
    "llama": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
    "gpt2": ("wq", "wk", "wv", "wo", "w_fc", "w_proj"),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's tiling (csrc/q4_matmul.cu): output columns per block, packed
# rows per stage of its copy ring, the ring's and the cluster's largest
# sizes; the ring bytes a block may take, and the shared memory of an SM
# that its resident blocks share
Q4_TILE = 128
Q4_KBLOCK = 32
Q4_MAX_STAGES = 8
Q4_MAX_SPLIT = 8
_Q4_RING_BYTES = 72 * 1024
_SM_SHARED_BYTES = 216 * 1024


class Q4Plan(NamedTuple):
    """The kernel's grid: `tiles` column tiles of Q4_TILE outputs, each
    one cluster of `n_split` blocks; block k takes groups [k * gps,
    min(G, (k + 1) * gps)) through a copy ring of `stages` k-blocks."""

    n_split: int
    tiles: int
    gps: int
    stages: int


def q4_recv_bytes(R: int) -> int:
    """Shared memory a block of the kernel keeps beside its ring: its
    receive buffer for the cluster's sum ([R, Q4_TILE] fp32, rounded up per
    rank) and its mbarrier."""
    return 4 * Q4_TILE * R + 16 * Q4_MAX_SPLIT + 16


def q4_stage_bytes(R: int, esize: int) -> int:
    """Bytes of one stage of the kernel's ring: Q4_KBLOCK packed rows of
    Q4_TILE columns (rows padded by 32 bytes), the tile's fp32 scales, and
    2 * Q4_KBLOCK columns of x for each row of its 8-row tiles (padded by
    16 bytes)."""
    rows = 8 * (1 if R <= 8 else 2 if R <= 16 else 4)
    return (Q4_KBLOCK * (Q4_TILE + 32) + 4 * Q4_TILE
            + rows * (2 * Q4_KBLOCK * esize + 16))


@functools.lru_cache(maxsize=None)
def q4_plan(R: int, G: int, half: int, d_out: int, sm_count: int,
            esize: int) -> Q4Plan:
    """The q4 kernel's grid for x [R, 2 * half * G] (element size esize)
    against a weight of G groups and d_out columns on a card of sm_count
    SMs: enough blocks per column tile that the grid puts four on each SM,
    at most Q4_MAX_SPLIT (a portable cluster) and no more than the groups,
    each block an equal run of groups (the last may be shorter, none is
    empty); its ring as deep as its k-blocks, at most Q4_MAX_STAGES and
    _Q4_RING_BYTES, and small enough that every block of the grid is
    resident at once (but two stages where there are two k-blocks). Fixed
    from shapes alone: a launch reads nothing back."""
    tiles = d_out // Q4_TILE
    n = max(1, min(Q4_MAX_SPLIT, G, -(-4 * sm_count // tiles)))
    gps = -(-G // n)
    n = -(-G // gps)
    per_sm = -(-n * tiles // sm_count)
    ring = min(_Q4_RING_BYTES, _SM_SHARED_BYTES // per_sm - q4_recv_bytes(R))
    kblocks = gps * (half // Q4_KBLOCK)
    stages = min(Q4_MAX_STAGES, kblocks, ring // q4_stage_bytes(R, esize))
    return Q4Plan(n, tiles, gps, max(min(2, kblocks), stages))


class QTensor:
    """int8 weight + per-output-channel scale; q [..., in, out] int8,
    s [..., out] fp32."""

    __slots__ = ("q", "s")

    def __init__(self, q, s):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, idx):
        return QTensor(self.q[idx], self.s[idx])

    def __repr__(self):
        return f"QTensor(q={tuple(self.q.shape)}@{self.q.dtype}, s={tuple(self.s.shape)})"


class Q4Tensor:
    """Packed int4 weight + per-(group, output-channel) scale; q int8
    [..., G, g/2, out] of nibble halves, s [..., G, out] fp32, g the group
    size (contraction rows per scale)."""

    __slots__ = ("q", "s", "g")

    def __init__(self, q, s, g: int):
        self.q = q
        self.s = s
        self.g = int(g)

    @property
    def shape(self):  # logical [..., in, out]
        *lead, G, _, out = self.q.shape
        return torch.Size((*lead, G * self.g, out))

    def __getitem__(self, idx):
        return Q4Tensor(self.q[idx], self.s[idx], self.g)

    def __repr__(self):
        return (f"Q4Tensor(q={tuple(self.q.shape)}@{self.q.dtype}, "
                f"s={tuple(self.s.shape)}, g={self.g})")


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel int8 quantization of w [..., in, out];
    q and s bit-equal to the JAX package's (round half to even, the
    1e-12 scale floor, clip to +-127)."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale[..., 0, :])


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """int8 [..., n, out] of packed nibble halves -> int8 [..., 2n, out]:
    low nibbles are rows [0, n), high nibbles rows [n, 2n). Shifts on int8
    wrap and sign-extend, so the low nibble comes out via (p << 4) >> 4,
    as in the JAX package."""
    return torch.cat([(p << 4) >> 4, p >> 4], dim=-2)


def quantize_tensor4(w: torch.Tensor, group: int = 64) -> Q4Tensor:
    """Symmetric group-wise int4 quantization of w [..., in, out]."""
    *lead, d_in, d_out = w.shape
    g = min(group, d_in)
    if d_in % g:
        g = d_in  # one group rather than reject an odd shape
    if g % 2:
        raise ValueError(f"int4 packing needs an even group size, got {g}")
    G = d_in // g
    w32 = w.float().reshape(*lead, G, g, d_out)
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8)
    half = g // 2
    packed = torch.bitwise_or(q[..., half:, :] << 4, q[..., :half, :] & 15)
    return Q4Tensor(packed, scale[..., 0, :], g)


def dequantize_tensor(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.float() * t.s[..., None, :].float()).to(dtype)


def dequantize_tensor4(t: Q4Tensor, dtype=torch.float32) -> torch.Tensor:
    w = _unpack_int4(t.q).float() * t.s[..., None, :].float()  # [..., G, g, out]
    *lead, G, g, out = w.shape
    return w.reshape(*lead, G * g, out).to(dtype)


def _q4_kernel_ok(R: int, w: Q4Tensor) -> bool:
    """The JAX package's gate for the kernel, gate for gate: few rows
    (decode / slots; prefill keeps the einsum), an int8-tile-friendly
    packed block (half % 32, out % 128), one stacked slice."""
    if w.q.dim() != 3 or R > 32:
        return False
    _, half, d_out = w.q.shape
    return half % 32 == 0 and d_out % 128 == 0


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# the C entry point's argument types (csrc/q4_matmul.cu)
SIGNATURES = {"dli_q4_matmul_rows": [
    _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp,
]}


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("q4_matmul"), SIGNATURES)


def q4_matmul_rows_plain(x2d: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """The kernel's plain twin: unpack, then the fp32 product of each
    group, scaled by the group's scales and summed over groups (the
    Pallas kernel's algebra). x2d [R, in] -> [R, out] in x2d's dtype."""
    R, d_in = x2d.shape
    G, half, d_out = w.q.shape
    wq = _unpack_int4(w.q).float()  # [G, g, out]
    xg = x2d.float().reshape(R, G, 2 * half)
    part = torch.einsum("rgi,gio->rgo", xg, wq)
    return (part * w.s.float()[None]).sum(dim=1).to(x2d.dtype)


def q4_matmul_rows(x2d: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """y = x2d @ dequant(w) for x2d [R <= 32, in] and one stacked slice
    w (q [G, g/2, out]), under `_q4_kernel_ok`'s gate; returns [R, out] in
    x2d's dtype (the JAX function returns fp32 and its caller casts: the
    kernel writes the cast directly, the same rounding). One launch on the
    grid of `q4_plan`; counts its launches in `q4_matmul_rows.launches`."""
    if not resolve_kernel(x2d.device):
        return q4_matmul_rows_plain(x2d, w)
    R, G, half, d_out = _check(x2d, w)
    if x2d.data_ptr() % 16:  # the kernel copies x in 16-byte chunks
        x2d = x2d.clone()
    plan = q4_plan(R, G, half, d_out, _sm_count(x2d.device), x2d.element_size())
    y = torch.empty((R, d_out), dtype=x2d.dtype, device=x2d.device)
    lib = _library()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.dli_q4_matmul_rows(
            x2d.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x2d.dtype], R, x2d.shape[1], G, half, d_out,
            plan.n_split, plan.gps, plan.stages, stream,
        )
    if rc != 0:
        raise RuntimeError(f"q4_matmul_rows kernel launch failed: CUDA error {rc}")
    q4_matmul_rows.launches += 1
    return y


q4_matmul_rows.launches = 0


def _check(x2d, w):
    """Validate what the kernel takes, from shapes, dtypes, devices and
    alignment alone; returns (R, G, half, out)."""
    R, d_in = x2d.shape
    if not _q4_kernel_ok(R, w) or w.q.shape[0] * w.g != d_in \
            or w.q.shape[1] * 2 != w.g:
        raise ValueError(
            f"q4_matmul_rows takes x [R <= 32, in] and a 3-D packed slice "
            f"with g/2 % 32 == 0 and out % 128 == 0; got x {tuple(x2d.shape)}, {w}"
        )
    G, half, d_out = w.q.shape
    if x2d.dtype not in _DTYPE_CODES or w.q.dtype != torch.int8 \
            or w.s.dtype != torch.float32 or tuple(w.s.shape) != (G, d_out):
        raise TypeError(
            f"q4_matmul_rows takes float32/bfloat16/float16 x, int8 q and "
            f"fp32 s [G, out]; got {x2d.dtype}, {w}"
        )
    for name, t in (("x", x2d), ("q", w.q), ("s", w.s)):
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"q4_matmul_rows: {name} must be contiguous on {x2d.device}")
    # the kernel copies q and s in 16-byte chunks
    if w.q.data_ptr() % 16 or w.s.data_ptr() % 16:
        raise ValueError("q4_matmul_rows: q and s must be 16-byte aligned")
    return R, G, half, d_out


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor, a QTensor or a Q4Tensor."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.s.to(x.dtype)
    if isinstance(w, Q4Tensor):
        lead = x.shape[:-1]
        R = 1
        for d in lead:
            R *= d
        if _q4_kernel_ok(R, w):
            y = q4_matmul_rows(x.reshape(R, x.shape[-1]).contiguous(), w)
            return y.reshape(*lead, y.shape[-1])
        q = _unpack_int4(w.q).to(x.dtype)  # [G, g, out]
        G, g = q.shape[-3], q.shape[-2]
        xr = x.reshape(*lead, G, g)
        partial = torch.einsum("...gi,gio->...go", xr, q)
        return (partial * w.s.to(x.dtype)).sum(dim=-2)
    return x @ w


def _bank_product(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The MoE FFN's two contractions as batched products over the expert
    axis, reading the bank [E, in, out] where it lies: torch.einsum would
    first copy the gate / up banks into a [d, e * f] layout (three times
    the bank's bytes a call)."""
    if spec == "btd,edf->btef":
        B, T, D = x.shape
        y = torch.matmul(x.reshape(1, B * T, D), w)  # [E, BT, F]
        return y.transpose(0, 1).reshape(B, T, *y.shape[::2])
    if spec == "btef,efd->bted":
        B, T, E, F = x.shape
        y = torch.matmul(x.reshape(B * T, E, F).transpose(0, 1), w)  # [E, BT, D]
        return y.transpose(0, 1).reshape(B, T, E, y.shape[-1])
    raise ValueError(f"expert_einsum: no product for spec {spec!r}")


def expert_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum over an expert bank, dense or an int8 QTensor. The spec's
    OUTPUT keeps the scale's axes, so the per-(expert, out-channel) scale
    s [E, out] multiplies the result elementwise, which commutes with the
    contraction: 'btd,edf->btef' (gate / up) and 'btef,efd->bted' (down)."""
    if isinstance(w, QTensor):
        return _bank_product(spec, x, w.q.to(x.dtype)) * w.s.to(x.dtype)
    return _bank_product(spec, x, w)


def _quantize_bank(w: torch.Tensor) -> QTensor:
    """quantize_tensor of an expert bank [L, E, in, out], one layer slice
    at a time: the scales are per (layer, expert, out-channel), so the
    values equal a whole-leaf quantize, and no fp32 copy of the whole bank
    is made."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*w.shape[:-2], w.shape[-1]), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        t = quantize_tensor(w[i])
        q[i], s[i] = t.q, t.s
    return QTensor(q, s)


def quantize_params(cfg: ModelConfig, params: dict, mode: str = None,
                    group: int = 64) -> dict:
    """Quantize the matmul weights of a parameter dictionary (both
    families): the stacked per-layer projections and, when untied, the LM
    head; embed, norms and biases stay. mode: "int8" or "int4" (default
    cfg.quant, then "int8"). An MoE expert bank becomes int8 only under
    int8 and stays dense under int4. Already-quantized leaves are left as
    they are."""
    if cfg.arch not in _QUANT_KEYS:
        raise NotImplementedError(
            f"weight-only quantization is wired for "
            f"{sorted(_QUANT_KEYS)}; got arch={cfg.arch!r}"
        )
    mode = mode or cfg.quant or "int8"
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    if mode == "int8":
        qfn = quantize_tensor
    else:
        qfn = functools.partial(quantize_tensor4, group=group)
    out = dict(params)
    layers = dict(params["layers"])
    for k in _QUANT_KEYS[cfg.arch]:
        if k not in layers or isinstance(layers[k], (QTensor, Q4Tensor)):
            continue
        if layers[k].dim() == 3:
            layers[k] = qfn(layers[k])
        elif layers[k].dim() == 4 and mode == "int8":
            layers[k] = _quantize_bank(layers[k])
    out["layers"] = layers
    if "lm_head" in params and not isinstance(params["lm_head"], (QTensor, Q4Tensor)):
        out["lm_head"] = qfn(params["lm_head"])
    return out
