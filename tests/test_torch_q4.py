"""q4_matmul_rows' launch plan and arithmetic, on the CPU.

The kernel (csrc/q4_matmul.cu) runs only on the card. Here its grid plan
(`q4_plan`), its order of sums (emulated in fp32 torch) and its nibble
unpacking (the source's own constants, evaluated bit by bit) are held to
the plain twin `q4_matmul_rows_plain`, which tests/test_torch_quant.py
holds to the JAX package's Pallas kernel.

Tolerance: the emulation and the twin take the same exact products (bf16
or fp32 x times a nibble) and differ only in the order of fp32 sums of at
most 5632 terms of size ~1: atol 2e-6."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_llm_inference_tpu_torch.ops import quant as Q  # noqa: E402

SRC = Path(Q.__file__).resolve().parent.parent / "csrc" / "q4_matmul.cu"
# tinyllama's projections (in, out), the LM head last
TINYLLAMA = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
# G = 1 (one column tile), 4, 32 and 88 groups of 64
TEST_SHAPES = [(64, 128), (256, 384), (2048, 256), (5632, 256)]
EMULATION_ATOL = 2e-6


@pytest.mark.parametrize("sm_count", [132, 4])
@pytest.mark.parametrize("d_in,d_out", TINYLLAMA + TEST_SHAPES)
def test_q4_plan_covers_every_group_and_column_tile(d_in, d_out, sm_count):
    G, half = d_in // 64, 32
    for R in (1, 8, 9, 32):
        for esize in (2, 4):
            p = Q.q4_plan(R, G, half, d_out, sm_count, esize)
            assert p.tiles * Q.Q4_TILE == d_out
            assert 1 <= p.n_split <= Q.Q4_MAX_SPLIT
            runs = [range(k * p.gps, min(G, (k + 1) * p.gps)) for k in range(p.n_split)]
            assert all(len(r) for r in runs), (p, G)  # no block without a group
            assert [g for r in runs for g in r] == list(range(G))
            assert 1 <= p.stages <= min(Q.Q4_MAX_STAGES, p.gps * half // Q.Q4_KBLOCK)
            assert p.stages <= 2 or p.stages * Q.q4_stage_bytes(R, esize) <= Q._Q4_RING_BYTES
            # a block of a 2048-input projection requests its whole share at once
            if d_in == 2048 and esize == 2 and R <= 8 and p.n_split == Q.Q4_MAX_SPLIT:
                assert p.stages == p.gps


def test_q4_plan_fills_the_card():
    """Four blocks per SM of an H100 where the groups allow it, every
    block resident at once."""
    for (d_in, d_out) in TINYLLAMA:
        p = Q.q4_plan(8, d_in // 64, 32, d_out, 132, 2)
        assert p.n_split * p.tiles >= min(4 * 132, p.tiles * Q.Q4_MAX_SPLIT), (d_in, d_out, p)
        per_sm = -(-p.n_split * p.tiles // 132)
        block = p.stages * Q.q4_stage_bytes(8, 2) + Q.q4_recv_bytes(8)
        assert per_sm * block <= Q._SM_SHARED_BYTES


def emulate(x, w, plan):
    """The kernel's order of sums in fp32 torch. Per block k of a column
    tile's cluster: its groups in order; per group a fresh sum over its
    packed rows in k-steps of 8, each k-step one 16-term product whose
    k-pairs are (i, i + g/2), the low and the high nibble of packed row i
    (the order inside a k-step is the tensor core's, and the fp32 path
    sums packed row by packed row: both exact products, fp32 sums);
    the group's sum times s, added to the block's total. Then the totals
    summed over the blocks 0, 1, ... (column tiles are independent)."""
    R = x.shape[0]
    G, half, d_out = w.q.shape
    xf = x.float()
    lo = ((w.q << 4) >> 4).float()  # [G, half, out]
    hi = (w.q >> 4).float()
    s = w.s.float()
    y = None
    for k in range(plan.n_split):
        tot = torch.zeros(R, d_out)
        for gi in range(k * plan.gps, min(G, (k + 1) * plan.gps)):
            acc = torch.zeros(R, d_out)
            base = gi * 2 * half
            for i0 in range(0, half, 8):
                i = torch.arange(i0, i0 + 8)
                xs = torch.stack([xf[:, base + i], xf[:, base + half + i]], -1).reshape(R, 16)
                ws = torch.stack([lo[gi, i], hi[gi, i]], 1).reshape(16, d_out)
                acc = acc + xs @ ws
            tot = tot + acc * s[gi]
        y = tot if y is None else y + tot
    return y


@pytest.mark.parametrize("sm_count", [132, 4])
@pytest.mark.parametrize("d_in,d_out,group", [(64, 128, 64), (256, 384, 64),
                                              (2048, 256, 64), (5632, 256, 64),
                                              (1024, 256, 128)])
def test_kernel_order_emulated_matches_the_twin(d_in, d_out, group, sm_count):
    rng = np.random.default_rng(d_in + d_out + sm_count)
    w = Q.quantize_tensor4(torch.from_numpy(
        rng.standard_normal((d_in, d_out), dtype=np.float32) * d_in ** -0.5), group=group)
    G, half = w.q.shape[:2]
    for R in (1, 8, 9, 32):
        x = torch.from_numpy(rng.standard_normal((R, d_in), dtype=np.float32))
        for xv in (x, x.to(torch.bfloat16).float()):  # fp32 x, and bf16 values
            plan = Q.q4_plan(R, G, half, d_out, sm_count, 4)
            got = emulate(xv, w, plan)
            want = Q.q4_matmul_rows_plain(xv, w)
            err = (got - want).abs().max().item()
            assert err <= EMULATION_ATOL, (R, plan, err)


def _const(name):
    m = re.search(rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u?;", SRC.read_text())
    assert m, name
    return int(m.group(1), 16)


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte j of the result is byte
    (sel >> 4j) & 7 of the 8-byte value b:a."""
    src = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros_like(a)
    for j in range(4):
        k = (sel >> (4 * j)) & 7
        byte = (src >> np.uint64(8 * k)) & np.uint64(0xFF)
        out |= (byte.astype(np.uint32) << np.uint32(8 * j))
    return out


def _lop3(a, b, c, lut):
    """PTX lop3.b32: each result bit is bit (4a + 2b + c) of lut."""
    full = np.uint32(0xFFFFFFFF)
    out = np.zeros_like(a)
    for i in range(8):
        if lut >> i & 1:
            out |= ((a if i & 4 else a ^ full) & (b if i & 2 else b ^ full)
                    & (c if i & 1 else c ^ full))
    return out


def test_fp32_nibble_unpacking_of_the_source_is_exact():
    """The fp32 path's `nibble_f32`: lop3 with the source's constants, as
    an fp32 number less the same constant, gives the signed low nibble."""
    bias, lut = _const("NIB_FP32"), _const("NIB_LUT")
    v = np.arange(256, dtype=np.uint32) | (np.uint32(0xABCDE) << np.uint32(8))
    for shift, packed_to_nibble in ((0, lambda p: (p << 4) >> 4), (4, lambda p: p >> 4)):
        r = _lop3(v >> np.uint32(shift), np.full_like(v, 0xF), np.full_like(v, bias), lut)
        offset = float(np.array(bias, np.uint32).view(np.float32))
        got = torch.from_numpy(r.view(np.float32)) - offset
        packed = torch.from_numpy(np.arange(256, dtype=np.uint8).view(np.int8))
        assert torch.equal(got, packed_to_nibble(packed).float()), shift


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_nibble_unpacking_of_the_source_is_exact(dtype):
    """For every byte value at every byte position of a word, the kernel's
    prmt / lop3 / packed-subtract sequence, with the constants of the
    source, gives the byte's two signed nibbles as the fragment's (low,
    high) pair, exactly as the twin unpacks them."""
    rng = np.random.default_rng(0)
    bias = _const("NIB_BF16" if dtype == "bfloat16" else "NIB_FP16")
    mask, lut = _const("NIB_MASK"), _const("NIB_LUT")
    vals = np.arange(256, dtype=np.uint32)
    for K in range(4):
        others = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
        w = (others & ~np.uint32(0xFF << (8 * K))) | (vals << np.uint32(8 * K))
        p = _prmt(w, w >> np.uint32(4), K | ((K + 4) << 8))
        r = _lop3(p, np.full_like(p, mask), np.full_like(p, bias), lut)
        halves = np.stack([r & 0xFFFF, r >> 16], -1).astype(np.uint16)
        num = torch.from_numpy(halves.view(np.int16)).view(getattr(torch, dtype)).float()
        b16 = torch.tensor([bias & 0xFFFF], dtype=torch.int16)
        got = num - b16.view(getattr(torch, dtype)).float()
        packed = torch.from_numpy(vals.astype(np.uint8).view(np.int8))
        want = torch.stack([(packed << 4) >> 4, packed >> 4], -1).float()
        assert torch.equal(got, want), K
