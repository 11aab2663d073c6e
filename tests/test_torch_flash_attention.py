"""The flash kernel's plain twin vs the JAX package's Pallas `flash_attend`
(interpret mode on the CPU, as tests/conftest.py sets it), and the CUDA
kernel's launch plan and order of work vs the twin. The CUDA kernel vs
its twin on the card is in test_torch_cuda.py.

CPU tolerances: the twin vs JAX rtol 1e-5, atol 2e-5 — that of
tests/test_flash_attention.py (fp32, summation order differs between a
tiled online softmax and one dense softmax). The kernel's order emulated
in fp32 vs the twin: atol 2e-6 (the same products, summed in another
order, with exp2 in place of exp); with P rounded to bf16 as the tensor
cores take it: 2^-8 max|v| (each probability moves by <= 2^-9 of
itself)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops.flash_attention import flash_attend as jax_flash  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _inputs(seed, B, T, H, KV, Dh, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, S, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, S, Dh)).astype(np.float32))


# (B, T, H, KV, Dh, S, pos, valid_start, window, window_dyn, scale, softcap)
CASES = [
    (1, 16, 8, 2, 16, 64, 0, None, None, None, None, None),  # prefill at 0
    (2, 9, 4, 2, 8, 48, 13, None, None, None, None, None),  # chunk mid-sequence
    (2, 12, 4, 2, 8, 32, 4, [0, 6], None, None, None, None),  # left-padded rows
    (1, 20, 4, 1, 8, 64, 10, None, 7, None, None, None),  # static window
    (1, 20, 4, 2, 8, 64, 10, None, None, 6, None, None),  # per-layer window
    (1, 20, 4, 2, 8, 64, 10, None, None, -1, None, None),  # per-layer full
    (2, 8, 6, 3, 24, 40, 3, [2, 0], 5, None, 0.3, 20.0),  # all variants at once
]


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax_kernel(case):
    B, T, H, KV, Dh, S, pos, vs, window, wdyn, scale, softcap = case
    q, ck, cv = _inputs(B * 100 + T, B, T, H, KV, Dh, S)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        None if vs is None else jnp.asarray(vs, jnp.int32),
        None if wdyn is None else jnp.int32(wdyn),
        block_t=4, block_k=16, window=window, scale=scale, softcap=softcap,
    )
    got = fa.flash_attend(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), pos,
        None if vs is None else torch.tensor(vs, dtype=torch.int32),
        None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32),
        window=window, scale=scale, softcap=softcap,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_runs_twin_and_counts_no_launch():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 4, 2, 8, 16))
    before = fa.flash_attend.launches
    out = fa.flash_attend(q, ck, cv, 2)
    assert torch.equal(out, fa.flash_attend_plain(q, ck, cv, 2))
    assert fa.flash_attend.launches == before
    assert fa.resolve_kernel("cpu") is False
    assert fa.resolve_kernel("cuda") is True
    with pytest.raises(ValueError):
        fa.resolve_kernel("meta")
    # an int8 cache is KVQuant leaves (test_torch_kv_quant.py); a bare
    # int8 tensor has no scales
    with pytest.raises(TypeError, match="KVQuant"):
        fa.flash_attend(q, ck.to(torch.int8), cv.to(torch.int8), 2)


# -- the CUDA kernel's plan and order of work, on the CPU ---------------------------
#
# The kernel (csrc/flash_attention.cu) runs only on the card. Its launch
# plan (`flash_plan`) and its arithmetic are held here: each block owns
# FLASH_ROWS folded query rows (row = t * group + g) of one (batch row, KV
# head) and walks the live key tiles [first, needed) of those rows; a
# cluster's ranks take even shares of them, and the ranks' partials
# (m, l, acc) merge in rank order. The softmax runs in base 2.


def _block_tiles(T, group, S, bn, pos, win, vfrom, row0, rows=fa.FLASH_ROWS):
    """The kernel's live tile range [first, needed) of the block at row0."""
    t_lo = row0 // group
    t_hi = min((row0 + rows - 1) // group, T - 1)
    needed = min((pos + t_hi + 1 + bn - 1) // bn, -(-S // bn))
    first = max(pos + t_lo - win + 1, 0) // bn if win > 0 else 0
    return max(first, vfrom // bn), needed


def _shares(first, needed, cluster):
    """Rank r's tiles: [first + r n / c, first + (r + 1) n / c)."""
    n = max(needed - first, 0)
    return [range(first + r * n // cluster, first + (r + 1) * n // cluster)
            for r in range(cluster)]


def _live(T, S, pos, win, vfrom, t):
    """Query t's live key positions."""
    q_pos = pos + t
    lo = max(vfrom, q_pos - win + 1 if win > 0 else 0)
    return range(lo, min(q_pos, S - 1) + 1)


PLAN_T = [1, 64, 100, 128, 2048]


@pytest.mark.parametrize("sm_count", [132, 4])
@pytest.mark.parametrize("T", PLAN_T)
@pytest.mark.parametrize("group", [4, 8, 12])
def test_flash_plan_covers_every_row_and_live_tile_once(T, group, sm_count):
    KV, Dh, S = 4, 64, 2048
    H = KV * group
    for esize, kv_esize in ((2, 2), (2, 1), (4, 4), (4, 1)):
        for pos in sorted({0, 300, S - T}):
            p = fa.flash_plan(1, T, H, KV, S, Dh, sm_count, esize, kv_esize, pos)
            assert p.rows == fa.FLASH_ROWS and p.bn in (32, 64) and p.stages in (2, 3)
            # each rank keeps two live tiles of the last query, or no split
            live = -(-(pos + T) // p.bn)
            assert p.cluster in (1, 2, 4, 8) and (p.cluster == 1 or 2 * p.cluster <= live)
            assert p.row_tiles * p.rows >= T * group > (p.row_tiles - 1) * p.rows
            assert p.blocks == p.row_tiles * KV * p.cluster
            for win, vfrom in ((0, 0), (13, 0), (64, 0), (100, 37), (0, pos + T)):
                for tile in range(p.row_tiles):
                    row0 = tile * p.rows
                    first, needed = _block_tiles(T, group, S, p.bn, pos, win, vfrom, row0)
                    for cluster in (1, 2, 4, 8):  # the walk holds for any cluster
                        walked = [j for r in _shares(first, needed, cluster) for j in r]
                        assert walked == list(range(first, max(first, needed)))  # once each
                    for r in range(row0, min(row0 + p.rows, T * group)):
                        live = _live(T, S, pos, win, vfrom, r // group)
                        if len(live):  # a contiguous range: its two ends
                            assert first <= live[0] // p.bn, (tile, r)
                            assert live[-1] // p.bn < needed, (tile, r)


# the solo engine's chunks (T, pos) and the cluster flash_plan gives each on
# an H100: the sizes that `chip_smoke.py --only b` measured fastest or
# within 1 us of it (a one- or two-tile chunk runs faster unsplit)
SOLO_PLANS = {(64, 0): 1, (64, 640): 4, (128, 0): 1, (128, 128): 2, (128, 256): 2,
              (128, 384): 4, (128, 512): 4}


@pytest.mark.parametrize("T,pos", sorted(SOLO_PLANS))
def test_flash_plan_at_the_solo_chunks(T, pos):
    """tinyllama's solo chunks on 132 SMs: the cluster grows until the
    blocks cover the card or a rank would keep fewer than two of the
    last query's live tiles; a block's serial chain is then at most three
    tiles (it was up to eleven unsplit)."""
    for kv_esize in (2, 1):
        p = fa.flash_plan(1, T, 32, 4, 2048, 64, 132, 2, kv_esize, pos)
        assert p.cluster == SOLO_PLANS[T, pos]
        live = -(-(pos + T) // p.bn)
        assert p.blocks >= 132 or p.cluster == 8 or 4 * p.cluster > live
        first, needed = _block_tiles(T, 8, 2048, p.bn, pos, 0, 0, (p.row_tiles - 1) * 64)
        assert max(len(r) for r in _shares(first, needed, p.cluster)) <= 3
    # a full prefill chunk fills the card without a cluster; so does a
    # batch of four 512-token chunks; four SMs need none
    assert fa.flash_plan(1, 2048, 32, 4, 2048, 64, 132, pos=0).cluster == 1
    assert fa.flash_plan(4, 512, 32, 4, 2048, 64, 132, pos=700).cluster == 1
    assert fa.flash_plan(1, 64, 32, 4, 2048, 64, 4, pos=640).cluster == 1
    # with no position the chunk is taken to end at S: the card decides
    assert fa.flash_plan(1, 64, 32, 4, 2048, 64, 132).cluster == 8


def _kernel_order(q, k, v, pos, vs, win, scale, softcap, bn, cluster, round_p):
    """The kernel's arithmetic in fp32 torch, block by block: for each
    rank of the cluster, its share of the block's live tiles in order with
    an online softmax in base 2 (scores scaled, soft-capped, times log2 e,
    masked); P rounded to bf16 before the P V product where `round_p`
    (the tensor-core path; l takes the fp32 P); the ranks merged in order
    0, 1, ... with weights 2^(m_k - max m); a cluster of one divides its
    own acc by l. A row with no live key gives zeros."""
    B_, T, H_, Dh = q.shape
    KV_, S_ = k.shape[1], k.shape[2]
    group = H_ // KV_
    rows_total = T * group
    neg = -0.7 * torch.finfo(torch.float32).max
    log2e = 1.4426950408889634
    out = torch.zeros(B_, T, H_, Dh)
    for b in range(B_):
        vfrom = int(vs[b]) if vs is not None else 0
        for kvh in range(KV_):
            qh = q[b, :, kvh * group:(kvh + 1) * group].reshape(rows_total, Dh).float()
            for row0 in range(0, rows_total, fa.FLASH_ROWS):
                rows = torch.arange(row0, min(row0 + fa.FLASH_ROWS, rows_total))
                qp = pos + rows // group
                lo = torch.clamp(qp - win + 1, min=0) if win > 0 else torch.zeros_like(qp)
                lo = torch.clamp(lo, min=vfrom)
                first, needed = _block_tiles(T, group, S_, bn, pos, win, vfrom, row0)
                parts = []
                for share in _shares(first, needed, cluster):
                    m = torch.full((len(rows),), neg)
                    lsum = torch.zeros(len(rows))
                    acc = torch.zeros(len(rows), Dh)
                    for j in share:
                        kp = torch.arange(j * bn, min((j + 1) * bn, S_))
                        x = qh[rows] @ k[b, kvh, kp].float().T * scale
                        if softcap is not None:
                            x = softcap * torch.tanh(x / softcap)
                        x = x * log2e
                        live = (kp[None] >= lo[:, None]) & (kp[None] <= qp[:, None])
                        x = torch.where(live, x, torch.tensor(neg))
                        m_new = torch.maximum(m, x.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.where(live, torch.exp2(x - m_new[:, None]), 0.0)
                        lsum = lsum * alpha + p.sum(-1)
                        pv = p.to(torch.bfloat16).float() if round_p else p
                        acc = acc * alpha[:, None] + pv @ v[b, kvh, kp].float()
                        m = m_new
                    parts.append((m, lsum, acc))
                if cluster == 1:
                    m, lsum, acc = parts[0]
                    o = acc / torch.where(lsum == 0, 1.0, lsum)[:, None]
                else:
                    mx = torch.stack([p_[0] for p_ in parts]).amax(0)
                    lsum, acc = torch.zeros(len(rows)), torch.zeros(len(rows), Dh)
                    for m, pl, pa in parts:
                        e = torch.exp2(m - mx)
                        lsum = lsum + pl * e
                        acc = acc + pa * e[:, None]
                    o = torch.where(lsum[:, None] == 0, 0.0,
                                    acc / torch.where(lsum == 0, 1.0, lsum)[:, None])
                out[b, rows // group, kvh * group + rows % group] = o
    return out


# window 0 = full causal; valid_start rows: none, a tile edge (64), inside a
# tile, and past the chunk (that row has no live key: zeros)
ORDER_S, ORDER_POS = 300, [0, 63, 70, 236]
ORDER_VS = [0, 64, 5, 299]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [0, 13, 64, 100])
def test_kernel_order_emulated_matches_the_twin_at_split_edges(cluster, window):
    """The fp32 path's order (P stays fp32) against the twin at atol 2e-6,
    at positions and windows that put the live range's ends on and off
    the 64-key tiles and the ranks' share edges; group 4, T * group off
    the 64-row tile; softcap and scale on one case each. Row 3's
    valid_start lies past every query: zeros."""
    rng = np.random.default_rng(21 + window + cluster)
    B_, T, H_, KV_, Dh = 4, 17, 8, 2, 16
    q = torch.from_numpy(rng.standard_normal((B_, T, H_, Dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B_, KV_, ORDER_S, Dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B_, KV_, ORDER_S, Dh)).astype(np.float32))
    vs = torch.tensor(ORDER_VS, dtype=torch.int32)
    for i, pos in enumerate(ORDER_POS + [ORDER_S - T]):
        scale, softcap = (0.3, None) if i == 1 else (None, 20.0) if i == 2 else (None, None)
        sc = Dh ** -0.5 if scale is None else scale
        got = _kernel_order(q, k, v, pos, vs, window, sc, softcap, 64, cluster, False)
        want = fa.flash_attend_plain(q, k, v, pos, vs, window=window or None,
                                     scale=scale, softcap=softcap)
        dead = vs.long() > pos + T - 1
        assert torch.equal(got[dead], torch.zeros_like(got[dead]))
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("cluster", [1, 4])
def test_kernel_order_with_bf16_p_stays_within_its_rounding(cluster):
    """The tensor-core path rounds P to bf16 for the P V product (l keeps
    the fp32 P): each term moves by <= 2^-9 of itself, so the output moves
    by <= 2^-9 max|v|; held here at 2^-8 max|v| on bf16-valued inputs."""
    rng = np.random.default_rng(31)
    B_, T, H_, KV_, Dh = 2, 40, 8, 2, 16
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()  # noqa: E731
    q = bf(rng.standard_normal((B_, T, H_, Dh)))
    k = bf(rng.standard_normal((B_, KV_, ORDER_S, Dh)))
    v = bf(rng.standard_normal((B_, KV_, ORDER_S, Dh)))
    vs = torch.tensor([0, 64], dtype=torch.int32)
    for pos, window in ((0, 0), (200, 0), (200, 37)):
        got = _kernel_order(q, k, v, pos, vs, window, Dh ** -0.5, None, 64, cluster, True)
        want = fa.flash_attend_plain(q, k, v, pos, vs, window=window or None)
        err = (got - want).abs().max().item()
        assert err <= 2 ** -8 * v.abs().max().item(), (pos, window, err)
        assert err > 0  # the rounding is there


def test_wrapper_launch_half_matches_the_c_signature(monkeypatch):
    """The launch half against a stand-in library that checks every
    argument against the declared C signature: the plan's bn, stages and
    cluster follow softcap, in positions 19-21."""
    import contextlib

    from test_torch_kv_quant import _StandInLibrary

    lib = _StandInLibrary(fa.SIGNATURES)
    monkeypatch.setattr(fa, "resolve_kernel", lambda device: True)
    monkeypatch.setattr(fa, "_library", lambda: lib)
    monkeypatch.setattr(fa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    q = torch.randn(1, 64, 32, 64, dtype=torch.bfloat16)
    ck = torch.randn(1, 4, 2048, 64, dtype=torch.bfloat16)
    vs = torch.zeros(1, dtype=torch.int32)
    wd = torch.tensor([256], dtype=torch.int32)
    before = fa.flash_attend.launches
    out = fa.flash_attend(q, ck, ck, 640, vs, wd, softcap=30.0, scale=0.2)
    assert out.shape == q.shape and out.dtype == q.dtype
    name, args = lib.calls[-1]
    assert name == "dli_flash_attend" and len(args) == len(fa.SIGNATURES[name])
    # q, k, v, no scales, out; dtype code, B, T, H, KV, S, Dh, pos
    assert all(isinstance(a, int) for a in args[:3] + args[5:6])
    assert args[3] is None and args[4] is None
    assert args[6:14] == (1, 1, 64, 32, 4, 2048, 64, 640)
    assert isinstance(args[14], int) and args[15] == -1 and isinstance(args[16], int)
    assert args[17] == pytest.approx(0.2) and args[18] == pytest.approx(30.0)
    plan = fa.flash_plan(1, 64, 32, 4, 2048, 64, 132, pos=640)
    assert args[19:22] == (plan.bn, plan.stages, plan.cluster) == (64, 3, 4)
    # no valid_start, a static window, no softcap; a plan passed in
    fa.flash_attend(q, ck, ck, 0, window=100, plan=plan._replace(cluster=2))
    args = lib.calls[-1][1]
    assert args[14] is None and args[15] == 100 and args[16] is None
    assert args[18] == 0.0 and args[21] == 2
    assert fa.flash_attend.launches == before + 2
