"""PyTorch port vs JAX package: `flash_attend_slots`, T=1 decode over the
dense slot-fleet cache.

The port's plain twin (what the wrapper runs on CPU tensors) against the
Pallas kernel in interpret mode on the same numpy inputs, at the JAX
test's shapes (tests/test_paged.py: B=3, H=8, KV=2, Dh=16, S=44 — not a
multiple of the 16-key tile —, pos 0 / 17 / 43), full causal and a
13-key window: fp32 within atol = rtol = 2e-5, bf16 within 1e-2 (the
JAX kernel rounds its fp32 result to bf16 once, the twin likewise). A
finished slot frozen at pos = S attends all S keys, as in the JAX
kernel. The wrapper's launch half runs against a stand-in library that
checks every argument against the declared C signature (the CPU never
runs that half otherwise). The CUDA kernel splits each row's live key
range over `_slots_splits` blocks and merges their partials in a fixed
order: that arithmetic, emulated here in fp32 torch, matches the twin
within atol 2e-6 at split edges, with windows that cross them and with
pos in {0, S-1, S, 2S}."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops import paged_attention as JA  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as PA  # noqa: E402

B, H, KV, DH, S = 3, 8, 2, 16, 44
BLOCK_K = 16
ATOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _inputs(seed, dtype_name, pos):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    ck = rng.standard_normal((B, KV, S, DH)).astype(np.float32)
    cv = rng.standard_normal((B, KV, S, DH)).astype(np.float32)
    dt_j = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    dt_t = getattr(torch, dtype_name)
    jax_in = [jnp.asarray(a).astype(dt_j) for a in (q, ck, cv)]
    # bf16 through the same rounding on both sides: JAX's cast, read back
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt_t)
                for a in jax_in]
    pos = np.asarray(pos, np.int32)
    return jax_in + [jnp.asarray(pos)], torch_in + [torch.from_numpy(pos)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("pos", [[0, 17, S - 1], [S, 30, S]], ids=["live", "at_S"])
def test_slots_twin_matches_pallas_kernel(dtype_name, window, pos):
    jin, tin = _inputs(5, dtype_name, pos)
    want = JA.flash_attend_slots(*jin, block_k=BLOCK_K, window=window,
                                 interpret=True)
    got = PA.flash_attend_slots(*tin, block_k=BLOCK_K, window=window)
    assert got.shape == (B, 1, H, DH) and got.dtype == tin[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL[dtype_name], rtol=ATOL[dtype_name])


def test_slots_twin_is_attend_with_the_slot_mask_and_ignores_block_k():
    """The twin is ops/attention.attend over slot_causal_mask; a row at
    pos >= S attends every key, and block_k does not change the result."""
    from distributed_llm_inference_tpu_torch.ops.attention import attend

    _, (q, ck, cv, _) = _inputs(6, "float32", [0, 0, 0])
    pos = torch.tensor([S, 5, 2 * S], dtype=torch.int32)
    got = PA.flash_attend_slots(q, ck, cv, pos, block_k=8)
    assert torch.equal(got, PA.flash_attend_slots_plain(q, ck, cv, pos, block_k=32))
    full = attend(q[:1], ck[:1], cv[:1], torch.ones(1, 1, S, dtype=torch.bool))
    torch.testing.assert_close(got[:1], full, atol=2e-6, rtol=0)
    torch.testing.assert_close(got[2:], attend(q[2:], ck[2:], cv[2:],
                                               torch.ones(1, 1, S, dtype=torch.bool)),
                               atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="window"):
        PA.flash_attend_slots(q, ck, cv, pos, window=0)


def test_wrapper_launch_half_matches_the_c_signature(monkeypatch):
    from test_torch_kv_quant import _StandInLibrary

    lib = _StandInLibrary(PA.SIGNATURES)
    monkeypatch.setattr(PA, "resolve_kernel", lambda device: True)
    monkeypatch.setattr(PA, "_slots_library", lambda: lib)
    monkeypatch.setattr(PA, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    _, (q, ck, cv, pos) = _inputs(7, "bfloat16", [0, 17, S - 1])
    before = PA.flash_attend_slots.launches
    for window in (None, 13):
        out = PA.flash_attend_slots(q, ck, cv, pos, block_k=BLOCK_K, window=window)
        assert out.shape == q.shape and out.dtype == q.dtype
        name, args = lib.calls[-1]
        assert name == "dli_flash_attend_slots"
        assert len(args) == len(PA.SIGNATURES["dli_flash_attend_slots"])
        # q, k, v, out and the workspace, then dtype code, B, H, KV, S, Dh,
        # pos, the window, the fixed scale and the split count
        assert all(isinstance(a, int) for a in args[:5])
        assert args[5:11] == (1, B, H, KV, S, DH)
        assert args[12] == (13 if window else -1)
        assert args[13] == pytest.approx(DH ** -0.5)
        assert args[14] == PA._slots_splits(B, KV, S, 132)
    assert PA.flash_attend_slots.launches == before + 2
    with pytest.raises(ValueError, match="int32"):
        PA.flash_attend_slots(q, ck, cv, pos.long())
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant, quantize_chunk

    with pytest.raises(TypeError, match="raw cache"):
        PA.flash_attend_slots(q, KVQuant(*quantize_chunk(ck)),
                              KVQuant(*quantize_chunk(cv)), pos)
    assert PA.flash_attend_slots.launches == before + 2


@pytest.mark.parametrize("B_, KV_, S_", [
    (1, 4, 8192), (8, 4, 8192), (32, 4, 8192), (8, 4, 1024), (8, 4, 1000),
    (3, 2, 44), (64, 8, 4096), (1, 1, 1),
])
def test_slots_splits_fill_the_card_within_the_cache(B_, KV_, S_):
    """At least one split and at most one per 64-key tile of the cache; a
    function of its arguments alone; and B * KV * n_split >= 2 x SMs
    wherever the cache has tiles enough."""
    tiles = -(-S_ // PA.SLOTS_TILE)
    for sm in (1, 78, 108, 132):
        n = PA._slots_splits(B_, KV_, S_, sm)
        assert 1 <= n <= tiles
        assert n == PA._slots_splits(B_, KV_, S_, sm)
        assert B_ * KV_ * n >= 2 * sm or n == tiles
    # bench.py's fleet leg on an H100's 132 SMs: 32 (row, KV head) pairs
    assert PA._slots_splits(8, 4, 8192, 132) == 9


def _split_and_merge(q, ck, cv, pos, window, n_split, tile=PA.SLOTS_TILE):
    """The slots kernel's arithmetic in fp32 torch: row b's live range
    [lo, hi) in tiles of `tile` keys on the tile grid from key 0 (the edge
    tiles cut to the range), split s taking tiles
    [s * n // n_split, (s + 1) * n // n_split); a partial (m, l, acc) per
    split by an online softmax over its tiles (an empty share is m = NEG,
    l = 0); the splits merged in index order with the log-sum-exp
    rescale; a row with no live key gives zeros."""
    B_, _, H_, Dh = q.shape
    KV_, S_ = ck.shape[1], ck.shape[2]
    group = H_ // KV_
    neg = torch.tensor(-0.7 * torch.finfo(torch.float32).max)
    out = torch.zeros(B_, 1, H_, Dh)
    for b in range(B_):
        p = int(pos[b])
        hi = S_ if p >= S_ else p + 1
        lo = max(p - window + 1, 0) if window else 0
        base = lo - lo % tile
        n_tiles = (hi - 1 - base) // tile + 1 if hi > lo else 0
        for kvh in range(KV_):
            heads = slice(kvh * group, (kvh + 1) * group)
            qh = q[b, 0, heads].float()
            parts = []
            for s in range(n_split):
                m = neg.expand(group).clone()
                lsum, acc = torch.zeros(group), torch.zeros(group, Dh)
                for t in range(s * n_tiles // n_split, (s + 1) * n_tiles // n_split):
                    p0 = max(base + t * tile, lo)
                    p1 = min(base + (t + 1) * tile, hi)
                    sc = qh @ ck[b, kvh, p0:p1].float().T * Dh ** -0.5
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    pr = torch.exp(sc - m_new[:, None])
                    lsum = lsum * alpha + pr.sum(-1)
                    acc = acc * alpha[:, None] + pr @ cv[b, kvh, p0:p1].float()
                    m = m_new
                parts.append((m, lsum, acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            lsum, acc = torch.zeros(group), torch.zeros(group, Dh)
            for m, pl, pa in parts:
                e = torch.exp(m - mx)
                lsum = lsum + pl * e
                acc = acc + pa * e[:, None]
            live = lsum > 0
            out[b, 0, heads] = torch.where(live[:, None],
                                           acc / torch.where(live, lsum, 1.0)[:, None], 0.0)
    return out


SPLIT_S = 300  # five 64-key tiles, the last one ragged
# tile and split edges from lo = 0, the last position, a slot frozen at S
# and one past it
SPLIT_POS = [0, 1, 63, 64, 65, 127, 128, 191, 192, SPLIT_S - 1, SPLIT_S, 2 * SPLIT_S]


@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
@pytest.mark.parametrize("window", [None, 13, 64, 100])
def test_split_and_merge_matches_the_twin_at_split_edges(n_split, window):
    """The kernel's split-KV walk and fixed-order merge give the twin's
    function: windows of 13, 64 and 100 keys start the live range off the
    64-key grid (masked edge tiles) and move it across the splits. A window
    that ends before S (pos 2S) leaves no live key: zeros there, as in the
    kernels."""
    rng = np.random.default_rng(11)
    Bn = len(SPLIT_POS)
    q = torch.from_numpy(rng.standard_normal((Bn, 1, H, DH)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((Bn, KV, SPLIT_S, DH)).astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((Bn, KV, SPLIT_S, DH)).astype(np.float32))
    pos = torch.tensor(SPLIT_POS, dtype=torch.int32)
    got = _split_and_merge(q, ck, cv, pos, window, n_split)
    want = PA.flash_attend_slots(q, ck, cv, pos, window=window)
    dead = torch.tensor([bool(window) and p - window + 1 >= SPLIT_S for p in SPLIT_POS])
    assert dead.any() == bool(window)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    torch.testing.assert_close(got[~dead], want[~dead], atol=2e-6, rtol=0)


def test_split_and_merge_gives_zeros_for_a_row_with_no_live_key():
    """pos = -1: every split is empty and the merge writes zeros, as the
    CUDA and TPU kernels do; the twin attends the mean of V there (its
    docstring), a row the fleet never has."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((2, 1, H, DH)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((2, KV, SPLIT_S, DH)).astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((2, KV, SPLIT_S, DH)).astype(np.float32))
    pos = torch.tensor([-1, 70], dtype=torch.int32)
    for n_split in (1, 3):
        got = _split_and_merge(q, ck, cv, pos, None, n_split)
        assert torch.equal(got[0], torch.zeros(1, H, DH))
        twin = PA.flash_attend_slots(q, ck, cv, pos)
        torch.testing.assert_close(got[1], twin[1], atol=2e-6, rtol=0)
        torch.testing.assert_close(twin[0, 0], cv[0].mean(1).repeat_interleave(H // KV, 0),
                                   atol=2e-6, rtol=0)
