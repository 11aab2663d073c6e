"""PyTorch port vs JAX package: attention over the block-paged KV pool.

The port's plain twins of `ragged_paged_attend` and `paged_flash_attend`
(what the wrappers run on CPU tensors) against the Pallas kernels in
interpret mode, on the same numpy inputs: shuffled block tables, decode
rows, multi-tile and short prefill chunks, launch padding, static and
per-layer windows, softcap and scale. fp32, atol 1e-5 (the two sum in
another order). The host-side launch planners (`build_ragged_meta`,
`build_device_meta`) and the device substitution (`apply_device_meta`)
must equal the JAX package's exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.ops import paged_attention as JA  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as PA  # noqa: E402

ATOL = 1e-5
H, KV, DH, BS, MB, N = 8, 2, 16, 4, 8, 48
TQ = 4

# (kwargs, per-layer window operand): full causal, a static window, a
# per-layer width, a per-layer "no window" (<= 0), softcap, scale
VARIANTS = [({}, None), ({"window": 5}, None), ({}, 3), ({}, -1),
            ({"softcap": 3.0}, None), ({"scale": 0.2}, None)]
VARIANT_IDS = ["causal", "window", "window_dyn", "window_dyn_off", "softcap",
               "scale"]

# per-tile (row, q_start, q_len, kind): two decode rows (one at 0, one deep
# in its table), a 10-token chunk at 13 over three tiles (the last short),
# a 3-token prefill row, then two pad tiles that repeat their predecessor
META = np.array([
    (0, 0, 1, PA.RAGGED_DECODE), (1, 29, 1, PA.RAGGED_DECODE),
    (2, 13, 4, PA.RAGGED_PREFILL), (2, 17, 4, PA.RAGGED_PREFILL),
    (2, 21, 2, PA.RAGGED_PREFILL), (3, 0, 3, PA.RAGGED_PREFILL),
    (3, 0, 0, PA.RAGGED_PREFILL), (3, 0, 0, PA.RAGGED_PREFILL),
], np.int32)


def _pool(seed, rows):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((N, KV, BS, DH)).astype(np.float32)
    pv = rng.standard_normal((N, KV, BS, DH)).astype(np.float32)
    # shuffled physical blocks 1..N-1 (0 is the trash block)
    table = (rng.permutation(N - 1)[: rows * MB] + 1).reshape(rows, MB)
    return rng, pk, pv, table.astype(np.int32)


def _window(wd):
    if wd is None:
        return None, None
    return jnp.array([wd], jnp.int32), torch.tensor([wd], dtype=torch.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_ragged_twin_matches_pallas_kernel(kw, wd):
    rng, pk, pv, table = _pool(0, 4)
    q = rng.standard_normal((META.shape[0] * TQ, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(JA.ragged_paged_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(META), wdj, interpret=True, **kw))
    got = PA.ragged_paged_attend(*_t(q, pk, pv, table, META), wdt, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # launch padding and the rows past a tile's q_len are zeros, as the
    # Pallas kernel writes them
    out = got.numpy().reshape(META.shape[0], TQ, H, DH)
    for g, (_, _, q_len, _) in enumerate(META):
        assert not out[g, q_len:].any()


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_paged_decode_twin_matches_pallas_kernel(kw, wd):
    rng, pk, pv, table = _pool(1, 5)
    # positions at a block's first and last slot, mid-table and at the end
    pos = np.array([0, 3, 4, 17, MB * BS - 1], np.int32)
    q = rng.standard_normal((5, 1, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(JA.paged_flash_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(pos), wdj, interpret=True, **kw))
    got = PA.paged_flash_attend(*_t(q, pk, pv, table, pos), wdt, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_wrappers_on_cpu_run_the_twins_and_count_no_launch():
    rng, pk, pv, table = _pool(2, 4)
    q = rng.standard_normal((META.shape[0] * TQ, H, DH)).astype(np.float32)
    r0, p0 = PA.ragged_paged_attend.launches, PA.paged_flash_attend.launches
    a = PA.ragged_paged_attend(*_t(q, pk, pv, table, META))
    b = PA.ragged_paged_attend_plain(*_t(q, pk, pv, table, META))
    assert torch.equal(a, b)
    pos = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    qd = torch.from_numpy(q[:4, None])
    assert torch.equal(
        PA.paged_flash_attend(qd, *_t(pk, pv, table), pos),
        PA.paged_flash_attend_plain(qd, *_t(pk, pv, table), pos))
    assert (PA.ragged_paged_attend.launches, PA.paged_flash_attend.launches) == (r0, p0)


@pytest.mark.parametrize("fn", ["ragged_paged_attend", "paged_flash_attend"])
def test_int8_pool_raises_not_implemented(fn):
    """An int8 pool is ops/kv_quant.KVQuant leaves (data and scales; held
    to the JAX kernels in test_torch_kv_quant.py): a bare int8 tensor,
    which has no scales, is refused by the wrapper and its twin."""
    pool = torch.zeros((N, KV, BS, DH), dtype=torch.int8)
    table = torch.ones((4, MB), dtype=torch.int32)
    if fn == "ragged_paged_attend":
        args = (torch.zeros((META.shape[0] * TQ, H, DH)), pool, pool, table,
                torch.from_numpy(META))
    else:
        args = (torch.zeros((4, 1, H, DH)), pool, pool, table,
                torch.zeros((4,), dtype=torch.int32))
    for f in (getattr(PA, fn), getattr(PA, fn + "_plain")):
        with pytest.raises(TypeError, match="KVQuant"):
            f(*args)


# launch entries (row, start, length, kind), every one on a tile boundary
ENTRY_CASES = {
    "decode_and_chunks": [(0, 7, 1, P.RAGGED_DECODE), (2, 30, 1, P.RAGGED_DECODE),
                          (1, 0, 19, P.RAGGED_PREFILL), (3, 8, 5, P.RAGGED_PREFILL)],
    "one_full_chunk": [(4, 64, 32, P.RAGGED_PREFILL)],
    "decode_only": [(b, 3 * b, 1, P.RAGGED_DECODE) for b in range(5)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_launch_planners_equal_jax(name):
    entries = ENTRY_CASES[name]
    W, tile = 64, 8
    got = P.build_ragged_meta(entries, width=W, tile=tile)
    want = JP.build_ragged_meta(entries, width=W, tile=tile)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == list(want[3]) and got[4] == want[4]
    offsets = got[3]
    for n_dev in range(len(entries) + 1):
        d_got = P.build_device_meta(entries, offsets, n_dev, width=W, tile=tile)
        d_want = JP.build_device_meta(entries, offsets, n_dev, width=W, tile=tile)
        for g, w in zip(d_got, d_want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype


def test_launch_planner_rejects_what_jax_rejects():
    for entries, kw in (([(0, 0, 9, P.RAGGED_PREFILL)], dict(width=8, tile=8)),
                        ([(0, 0, 0, P.RAGGED_PREFILL)], dict(width=8, tile=8)),
                        ([], dict(width=12, tile=8))):
        with pytest.raises(ValueError):
            JP.build_ragged_meta(entries, **kw)
        with pytest.raises(ValueError):
            P.build_ragged_meta(entries, **kw)


def test_apply_device_meta_equals_jax():
    entries = ENTRY_CASES["decode_and_chunks"]
    W, tile = 64, 8
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(
        entries, width=W, tile=tile)
    dev = P.build_device_meta(entries, offsets, 2, width=W, tile=tile)
    pos = np.array([11, 5, 40, 9, 0], np.int32)  # the slots' device positions
    m_j, p_j = JP.apply_device_meta(
        jnp.asarray(meta), jnp.asarray(tok_row), jnp.asarray(tok_pos),
        JP.DeviceMeta(*(jnp.asarray(a) for a in dev)), jnp.asarray(pos))
    m_t, p_t = P.apply_device_meta(
        *_t(meta, tok_row, tok_pos), P.DeviceMeta(*_t(*dev)), torch.from_numpy(pos))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    # the decode tiles now start at their slots' device positions
    assert m_t[0, 1].item() == 11 and m_t[1, 1].item() == 40
    # the host plan it started from is untouched
    assert meta[0, 1] == 7
