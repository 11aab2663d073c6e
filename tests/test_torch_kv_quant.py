"""PyTorch port vs JAX package: the int8 KV cache.

The same numpy inputs go through the JAX package's ops/kv_quant.py and the
port's: `quantize_chunk` and the cache writes (`update_cache`,
`update_cache_slots`, and a gated write that keeps the old slice) must be
bit-equal. The int8 twins of the three attention kernels (what the
wrappers run on CPU tensors) are held to the JAX Pallas kernels in
interpret mode on KVQuant inputs, fp32: the paged pair at atol 1e-5 and
flash_attend at rtol 1e-5 / atol 2e-5, the tolerances of the raw-dtype
files (the two sum in another order). The slice as a whole on
test-llama-tiny (fp32, the same weights): the solo engine under
kv_quant="int8" (flash kernel path) and under quant="int8" gives the JAX
engine's greedy tokens exactly, and scripted mixed launches and a decode
step over an int8 pool with int4 weights give the JAX logits within
LOGITS_ATOL."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import kv_quant as JK  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu.ops.flash_attention import flash_attend as jax_flash  # noqa: E402
from distributed_llm_inference_tpu.ops.paged_attention import (  # noqa: E402
    paged_flash_attend as jax_paged,
)
from distributed_llm_inference_tpu.ops.paged_attention import (  # noqa: E402
    ragged_paged_attend as jax_ragged,
)
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as TM  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    cache_from_numpy,
    params_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import kv_quant as K  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as pa  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
# model-level results over an int8 cache: the two packages compute K/V in
# another summation order, so a value on a rounding boundary of the int8
# grid may be stored one step (~absmax / 127) apart, which moves logits
# and log-probabilities (spread ~1) by up to ~2e-3 in a CPU run of these
# tests; a wrong mask, tile walk or scale moves them by O(0.1)
LOGITS_ATOL = 1e-2
PAGED_ATOL = 1e-5
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _jleaf(q, s):
    return JK.KVQuant(jnp.asarray(q), jnp.asarray(s))


def _tleaf(q, s):
    return K.KVQuant(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))


def _int8_leaves(rng, shape):
    """Random int8 data and positive fp32 scales [shape without its last
    axis] — a quantized cache or pool as the writes leave it."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = (rng.random(shape[:-1]) * 0.05 + 0.001).astype(np.float32)
    return q, s


def test_quantize_chunk_bit_equal_jax():
    x = _rng(0).standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0  # an all-zero row: the 1e-12 floor keeps it zero
    qj, sj = JK.quantize_chunk(jnp.asarray(x))
    qt, st = K.quantize_chunk(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    leaf = K.KVQuant(qt, st)
    np.testing.assert_array_equal(K.dequantize(leaf).numpy(),
                                  np.asarray(JK.dequantize(JK.KVQuant(qj, sj))))


@pytest.mark.parametrize("gate", [None, True, False], ids=["plain", "gate_on", "gate_off"])
@pytest.mark.parametrize("slots", [False, True], ids=["scalar_pos", "per_row_pos"])
def test_cache_writes_bit_equal_jax(slots, gate):
    rng = _rng(1)
    B, KV, S, Dh, T = 3, 2, 24, 8, 4
    q0, s0 = _int8_leaves(rng, (B, KV, S, Dh))
    x = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    if slots:
        pos = np.array([0, 9, S - T], np.int32)
        jfn, tfn, jpos, tpos = JK.update_cache_slots, K.update_cache_slots, \
            jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jfn, tfn, jpos, tpos = JK.update_cache, K.update_cache, jnp.int32(7), 7
    jgate = None if gate is None else jnp.asarray(gate)
    tgate = None if gate is None else torch.tensor(gate)
    want = jfn(_jleaf(q0, s0), jnp.asarray(x), jpos, gate=jgate)
    leaf = _tleaf(q0, s0)
    got = tfn(leaf, torch.from_numpy(x), tpos, gate=tgate)
    assert got is leaf  # written in place
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    if gate is False:  # the gated no-op
        np.testing.assert_array_equal(got.q.numpy(), q0)
        np.testing.assert_array_equal(got.s.numpy(), s0)


def test_init_cache_and_pool_match_jax():
    jcfg = jax_cfg(MODEL, kv_quant="int8")
    tcfg = get_model_config(MODEL, kv_quant="int8")
    for j, t in ((JM.init_kv_cache(jcfg, 2, max_seq=32),
                  TM.init_kv_cache(tcfg, 2, max_seq=32, device="cpu")),
                 (JP.init_pool(jcfg, 9, 16), P.init_pool(tcfg, 9, 16, device="cpu"))):
        for name in ("k", "v"):
            assert isinstance(t[name], K.KVQuant)
            assert tuple(t[name].q.shape) == j[name].q.shape
            assert tuple(t[name].s.shape) == j[name].s.shape
            assert t[name].q.dtype == torch.int8 and t[name].s.dtype == torch.float32
            assert not t[name].q.any() and not t[name].s.any()
            # one layer's slice slices both leaves
            assert t[name][1].q.shape == t[name].q.shape[1:]
            assert t[name][1].s.shape == t[name].s.shape[1:]


# -- the int8 twins against the Pallas kernels ------------------------------------

H, KV, DH, BS, MB, N, TQ = 8, 2, 16, 4, 8, 48, 4
PAGED_VARIANTS = [({}, None), ({"window": 5}, None), ({}, 3), ({"softcap": 3.0}, None),
                  ({"scale": 0.2}, None)]
PAGED_IDS = ["causal", "window", "window_dyn", "softcap", "scale"]
META = np.array([
    (0, 0, 1, pa.RAGGED_DECODE), (1, 29, 1, pa.RAGGED_DECODE),
    (2, 13, 4, pa.RAGGED_PREFILL), (2, 17, 4, pa.RAGGED_PREFILL),
    (2, 21, 2, pa.RAGGED_PREFILL), (3, 0, 3, pa.RAGGED_PREFILL),
    (3, 0, 0, pa.RAGGED_PREFILL),
], np.int32)


def _int8_pool(seed, rows):
    rng = _rng(seed)
    k = _int8_leaves(rng, (N, KV, BS, DH))
    v = _int8_leaves(rng, (N, KV, BS, DH))
    table = (rng.permutation(N - 1)[: rows * MB] + 1).reshape(rows, MB).astype(np.int32)
    return rng, k, v, table


def _window(wd):
    if wd is None:
        return None, None
    return jnp.array([wd], jnp.int32), torch.tensor([wd], dtype=torch.int32)


@pytest.mark.parametrize("kw,wd", PAGED_VARIANTS, ids=PAGED_IDS)
def test_int8_ragged_twin_matches_pallas_kernel(kw, wd):
    rng, k, v, table = _int8_pool(2, 4)
    q = rng.standard_normal((META.shape[0] * TQ, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), _jleaf(*k), _jleaf(*v), jnp.asarray(table), jnp.asarray(META),
        wdj, interpret=True, **kw))
    before = pa.ragged_paged_attend.launches_int8
    got = pa.ragged_paged_attend(torch.from_numpy(q), _tleaf(*k), _tleaf(*v),
                                 torch.from_numpy(table), torch.from_numpy(META), wdt, **kw)
    assert pa.ragged_paged_attend.launches_int8 == before  # CPU: the twin
    np.testing.assert_allclose(got.numpy(), want, atol=PAGED_ATOL, rtol=0)
    out = got.numpy().reshape(META.shape[0], TQ, H, DH)
    for g, (_, _, q_len, _) in enumerate(META):
        assert not out[g, q_len:].any()


@pytest.mark.parametrize("kw,wd", PAGED_VARIANTS, ids=PAGED_IDS)
def test_int8_paged_decode_twin_matches_pallas_kernel(kw, wd):
    rng, k, v, table = _int8_pool(3, 5)
    pos = np.array([0, 3, 4, 17, MB * BS - 1], np.int32)
    q = rng.standard_normal((5, 1, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(jax_paged(
        jnp.asarray(q), _jleaf(*k), _jleaf(*v), jnp.asarray(table), jnp.asarray(pos),
        wdj, interpret=True, **kw))
    before = pa.paged_flash_attend.launches_int8
    got = pa.paged_flash_attend(torch.from_numpy(q), _tleaf(*k), _tleaf(*v),
                                torch.from_numpy(table), torch.from_numpy(pos), wdt, **kw)
    assert pa.paged_flash_attend.launches_int8 == before
    np.testing.assert_allclose(got.numpy(), want, atol=PAGED_ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_int8_decode(bs, mb, variant):
    """The int8 Pallas decode kernel in interpret mode on the split walk's
    positions over a shuffled int8 pool (cached: every split count is held
    to the same result)."""
    from test_torch_paged_attention import WALK_VARIANTS, walk_positions

    kw, wd = WALK_VARIANTS[variant]
    positions = walk_positions(bs, mb)
    rng = _rng(50 + bs)
    n = len(positions) * mb + 1
    k = _int8_leaves(rng, (n, KV, bs, DH))
    v = _int8_leaves(rng, (n, KV, bs, DH))
    table = (rng.permutation(n - 1)[: len(positions) * mb] + 1).reshape(
        len(positions), mb).astype(np.int32)
    q = rng.standard_normal((len(positions), 1, H, DH)).astype(np.float32)
    pos = np.array(positions, np.int32)
    wdj, _ = _window(wd)
    want = np.asarray(jax_paged(
        jnp.asarray(q), _jleaf(*k), _jleaf(*v), jnp.asarray(table), jnp.asarray(pos),
        wdj, interpret=True, **kw))
    return (q, k, v, table, pos), want


@pytest.mark.parametrize("n_split", [1, 2, 3, 9])
@pytest.mark.parametrize("variant", range(6),
                         ids=["causal", "window", "window_dyn", "window_dyn_off",
                              "softcap", "scale"])
@pytest.mark.parametrize("bs,mb", [(16, 20), (12, 27)], ids=["bs16", "bs12"])
def test_int8_paged_walk_matches_pallas_kernel(bs, mb, variant, n_split):
    """The CUDA decode kernel's split-KV walk over an int8 pool, emulated in
    fp32 torch (test_torch_paged_attention._paged_walk: each row q8 * s,
    then the split, warp and fixed-order merges), against the int8 Pallas
    kernel in interpret mode: within PAGED_ATOL with 1, 2, 3 and 9 splits,
    positions on block, tile and split edges and past the table."""
    from test_torch_paged_attention import WALK_VARIANTS, _paged_walk

    (q, k, v, table, pos), want = _jax_int8_decode(bs, mb, variant)
    kw, wd = WALK_VARIANTS[variant]
    _, wdt = _window(wd)
    got = _paged_walk(torch.from_numpy(q), _tleaf(*k), _tleaf(*v), torch.from_numpy(table),
                      torch.from_numpy(pos), wdt, n_split=n_split, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=PAGED_ATOL, rtol=0)


@pytest.mark.parametrize("round_to", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_int8_paged_walk_rounds_each_dequantized_element_once(round_to):
    """For a bf16 / fp16 product the kernel rounds each dequantized element
    q8 * s (fp32) to that type once: the walk with that rounding is the
    raw twin over the pool so rounded, within PAGED_ATOL (fp32 math, two
    summation orders over int8 rows of up to ~6)."""
    from test_torch_paged_attention import _paged_walk

    (q, k, v, table, pos), _ = _jax_int8_decode(16, 20, 0)
    kt, vt = _tleaf(*k), _tleaf(*v)
    rounded = [(leaf.q.float() * leaf.s[..., None]).to(round_to).float() for leaf in (kt, vt)]
    want = pa.paged_flash_attend_plain(torch.from_numpy(q), *rounded,
                                       torch.from_numpy(table), torch.from_numpy(pos))
    for n_split in (1, 3):
        got = _paged_walk(torch.from_numpy(q), kt, vt, torch.from_numpy(table),
                          torch.from_numpy(pos), n_split=n_split, round_to=round_to)
        torch.testing.assert_close(got, want, atol=PAGED_ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_int8_ragged(bs, mb, variant):
    """The int8 Pallas ragged kernel in interpret mode on the ragged walk's
    launch (test_torch_paged_attention.ragged_walk_meta) over a shuffled
    int8 pool (cached: every cluster is held to the same result)."""
    from test_torch_paged_attention import (
        RAGGED_H,
        RAGGED_TQ,
        WALK_VARIANTS,
        ragged_walk_meta,
    )

    kw, wd = WALK_VARIANTS[variant]
    rng = _rng(80 + bs)
    n = 10 * mb + 1
    k = _int8_leaves(rng, (n, KV, bs, DH))
    v = _int8_leaves(rng, (n, KV, bs, DH))
    table = (rng.permutation(n - 1)[: 10 * mb] + 1).reshape(10, mb).astype(np.int32)
    meta = ragged_walk_meta(bs, mb)
    q = rng.standard_normal((meta.shape[0] * RAGGED_TQ, RAGGED_H, DH)).astype(np.float32)
    wdj, _ = _window(wd)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), _jleaf(*k), _jleaf(*v), jnp.asarray(table), jnp.asarray(meta),
        wdj, interpret=True, **kw))
    return (q, k, v, table, meta), want


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("variant", range(6),
                         ids=["causal", "window", "window_dyn", "window_dyn_off",
                              "softcap", "scale"])
@pytest.mark.parametrize("bs,mb", [(16, 20), (12, 27)], ids=["bs16", "bs12"])
def test_int8_ragged_walk_matches_pallas_kernel(bs, mb, variant, cluster):
    """The CUDA ragged kernel's flash walk over an int8 pool, emulated in
    fp32 torch (test_torch_paged_attention._ragged_walk: each row q8 * s,
    then the cluster's shares and its fixed-order merge), against the int8
    Pallas kernel in interpret mode: within PAGED_ATOL with and without
    the ranks of a short tile walking fewer, zeros on the dead rows."""
    from test_torch_paged_attention import WALK_VARIANTS, _ragged_walk, ragged_dead_rows

    (q, k, v, table, meta), want = _jax_int8_ragged(bs, mb, variant)
    kw, wd = WALK_VARIANTS[variant]
    _, wdt = _window(wd)
    for share in (0, pa.RAGGED_MIN_SHARE):
        got = _ragged_walk(torch.from_numpy(q), _tleaf(*k), _tleaf(*v),
                           torch.from_numpy(table), torch.from_numpy(meta), wdt,
                           cluster=cluster, min_share=share, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=PAGED_ATOL, rtol=0)
        assert not got[ragged_dead_rows(meta)].any()


@pytest.mark.parametrize("round_to", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_int8_ragged_walk_rounds_each_dequantized_element_once(round_to):
    """For a bf16 / fp16 product the ragged kernel rounds each dequantized
    element q8 * s (fp32) to that type once, the rounding point of
    flash_attend's int8 cache: the walk with that rounding is the raw twin
    over the pool so rounded, within PAGED_ATOL."""
    from test_torch_paged_attention import _ragged_walk

    (q, k, v, table, meta), _ = _jax_int8_ragged(16, 20, 0)
    kt, vt = _tleaf(*k), _tleaf(*v)
    rounded = [(leaf.q.float() * leaf.s[..., None]).to(round_to).float() for leaf in (kt, vt)]
    args = (torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(meta))
    want = pa.ragged_paged_attend_plain(args[0], *rounded, *args[1:])
    for cluster in (1, 4):
        got = _ragged_walk(args[0], kt, vt, *args[1:], cluster=cluster,
                           min_share=pa.RAGGED_MIN_SHARE, round_to=round_to)
        torch.testing.assert_close(got, want, atol=PAGED_ATOL, rtol=0)


# (B, T, H, KV, Dh, S, pos, valid_start, window, window_dyn, scale, softcap)
FLASH_CASES = [
    (1, 16, 8, 2, 16, 64, 0, None, None, None, None, None),  # prefill at 0
    (2, 9, 4, 2, 8, 48, 13, None, None, None, None, None),  # chunk mid-sequence
    (2, 12, 4, 2, 8, 32, 4, [0, 6], None, None, None, None),  # left-padded rows
    (1, 20, 4, 2, 8, 64, 10, None, None, 6, None, None),  # per-layer window
    (2, 8, 6, 3, 24, 40, 3, [2, 0], 5, None, 0.3, 20.0),  # all variants at once
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_int8_flash_twin_matches_pallas_kernel(case):
    B, T, H_, KV_, Dh, S, pos, vs, window, wdyn, scale, softcap = case
    rng = _rng(B * 100 + T)
    q = rng.standard_normal((B, T, H_, Dh)).astype(np.float32)
    k = _int8_leaves(rng, (B, KV_, S, Dh))
    v = _int8_leaves(rng, (B, KV_, S, Dh))
    want = jax_flash(
        jnp.asarray(q), _jleaf(*k), _jleaf(*v), jnp.int32(pos),
        None if vs is None else jnp.asarray(vs, jnp.int32),
        None if wdyn is None else jnp.int32(wdyn),
        block_t=4, block_k=16, window=window, scale=scale, softcap=softcap,
    )
    before = fa.flash_attend.launches_int8
    got = fa.flash_attend(
        torch.from_numpy(q), _tleaf(*k), _tleaf(*v), pos,
        None if vs is None else torch.tensor(vs, dtype=torch.int32),
        None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32),
        window=window, scale=scale, softcap=softcap,
    )
    assert fa.flash_attend.launches_int8 == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


def test_bare_int8_tensor_is_not_a_cache():
    """An int8 cache comes as KVQuant leaves; a bare int8 tensor (no
    scales) is refused by every wrapper and twin."""
    q = torch.zeros(1, 4, 4, 8)
    bare = torch.zeros(1, 2, 16, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="KVQuant"):
        fa.flash_attend(q, bare, bare, 2)
    pool = torch.zeros(9, 2, 4, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="KVQuant"):
        pa.paged_flash_attend(torch.zeros(1, 1, 4, 8), pool, pool,
                              torch.ones(1, 2, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32))


# -- the slice as a whole ----------------------------------------------------------

def _weights(seed):
    params = JM.init_params(jax_cfg(MODEL, dtype="float32"), jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_forward_logits_with_int8_cache_match_jax(impl):
    """The dense hook's int8 branch: a T>1 chunk (the flash kernel's twin
    under attn_impl="kernel"), a decode step, then per-row positions."""
    params, tree = _weights(4)
    jcfg = jax_cfg(MODEL, dtype="float32", kv_quant="int8",
                   attn_impl="pallas" if impl == "kernel" else "xla")
    tcfg = get_model_config(MODEL, dtype="float32", kv_quant="int8", attn_impl=impl)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    rng = _rng(5)
    jcache = JM.init_kv_cache(jcfg, 2, max_seq=40)
    tcache = TM.init_kv_cache(tcfg, 2, max_seq=40, device="cpu")
    steps = [(11, 0), (3, 11), (1, 14), (1, np.array([15, 6], np.int32))]
    for T, pos in steps:
        toks = rng.integers(3, tcfg.vocab_size, (2, T)).astype(np.int32)
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else jnp.int32(pos)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        jlog, jcache = JM.forward(jcfg, params, jnp.asarray(toks), jcache, jpos)
        tlog, tcache = TM.forward(tcfg, tparams, torch.from_numpy(toks).long(), tcache, tpos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
    # the cache the two wrote: scales to fp32 rounding, data to one step
    # of the int8 grid where a K/V value sits on a rounding boundary
    np.testing.assert_allclose(tcache["k"].s.numpy(), np.asarray(jcache["k"].s),
                               rtol=1e-5, atol=0)
    assert np.abs(tcache["k"].q.numpy().astype(int)
                  - np.asarray(jcache["k"].q).astype(int)).max() <= 1


@pytest.fixture(scope="module")
def solo_pairs():
    params, tree = _weights(3)
    pairs = {}
    for name, kw, jimpl, timpl in (("kv_int8", dict(kv_quant="int8"), "pallas", "kernel"),
                                   ("w_int8", dict(quant="int8"), "xla", "plain")):
        jcfg = jax_cfg(MODEL, dtype="float32", attn_impl=jimpl, **kw)
        jparams = JQ.quantize_params(jcfg, params) if jcfg.quant else params
        ecfg = dict(prefill_buckets=(16, 32))
        jeng = JaxEngine(jcfg, jparams, engine_cfg=JaxEngineConfig(**ecfg))
        tcfg = get_model_config(MODEL, dtype="float32", **kw)
        teng = create_engine(tcfg, params=params_from_numpy(tcfg, tree, "cpu"),
                             attn_impl=timpl, engine_cfg=EngineConfig(**ecfg),
                             device="cpu")
        pairs[name] = (jeng, teng)
    return pairs


@pytest.mark.parametrize("name", ["kv_int8", "w_int8"])
@pytest.mark.parametrize("prompt", ["Hello",  # one padded prefill bucket
                                    "The quick brown fox jumps over the lazy dog, twice."])
def test_solo_engine_greedy_tokens_identical_to_jax(solo_pairs, name, prompt):
    jeng, teng = solo_pairs[name]
    kw = dict(max_tokens=10, greedy=True, chat=False, logprobs=True)
    want = jeng.generate(prompt, **kw)
    got = teng.generate(prompt, **kw)
    assert got["status"] == want["status"] == "success", (got, want)
    for key in ("response", "tokens_generated", "prompt_tokens", "token_strings"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                               atol=LOGITS_ATOL if name == "kv_int8" else 1e-4)




def _scripted_logits(cfg, M, hooks, embed_pos, params, pool, table, ids, asarr):
    out = []
    for entries in ([(0, 0, 13, 0), (1, 0, 6, 0)],
                    [(0, 13, 1, 1), (1, 6, 1, 1), (2, 0, 9, 0)]):
        meta, tok_row, tok_pos, _, _ = P.build_ragged_meta(entries, width=32, tile=8)
        toks = ids[np.maximum(tok_row, 0), tok_pos]
        x = M.embed(cfg, params, asarr(toks)[:, None], asarr(tok_pos))
        x, pool = M.forward_layers(
            cfg, params["layers"], x, pool, asarr(tok_pos), attn_seq_len=1,
            attn_hook=hooks.make_ragged_fill_hook(asarr(table), asarr(meta),
                                                  asarr(tok_row)))
        out.append(np.asarray(M.unembed(cfg, params, x)[:, 0])[tok_row >= 0])
    pos = np.array([14, 7, 9], np.int32)
    x = M.embed(cfg, params, asarr(ids[np.arange(3), pos])[:, None], asarr(pos))
    x, pool = M.forward_layers(cfg, params["layers"], x, pool, asarr(pos),
                               attn_hook=hooks.make_paged_hook(asarr(table)),
                               attn_seq_len=table.shape[1] * 8)
    out.append(np.asarray(M.unembed(cfg, params, x)[:, 0]))
    return np.concatenate(out), pool


def test_scripted_quantized_fleet_launches_match_jax():
    """Two mixed launches (prompts landing, then their decode rows beside
    a third prompt) and one decode step over an int8 pool with int4
    weights, through the ragged and paged kernels' twins, against the JAX
    Pallas kernels in interpret mode."""
    params, _ = _weights(6)
    jcfg = jax_cfg(MODEL, dtype="float32", quant="int4", kv_quant="int8",
                   attn_impl="pallas")
    tcfg = get_model_config(MODEL, dtype="float32", quant="int4", kv_quant="int8",
                            attn_impl="kernel")
    jparams = JQ.quantize_params(jcfg, params)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = _rng(7)
    table = (rng.permutation(24)[:18] + 1).reshape(3, 6).astype(np.int32)
    ids = rng.integers(3, tcfg.vocab_size, (3, 48)).astype(np.int32)
    jpool = JP.init_pool(jcfg, 25, 8)
    tpool = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jpool), "cpu")
    assert isinstance(tpool["k"], K.KVQuant)
    want, jpool = _scripted_logits(jcfg, JM, JP, None, jparams, jpool, table, ids,
                                   jnp.asarray)
    before = (pa.ragged_paged_attend.launches_int8, pa.paged_flash_attend.launches_int8)
    got, tpool = _scripted_logits(tcfg, TM, P, None, tparams, tpool, table, ids,
                                  torch.from_numpy)
    assert (pa.ragged_paged_attend.launches_int8,
            pa.paged_flash_attend.launches_int8) == before
    assert got.shape == want.shape == (13 + 6 + 2 + 9 + 3, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # the pool outside the trash block: scales to the relative difference
    # of the K/V values they come from (int4 products summed in another
    # order), data to one step of the int8 grid
    for name in ("k", "v"):
        js, ts = np.asarray(jpool[name].s)[:, 1:], tpool[name].s.numpy()[:, 1:]
        np.testing.assert_allclose(ts, js, rtol=1e-3, atol=0)
        dq = np.abs(tpool[name].q.numpy()[:, 1:].astype(int)
                    - np.asarray(jpool[name].q)[:, 1:].astype(int))
        assert dq.max() <= 1


def test_kernel_wrappers_validate_int8_leaves():
    """What the wrappers check before a launch (shapes, dtypes, devices,
    contiguity; no card needed): int8 leaves pass, malformed ones raise."""
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    rng = _rng(8)
    ck = _tleaf(*_int8_leaves(rng, (2, 2, 32, 16)))
    q = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16)
    assert fa._check(q, ck, ck, 4, None, None) == (2, 8, 4, 16)
    bad = K.KVQuant(ck.q, ck.s.double())
    with pytest.raises(TypeError, match="fp32 scales"):
        fa._check(q, bad, bad, 4, None, None)
    _, k, v, table = _int8_pool(9, 2)
    pk, pv = _tleaf(*k), _tleaf(*v)
    table = torch.from_numpy(table)
    pos = torch.zeros(2, dtype=torch.int32)
    assert pa._check("paged_flash_attend", torch.zeros(2, 1, H, DH), pk, pv, table, None,
                     (("pos", pos, 2),)) == (N, KV, BS)
    with pytest.raises(TypeError, match="both be raw or both int8"):
        pa._check("paged_flash_attend", torch.zeros(2, 1, H, DH), pk, pv.q, table, None,
                  (("pos", pos, 2),))
    w = Q.quantize_tensor4(torch.randn(256, 384))
    assert Q._check(torch.zeros(8, 256), w) == (8, 4, 32, 384)
    with pytest.raises(ValueError):
        Q._check(torch.zeros(33, 256), w)
    with pytest.raises(TypeError):
        Q._check(torch.zeros(8, 256, dtype=torch.float64), w)


class _StandInLibrary:
    """Stands in for a kernel library on the CPU: each C entry point checks
    its arguments against the wrapper module's declared ctypes signature
    (count and type, as ctypes would convert them), records them and
    reports a launch with CUDA error 0."""

    def __init__(self, signatures):
        self.signatures = signatures
        self.calls = []

    def __getattr__(self, name):
        argtypes = self.signatures[name]

        def entry(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            for t, a in zip(argtypes, args):
                t.from_param(a)  # raises where ctypes would
            self.calls.append((name, args))
            return 0

        return entry


def test_wrappers_launch_path_with_a_stand_in_library(monkeypatch):
    """The launch half of every wrapper, raw and int8, run on CPU tensors
    against a stand-in library: the argument lists match the C signatures,
    int8 leaves hand over their scales, and each launch counts once on the
    count of its storage type."""
    import contextlib

    from distributed_llm_inference_tpu_torch.ops import quant as Q

    libs = {m: _StandInLibrary(m.SIGNATURES) for m in (fa, pa, Q)}
    for m, lib in libs.items():
        monkeypatch.setattr(m, "resolve_kernel", lambda device: True)
        monkeypatch.setattr(m, "_library", lambda lib=lib: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(fa, "_sm_count", lambda device: 132)  # flash_attend's plan
    monkeypatch.setattr(pa, "_sm_count", lambda device: 132)  # paged_flash_attend's splits
    rng = _rng(10)
    _, k, v, table = _int8_pool(11, 4)
    pools = {"raw": (torch.randn(N, KV, BS, DH), torch.randn(N, KV, BS, DH)),
             "int8": (_tleaf(*k), _tleaf(*v))}
    cache_q = _int8_leaves(rng, (1, KV, 32, DH))
    caches = {"raw": (torch.randn(1, KV, 32, DH),) * 2,
              "int8": (_tleaf(*cache_q),) * 2}
    table = torch.from_numpy(table)
    for kind in ("raw", "int8"):
        counts = [(w.launches, w.launches_int8) for w in
                  (fa.flash_attend, pa.ragged_paged_attend, pa.paged_flash_attend)]
        out = fa.flash_attend(torch.randn(1, 8, H, DH), *caches[kind], 4,
                              window_dyn=torch.tensor([3], dtype=torch.int32))
        assert out.shape == (1, 8, H, DH)
        pa.ragged_paged_attend(torch.randn(META.shape[0] * TQ, H, DH), *pools[kind],
                               table, torch.from_numpy(META))
        pa.paged_flash_attend(torch.randn(4, 1, H, DH), *pools[kind], table,
                              torch.zeros(4, dtype=torch.int32), softcap=3.0)
        for w, (raw, int8) in zip((fa.flash_attend, pa.ragged_paged_attend,
                                   pa.paged_flash_attend), counts):
            assert (w.launches - raw, w.launches_int8 - int8) == (
                (1, 0) if kind == "raw" else (0, 1))
        # the scale pointers (arguments 3 and 4) are handed over for int8 only
        for lib in (libs[fa], libs[pa]):
            for _, args in lib.calls[-(1 if lib is libs[fa] else 2):]:
                assert (args[3] is None) == (kind == "raw")
    monkeypatch.setattr(Q, "_sm_count", lambda device: 132)
    w = Q.quantize_tensor4(torch.randn(5632, 256))  # G = 88: a split grid
    before = Q.q4_matmul_rows.launches
    for R in (1, 8, 32):
        y = Q.q4_matmul_rows(torch.randn(R, 5632, dtype=torch.bfloat16), w)
        assert y.shape == (R, 256) and y.dtype == torch.bfloat16
        args = libs[Q].calls[-1][1]
        assert args[4:10] == (1, R, 5632, 88, 32, 256)  # dtype code, R, in, G, half, out
        plan = Q.q4_plan(R, 88, 32, 256, 132, 2)
        assert args[10:13] == (plan.n_split, plan.gps, plan.stages)
        assert (plan.n_split - 1) * plan.gps < 88 <= plan.n_split * plan.gps
    # x from a view that is not 16-byte aligned reaches the kernel as a copy
    x = torch.randn(8 * 5632 + 1, dtype=torch.bfloat16)[1:].view(8, 5632)
    Q.q4_matmul_rows(x, w)
    assert x.data_ptr() % 16 and libs[Q].calls[-1][1][0] % 16 == 0
    assert Q.q4_matmul_rows.launches == before + 4
