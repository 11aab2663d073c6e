"""PyTorch port vs JAX package: the solo engine's and the dense fleet's
prefix KV cache (engine/prefix.py).

The cases of tests/test_prefix_cache.py at tier-1 sizes: one scripted
sequence of stores, lookups and marks through both packages' PrefixCache
(the chunk-floored longest common prefix, the LRU bound, the stats) on
caches of the same values, raw and int8; a snapshot is a copy (the live
cache rewritten leaves it unchanged) and a splice writes in place; a solo
hit gives the cold run's ids and log-probabilities and the JAX engine's
hit (prefix_cached_tokens included), raw and int8; the dense fleet's hits
(spliced into its admission scratch, whose address stays) give the JAX
dense fleet's greedy ids and counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.engine.prefix import PrefixCache as JaxPrefixCache  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import kv_quant as JQ  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import prefix as PX  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.metrics import MetricsRegistry  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (16, 32)
CHUNK = 16
HEAD = "You are a helpful assistant. Answer briefly: "  # 46 tokens with BOS
TAILS = ["what is two plus two?", "name a colour.", "say hello"]


def _caches(int8: bool, seed: int):
    """The same cache values as a JAX tree and a port dict [2, 1, 2, 40, 4]."""
    rng = np.random.default_rng(seed)
    if int8:
        q = rng.integers(-127, 128, size=(2, 1, 2, 40, 4)).astype(np.int8)
        s = rng.random((2, 1, 2, 40)).astype(np.float32)
        jax_tree = {n: JQ.KVQuant(jnp.asarray(q), jnp.asarray(s)) for n in ("k", "v")}
        port = {n: KVQuant(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
                for n in ("k", "v")}
        return jax_tree, port
    x = rng.standard_normal((2, 1, 2, 40, 4)).astype(np.float32)
    return ({n: jnp.asarray(x) for n in ("k", "v")},
            {n: torch.from_numpy(x.copy()) for n in ("k", "v")})


def _flat(tree):
    out = []
    for n in ("k", "v"):
        x = tree[n]
        out += [np.asarray(x.q), np.asarray(x.s)] if hasattr(x, "q") else [np.asarray(x)]
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_scripted_sequence_equals_jax(int8):
    """stores (one below a chunk, a duplicate, an eviction), lookups at
    every depth (a diverging tail still donates its shared head, at least
    one tail token always left) and marks: the same (P, key), snapshot
    values and stats after every step."""
    jpc, pc = JaxPrefixCache(2, 4), PX.PrefixCache(2, 4, registry=MetricsRegistry())
    a = list(range(10, 23))  # 13 tokens
    b = a[:8] + [90, 91, 92, 93, 94]
    c = [50 + i for i in range(9)]
    steps = [("store", a, 13, 0), ("store", a, 13, 1), ("store", [1, 2, 3], 3, 2),
             ("lookup", a + [7]), ("lookup", b), ("lookup", a[:5]),
             ("mark", a + [7], True), ("store", b, 13, 3), ("lookup", b + [1]),
             ("store", c, 9, 4), ("lookup", a + [7]), ("mark", c, False),
             ("lookup", c + [1, 2])]
    keys = {}
    for step in steps:
        if step[0] == "store":
            _, ids, n, seed = step
            jtree, ptree = _caches(int8, seed)
            assert pc.store(ids, n, ptree) == jpc.store(ids, n, jtree)
        elif step[0] == "lookup":
            jp, jentry, jkey = jpc.lookup(step[1])
            p, entry, key = pc.lookup(step[1])
            assert (p, key) == (jp, jkey)
            keys[tuple(step[1])] = key
            if entry is not None:
                for g, w in zip(_flat(entry), _flat(jentry)):
                    np.testing.assert_array_equal(g, w)
        else:
            key = keys.get(tuple(step[1]))
            jpc.mark(key, step[2], depth=4)
            pc.mark(key, step[2], depth=4)
        assert pc.stats() == jpc.stats()
    assert pc.stats()["evictions"] == 1


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_snapshot_is_a_copy_and_splice_writes_in_place(int8):
    _, live = _caches(int8, 0)
    before = [t.clone() for t in _flat_t(live)]
    pc = PX.PrefixCache(2, 8)
    assert pc.store(list(range(20)), 20, live) == 16
    for t in _flat_t(live):
        t.zero_()  # the next request rewrites the live cache
    p, entry, _ = pc.lookup(list(range(25)))
    assert p == 16
    for g, w in zip(_flat_t(entry), before):
        torch.testing.assert_close(g, w[:, :, :, :16], rtol=0, atol=0)
    _, other = _caches(int8, 9)
    ptrs = [t.data_ptr() for t in _flat_t(other)]
    out = pc.splice(entry, other, 8)
    assert [t.data_ptr() for t in _flat_t(out)] == ptrs
    for g, w in zip(_flat_t(other), before):
        torch.testing.assert_close(g[:, :, :, :8], w[:, :, :, :8], rtol=0, atol=0)
    want_bytes = sum(t[:, :, :, :16].numel() * t.element_size() for t in before)
    assert PX.snapshot_bytes(entry) == want_bytes


def _flat_t(tree):
    out = []
    for n in ("k", "v"):
        x = tree[n]
        out += [x.q, x.s] if isinstance(x, KVQuant) else [x]
    return out


@pytest.fixture(scope="module")
def weights():
    cfg = dict(eos_token_id=-1)
    params = JM.init_params(jax_cfg(MODEL, **cfg), jax.random.PRNGKey(2))
    tparams = params_from_numpy(get_model_config(MODEL, **cfg),
                                jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _solo(weights, kv_quant=None, entries=2):
    cfg, params, tparams = weights
    ek = dict(prefill_buckets=BUCKETS, prefix_cache_entries=entries, prefix_chunk=CHUNK)
    je = JaxEngine(jax_cfg(MODEL, kv_quant=kv_quant, **cfg), params,
                   engine_cfg=JaxEngineConfig(**ek))
    pe = create_engine(get_model_config(MODEL, **cfg), params=tparams, kv_quant=kv_quant,
                       engine_cfg=EngineConfig(**ek), device="cpu")
    return je, pe


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_solo_hit_equals_cold_and_jax(weights, kv_quant):
    je, pe = _solo(weights, kv_quant)
    _, cold = _solo(weights, kv_quant, entries=0)
    kw = dict(max_tokens=8, greedy=True, chat=False, logprobs=True)
    for i, tail in enumerate(TAILS):
        got, want = pe.generate(HEAD + tail, **kw), je.generate(HEAD + tail, **kw)
        ref = cold.generate(HEAD + tail, **kw)
        assert got["status"] == want["status"] == ref["status"] == "success"
        assert got["response"] == want["response"] == ref["response"]
        assert got.get("prefix_cached_tokens") == want.get("prefix_cached_tokens")
        assert got.get("prefix_cached_tokens") == (None if i == 0 else 32)
        assert "prefix_cached_tokens" not in ref
        np.testing.assert_allclose(got["token_logprobs"], ref["token_logprobs"],
                                   atol=1e-5 if kv_quant is None else 0, rtol=0)
        np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                                   atol=1e-4 if kv_quant is None else 1e-2, rtol=0)
    assert pe.stats()["prefix_cache"] == je.stats()["prefix_cache"]
    assert pe.stats()["prefix_cache"]["hits"] == 2
    hits = pe.metrics.get("dli_prefix_cache_hits_total")
    assert hits.labels(scope="solo").value == 2


def test_dense_fleet_hits_equal_jax(weights):
    """The dense fleet's own snapshots: requests behind one head hit,
    splice into the admission scratch in place (its storage never moves:
    the graphs read it) and give the JAX dense fleet's greedy ids and
    counts."""
    cfg, params, tparams = weights
    ek = dict(prefill_buckets=BUCKETS, prefix_cache_entries=2, prefix_chunk=CHUNK)
    je = JaxEngine(jax_cfg(MODEL, **cfg), params, engine_cfg=JaxEngineConfig(**ek))
    pe = create_engine(get_model_config(MODEL, **cfg), params=tparams,
                       engine_cfg=EngineConfig(**ek), device="cpu")
    jf = JaxContinuousEngine(je, n_slots=2, slot_max_seq=128)
    pf = ContinuousEngine(pe, n_slots=2, slot_max_seq=128)
    try:
        ptrs = [t.data_ptr() for t in _flat_t(pf._scratch)]
        kw = dict(max_tokens=8, greedy=True, chat=False)
        for tail in TAILS:
            got, want = pf.submit(HEAD + tail, **kw), jf.submit(HEAD + tail, **kw)
            assert got["status"] == want["status"] == "success", (got, want)
            assert got["response"] == want["response"]
            assert got.get("prefix_cached_tokens") == want.get("prefix_cached_tokens")
        assert pf.stats()["prefix_cache"] == jf.stats()["prefix_cache"]
        assert pf.stats()["prefix_cache"]["hits"] == 2
        assert [t.data_ptr() for t in _flat_t(pf._scratch)] == ptrs
        hits = pe.metrics.get("dli_prefix_cache_hits_total")
        assert hits.labels(scope="continuous").value == 2
    finally:
        jf.close()
        pf.close()
