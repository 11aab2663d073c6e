"""PyTorch port vs JAX package: the block-prefix cache of the paged fleet.

The port's engine/block_prefix.py is a copy of the JAX module: its digests
and one seeded sequence of index operations over each package's own
refcounted allocator must give the same returns and stats. The data movers
(gather_scratch_blocks, gather_shadow_blocks, restore_shadow_blocks) move
bytes only, so on the same numpy pool they are bit-equal to the JAX
functions, raw and int8. Then the fleet cases of tests/test_block_prefix.py
run through the JAX ContinuousEngine and the port's on the same weights
(test-llama-tiny, fp32, no EOS, params bridged through numpy), ragged
(chunked, the main path) and bucketed (ragged_prefill=False): equal greedy
ids, equal hit depths (`prefix_cached_tokens`), equal hit / miss / saved
token counts, a hit bit-equal to the port's own cold run, and clean pools.
"""

import hashlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import block_prefix as JBP  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops.kv_quant import KVQuant as JKVQuant  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import block_prefix as TBP  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as TP  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=256)
BS = 16  # kv_block_size of every fleet here
SHARED = "shared system prefix " * 4  # 85 ids with BOS: five full blocks
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog while the band plays on",
           "hello"]
# the admissions a hit runs through: the main path (chunked mixed
# launches, ragged) and the bucketed whole-prefill (a gathered scratch)
MODES = {"ragged": {}, "bucketed": {"ragged_prefill": False}}
# one SLO class whose TPOT target no CPU step reaches: the chunked
# scheduler halves a step's prefill budget under decode TPOT pressure, a
# wall-clock signal, which would let each fleet slice a wave's prompt
# chunks differently from run to run
STEADY = dict(slo_classes=(("standard", 60.0, 60.0, 1.0, False),))
GEN = dict(greedy=True, chat=False)


# -- the copied module: digests and the index over each allocator -------------

@pytest.mark.parametrize("form", ["ids", "bytes", "str"])
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunk_digests_match_jax(form, chunk):
    rng = np.random.RandomState(chunk)
    ids = [int(t) for t in rng.randint(0, 300, size=70)]
    seq = {"ids": ids, "bytes": bytes(t % 256 for t in ids),
           "str": "".join(chr(97 + t % 26) for t in ids)}[form]
    for max_chunks in (64, 2):
        got = TBP.chunk_digests(seq, chunk, max_chunks=max_chunks)
        assert got == JBP.chunk_digests(seq, chunk, max_chunks=max_chunks)
        assert len(got) == min(len(seq) // chunk, max_chunks)


def _index_ops(alloc_cls, index_cls, seed: int) -> list:
    """One seeded sequence of admissions, releases, evictions, imports,
    exports and clears over an index and its allocator; every return and
    the stats after each step."""
    rng = np.random.RandomState(seed)
    bs = 4
    alloc = alloc_cls(24)
    index = index_cls(alloc, bs)
    held, log = [], []
    for _ in range(150):
        op = rng.choice(7, p=[0.4, 0.2, 0.08, 0.1, 0.1, 0.07, 0.05])
        if op == 0:  # an admission: lookup, mark, map the head, alloc the rest
            n = int(rng.randint(1, 20))
            # a common head half the time, so that admissions share
            head = [1, 2, 1, 2, 2, 1, 2, 1][:n] if rng.rand() < 0.5 else []
            ids = head + [int(t) for t in rng.randint(1, 3, size=n - len(head))]
            p0, entry, key = index.lookup(ids)
            index.mark(key, hit=bool(p0), depth=p0)
            shared = list(entry or [])
            need = -(-n // bs) - len(shared)
            if shared:
                alloc.incref(shared)
            fresh = alloc.alloc(need)
            if fresh is None:
                index.evict(need - alloc.free_blocks)
                fresh = alloc.alloc(need)
            log.append(("admit", p0, entry, fresh))
            if fresh is None:
                if shared:
                    alloc.decref(shared)
                continue
            log.append(("register", index.register(ids, n, shared + fresh)))
            held.append(shared + fresh)
        elif op == 1 and held:
            alloc.decref(held.pop(rng.randint(len(held))))
        elif op == 2:
            log.append(("evict", index.evict(int(rng.randint(1, 6)))))
        elif op == 3:
            log.append(("evictable", index.evictable_blocks()))
        elif op == 4:
            log.append(("export", sorted(index.export_chains())))
        elif op == 5:  # a restored chain
            k = int(rng.randint(1, 4))
            blocks = alloc.alloc(k)
            if blocks is not None:
                ids = [int(t) for t in rng.randint(1, 3, size=k * bs)]
                log.append(("import", index.import_chain(ids, blocks)))
                alloc.decref(blocks)
        elif op == 6:
            log.append(("clear", index.clear()))
        log.append(("stats", index.stats(), alloc.free_blocks, alloc.outstanding,
                    alloc.shared_blocks))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_index_op_sequence_matches_jax(seed):
    want = _index_ops(JP.BlockAllocator, JBP.BlockPrefixIndex, seed)
    got = _index_ops(TP.BlockAllocator, TBP.BlockPrefixIndex, seed)
    assert got == want
    assert any(e[0] == "admit" and e[1] for e in got)  # some admissions hit


# -- the data movers, bit-equal to the JAX functions --------------------------

def _pools(int8: bool, n_blocks=9, seed=0):
    """The same random pool as a JAX tree and a port tree ([L, N, KV, bs,
    Dh] leaves; int8: KVQuant int8 data with fp32 scales [L, N, KV, bs])."""
    rng = np.random.RandomState(seed)
    shape = (2, n_blocks, 2, 4, 8)
    jpool, tpool = {}, {}
    for name in ("k", "v"):
        if int8:
            q = rng.randint(-127, 128, size=shape).astype(np.int8)
            s = rng.rand(*shape[:-1]).astype(np.float32)
            jpool[name] = JKVQuant(jnp.asarray(q), jnp.asarray(s))
            tpool[name] = KVQuant(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
        else:
            x = rng.standard_normal(shape).astype(np.float32)
            jpool[name] = jnp.asarray(x)
            tpool[name] = torch.from_numpy(x.copy())
    return jpool, tpool


def _np_leaves(tree, jax_tree: bool) -> list:
    return ([np.asarray(x) for x in jax.tree.leaves(tree)] if jax_tree
            else [x.numpy() for x in TP.pool_leaves(tree)])


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_gather_scratch_blocks_matches_jax(int8):
    """The contiguous scratch of an out-of-order row is the JAX gather's,
    returned or written into a scratch in place; scatter_scratch inverts it."""
    jpool, tpool = _pools(int8)
    row = [5, 2, 7, 3]
    want = _np_leaves(JP.gather_scratch_blocks(jpool, jnp.asarray(row, jnp.int32)), True)
    got = TP.gather_scratch_blocks(tpool, torch.tensor(row, dtype=torch.int32))
    for g, w in zip(_np_leaves(got, False), want):
        np.testing.assert_array_equal(g, w)
    out = {n: (KVQuant(torch.zeros_like(x.q), torch.zeros_like(x.s))
               if isinstance(x, KVQuant) else torch.zeros_like(x)) for n, x in got.items()}
    ptrs = [x.data_ptr() for x in TP.pool_leaves(out)]
    assert TP.gather_scratch_blocks(tpool, torch.tensor(row, dtype=torch.int32),
                                    out=out) is out
    assert [x.data_ptr() for x in TP.pool_leaves(out)] == ptrs
    for g, w in zip(_np_leaves(out, False), want):
        np.testing.assert_array_equal(g, w)
    _, fresh = _pools(int8, seed=1)
    TP.scatter_scratch(fresh, out, torch.tensor(row, dtype=torch.int32))
    back = TP.gather_scratch_blocks(fresh, torch.tensor(row, dtype=torch.int32))
    for g, w in zip(_np_leaves(back, False), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_shadow_gather_and_restore_match_jax(int8):
    """gather_shadow_blocks ([N, L, KV, bs(, Dh)] per leaf, padding rows
    repeated) and restore_shadow_blocks (pad rows into the trash block)
    give the JAX functions' bytes in every block but the trash block (which
    of two colliding pad rows lands there is unspecified); the port writes
    the pool in place."""
    jpool, tpool = _pools(int8)
    ids = [3, 1, 3, 6]
    want = jax.tree.leaves(JP.gather_shadow_blocks(jpool, jnp.asarray(ids, jnp.int32)))
    got = TP.pool_leaves(TP.gather_shadow_blocks(tpool, torch.tensor(ids, dtype=torch.int32)))
    assert len(got) == len(want) == (4 if int8 else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # restore another pool's blocks 4, 2 into blocks 2 and 8, two pad rows
    # into the trash block
    jsrc, tsrc = _pools(int8, seed=2)
    src_ids = [4, 2, 4, 4]
    dst_ids = [2, 8, 0, 0]
    jblocks = JP.gather_shadow_blocks(jsrc, jnp.asarray(src_ids, jnp.int32))
    tblocks = TP.gather_shadow_blocks(tsrc, torch.tensor(src_ids, dtype=torch.int32))
    jout = JP.restore_shadow_blocks(jpool, jblocks, jnp.asarray(dst_ids, jnp.int32))
    ptrs = [x.data_ptr() for x in TP.pool_leaves(tpool)]
    tout = TP.restore_shadow_blocks(tpool, tblocks, torch.tensor(dst_ids, dtype=torch.int32))
    assert tout is tpool and [x.data_ptr() for x in TP.pool_leaves(tpool)] == ptrs
    for g, w in zip(_np_leaves(tout, False), _np_leaves(jout, True)):
        np.testing.assert_array_equal(g[:, 1:], w[:, 1:])


# -- the fleet: hits through both packages ------------------------------------

@pytest.fixture(scope="module")
def weights():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    return params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu"), \
        IdTokenizer()


_ENGINES: dict = {}


def _engines(weights, prefix=8, **ecfg):
    """(JAX engine, port engine) on the same weights and settings, built
    once per setting for the module."""
    key = (prefix, tuple(sorted(ecfg.items())))
    if key not in _ENGINES:
        params, tparams, tok = weights
        ecfg = dict(dict(prefill_buckets=(32, 64), prefix_cache_entries=prefix), **ecfg)
        jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                         engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
        teng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                             engine_cfg=EngineConfig(**ecfg), tokenizer=tok,
                             device="cpu")
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


def _cont(mod, eng, **kw):
    args = dict(n_slots=2, chunk_steps=4, slot_max_seq=192, kv_pool_blocks=40,
                kv_block_size=BS)
    args.update(kw)
    return mod.ContinuousEngine(eng, **args)


def _ids(r) -> list:
    """A greedy envelope's token ids (the IdTokenizer spells them)."""
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


def _wave(cont, prompts, **kw):
    out = [None] * len(prompts)

    def run(i):
        out[i] = cont.submit(prompts[i], **GEN, **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _queued_wave(mod, cont, prompts, **kw):
    """The prompts' envelopes, every request queued before the fleet's
    worker can admit any: they go in under the fleet's condition lock (a
    reentrant lock the worker takes to read the queue), so both packages'
    fleets see the one batch of admissions, whatever the threads' timing."""
    with cont._cv:
        reqs = [mod._Request(p, dict(GEN, **kw)) for p in prompts]
        for req in reqs:
            assert cont._enqueue(req) is None
    for req in reqs:
        assert req.done.wait(timeout=120)
    return [req.result for req in reqs]


def _clean(st) -> bool:
    pg = st["paged"]
    return pg["free_blocks"] + pg["cached_blocks"] == pg["pool_blocks"] - 1


def _serve(weights, mode, prompts, sequential=True, prefix=8, cont_kw=None, **kw):
    """The prompts through the JAX fleet, then the port's: {"jax": (results,
    stats), "port": (results, stats)}."""
    jeng, teng = _engines(weights, prefix=prefix, **MODES[mode])
    out = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        cont = _cont(mod, eng, **(cont_kw or {}))
        try:
            res = ([cont.submit(p, **GEN, **kw) for p in prompts] if sequential
                   else _wave(cont, prompts, **kw))
            out[name] = (res, cont.stats())
        finally:
            cont.close()
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_hit_vs_cold_bit_exact(weights, mode):
    """Prefix-hit admissions (mapped head + tail prefill) decode the JAX
    fleet's greedy ids at the JAX fleet's depths, and the port's cold fleet's
    ids: a hit is bit-equal to cold in fp32, a prompt diverging mid-block
    included."""
    mix = [SHARED + "first question", SHARED + "second question!",
           SHARED[: len(SHARED) // 2] + "diverges mid-stream from the rest",
           "no shared prefix at all"]
    out = _serve(weights, mode, mix, max_tokens=12)
    cold = _serve(weights, mode, mix, prefix=0, max_tokens=12)["port"][0]
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    for j, t, c in zip(jres, tres, cold):
        assert t["token_ids"] == _ids(j) == c["token_ids"]
    depths = [r.get("prefix_cached_tokens") for r in tres]
    assert depths == [r.get("prefix_cached_tokens") for r in jres]
    assert depths[1] >= BS and depths[1] % BS == 0 and depths[2] >= BS
    assert tst["prefix_cache"] == jst["prefix_cache"]
    assert tst["prefix_cache"]["hits"] >= 2
    assert tst["prefix_cache"]["dedup_saved_tokens"] >= 2 * BS
    assert _clean(tst) and _clean(jst)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_concurrent_sharing_matches_solo(weights, mode):
    """Concurrent tenants mapping the same chain (refcount > 1 on the head
    while several tables decode off it) decode the JAX fleet's ids, which
    are the solo engine's."""
    prompts = [SHARED + f"question number {i}" for i in range(6)]
    jeng, _ = _engines(weights, **MODES[mode])
    solo = [_ids(jeng.generate(p, **GEN, max_tokens=10)) for p in prompts]
    out = _serve(weights, mode, prompts, sequential=False, cont_kw=dict(n_slots=3),
                 max_tokens=10)
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    for j, t, s in zip(jres, tres, solo):
        assert t["token_ids"] == _ids(j) == s
    assert tst["prefix_cache"]["hits"] >= 1 and jst["prefix_cache"]["hits"] >= 1
    assert _clean(tst) and _clean(jst)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pool_exhaustion_with_shared_blocks_resident(weights, mode):
    """A pool too small for a new worst-case tenant PLUS the cached chains
    still serves everything: admission evicts unreferenced chains (never
    mapped ones), as often as the JAX fleet does; then four tenants at once
    over the same tight pool, live chains pinned while it churns."""
    longs = [f"p{i} " * 18 + "end" for i in range(3)]
    tight = dict(slot_max_seq=96, kv_pool_blocks=10)
    out = _serve(weights, mode, longs, cont_kw=tight, max_tokens=30)
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    for j, t in zip(jres, tres):
        assert t["token_ids"] == _ids(j)
    assert tst["prefix_cache"] == jst["prefix_cache"]
    assert tst["prefix_cache"]["evictions"] >= 1
    assert _clean(tst) and _clean(jst)
    out = _serve(weights, mode, PROMPTS, sequential=False,
                 cont_kw=dict(tight, n_slots=4), max_tokens=40)
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    for j, t in zip(jres, tres):
        assert t["token_ids"] == _ids(j)
    assert _clean(tst) and _clean(jst)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_blocked_release_frees_granted_blocks(weights, mode):
    """An admission that maps a cached head and then cannot get its fresh
    blocks (_BLOCKED) must give the head's references back: the retry finds
    the same free and shared counts, in both fleets, and the pool is clean."""
    jeng, teng = _engines(weights, **MODES[mode])
    seen = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        cont = _cont(mod, eng)
        try:
            _ids(cont.submit(SHARED + "q1", **GEN, max_tokens=6))
            real = cont._alloc_with_pressure
            calls = []

            def blocked_once(req, real=real, calls=calls, cont=cont):
                calls.append((cont._alloc.free_blocks, cont._alloc.shared_blocks))
                return None if len(calls) == 1 else real(req)

            cont._alloc_with_pressure = blocked_once
            r = cont.submit(SHARED + "q2", **GEN, max_tokens=6)
            seen[name] = (_ids(r), r.get("prefix_cached_tokens"), calls[:2],
                          _clean(cont.stats()))
        finally:
            cont.close()
    ids, depth, calls, clean = seen["port"]
    assert seen["port"] == seen["jax"]
    assert depth >= BS and calls[0][1] > 0  # the head was mapped (shared)
    assert calls[1] == calls[0] and clean


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sharing_disabled_without_prefix_entries(weights, mode):
    """prefix_cache_entries=0 keeps both fleets sharing-free: no index, no
    shadow, the full free list after completion."""
    out = _serve(weights, mode, [SHARED + "q"], prefix=0,
                 cont_kw=dict(slot_max_seq=96, kv_pool_blocks=16), max_tokens=8)
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    assert tres[0]["token_ids"] == _ids(jres[0])
    for st, r in ((jst, jres[0]), (tst, tres[0])):
        assert "prefix_cached_tokens" not in r
        assert st["paged"]["free_blocks"] == 15
        assert "prefix_cache" not in st and "shadow" not in st


def test_hit_depth_degrades_to_fit_buckets(weights):
    """Bucketed admission only: a hit whose deepest depth (96) leaves a tail
    no bucket fits inside the 128-token slot degrades one block at a time
    (80 cannot plan either) to 64, in both fleets, with the cold run's ids."""
    p = SHARED + "first question"
    flags = dict(prefill_buckets=(64,), ragged_prefill=False)
    jeng, teng = _engines(weights, **flags)
    _, tcold = _engines(weights, prefix=0, **flags)
    kw = dict(slot_max_seq=128)
    cold = _cont(TC, tcold, **kw)
    try:
        want = cold.submit(p, **GEN, max_tokens=10)["token_ids"]
    finally:
        cold.close()
    for mod, eng in ((JC, jeng), (TC, teng)):
        cont = _cont(mod, eng, **kw)
        try:
            first = cont.submit(p, **GEN, max_tokens=10)
            again = cont.submit(p, **GEN, max_tokens=10)
            st = cont.stats()
        finally:
            cont.close()
        assert "prefix_cached_tokens" not in first
        assert again["prefix_cached_tokens"] == 4 * BS
        assert _ids(first) == _ids(again) == want
        assert st["prefix_cache"]["dedup_saved_tokens"] == 4 * BS


def _head_digest(cont, ids) -> tuple:
    """The cached head's block ids for `ids` and a digest of their bytes in
    the port's pool."""
    p0, blocks, _ = cont._bpx.lookup(ids)
    h = hashlib.sha256()
    for leaf in TP.pool_leaves(cont.cache):
        h.update(leaf[:, blocks].contiguous().numpy().tobytes())
    return p0, blocks, h.hexdigest()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_shared_head_bytes_unchanged_across_a_wave(weights, mode):
    """A wave of concurrent hits with distinct tails reads the registered
    head and never writes it: its blocks' bytes are the same after the wave
    (tails, decode, launch padding and the trash go elsewhere), the wave's
    ids are the JAX fleet's hits behind the same head, and at idle only
    the index holds blocks. The four hits are queued before the worker
    can admit any, and one SLO class no CPU step can pressure slices
    their prompt chunks the same way in every run."""
    head = SHARED + "and the rest of a long common preamble "
    tails = [f"tail {i} " * (i + 1) for i in range(4)]
    _, teng = _engines(weights, **MODES[mode], **STEADY)
    cont = _cont(TC, teng, n_slots=4, kv_pool_blocks=60)
    try:
        _ids(cont.submit(head + "register", **GEN, max_tokens=4))
        ids = teng.tokenizer.encode(head + "x" * 40)
        p0, blocks, before = _head_digest(cont, ids)
        assert p0 >= 6 * BS
        got = _queued_wave(TC, cont, [head + t for t in tails], max_tokens=12)
        assert all(r["prefix_cached_tokens"] >= 6 * BS for r in got)
        assert _head_digest(cont, ids) == (p0, blocks, before)
        st = cont.stats()
        assert cont._alloc.outstanding == st["prefix_cache"]["cached_blocks"]
        assert _clean(st)
    finally:
        cont.close()
    # the JAX fleet's ids for the same prompts behind the same registered
    # head, served one at a time: its own wave of these four hits gives
    # other greedy tokens in about one process in three (ROADMAP Queue 3),
    # where its one-at-a-time service and the teacher-forced logits of
    # both packages agree with the port's wave
    jeng, _ = _engines(weights, **MODES[mode], **STEADY)
    jcont = _cont(JC, jeng, n_slots=4, kv_pool_blocks=60)
    try:
        jcont.submit(head + "register", **GEN, max_tokens=4)
        want = [jcont.submit(head + t, **GEN, max_tokens=12) for t in tails]
    finally:
        jcont.close()
    assert all(r["prefix_cached_tokens"] >= 6 * BS for r in want)
    assert [r["token_ids"] for r in got] == [_ids(r) for r in want]
