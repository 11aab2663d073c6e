"""PyTorch port vs JAX package: the KV shadow (warm crash recovery, drain
persistence, the disk tier) on the paged fleet.

The port's engine/shadow.py is a copy of the JAX store with its own
device->host edge (gathered tensors copied into pinned memory behind one
event; bf16 carried as its int16 view). The store cases of
tests/test_recovery.py and the local cases of tests/test_kv_tiers.py run
on port-made tensor leaves. Then the fleet cases of tests/test_recovery.py
and tests/test_kv_tiers.py run through the JAX ContinuousEngine and the
port's on the same weights (test-llama-tiny, fp32, no EOS, params bridged
through numpy; one JAX and one port fault plan, each armed alone): a crash
at every fault point, warm and cold, the double fault inside the restore,
an int8 pool, a drain persisting the shadow for a successor, a missing or
corrupt restore_dir, and the disk tier's promotion at admission and after
a restart. Each case holds the port to the JAX fleet's greedy ids,
restarts, restored blocks and recomputed tokens, and the pool's storage to
its own pointers across every restore path (the CUDA graphs read it).
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as TP  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import shadow as TS  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=256)
BS = 8  # kv_block_size of the recovery fleets
POOL = 48
PROMPT = "the quick brown fox jumps over the"  # not a BS multiple
GEN = dict(max_tokens=10, greedy=True, chat=False)
# the chaos matrix of tests/test_recovery.py: late enough that the request
# is mid-flight with its prompt blocks shadowed
_MATRIX_RULES = {
    "admission": dict(on_call=1),
    "prefill": dict(on_call=1),
    "decode_launch": dict(on_call=4),
    "fetch": dict(on_call=2),
    "shadow_copy": dict(on_call=1),
}


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


# -- the store, on port-made leaves -------------------------------------------

def _mk_leaves(n, tag=0.0, dtype=torch.float32):
    """One gathered batch as the port makes it: two stacked tensors of n
    blocks each (a data leaf and a scale-like leaf)."""
    return [torch.full((n, 2, 3), tag, dtype=dtype), torch.full((n, 2), tag, dtype=dtype)]


def _put_sync(store, keys, tag=0.0, seq=0, dtype=torch.float32):
    assert store.put_async(keys, _mk_leaves(len(keys), tag, dtype), seq)
    assert store.flush(5.0)


def test_shadow_store_chains_and_select():
    s = ShadowStore(2, max_blocks=16)
    try:
        k1, k2, k3 = (1, 2), (1, 2, 3, 4), (9, 9)
        _put_sync(s, [k1, k2, k3], tag=1.0)
        assert s.has(k1) and s.has(k2) and s.has(k3)
        assert not s.has((5, 5))
        entries, leaves = s.select(10)
        assert [k for k, _ in entries] == sorted([k1, k3, k2], key=len) or len(entries) == 3
        assert set(leaves) == {k2, k3}
        # a budget too small for the deep chain: the shorter chain still fits
        entries, _ = s.select(1)
        assert len(entries) == 1
    finally:
        s.close()


def test_shadow_store_lru_cascade_eviction():
    s = ShadowStore(2, max_blocks=2)
    try:
        _put_sync(s, [(1, 2)])
        _put_sync(s, [(1, 2, 3, 4)])
        # a new root evicts the LRU root and, with it, its child
        _put_sync(s, [(7, 8)])
        assert s.has((7, 8))
        assert not s.has((1, 2)) and not s.has((1, 2, 3, 4))
        assert s.stats()["evicted"] >= 2
    finally:
        s.close()


def test_shadow_store_backpressure_drops_never_blocks(monkeypatch):
    real = TS._host_array

    def slow(leaf):
        time.sleep(0.3)
        return real(leaf)

    monkeypatch.setattr(TS, "_host_array", slow)
    s = ShadowStore(2, max_blocks=16, max_pending=1)
    try:
        assert s.put_async([(1, 1)], _mk_leaves(1), 0)  # the copier busy 0.6 s
        t0 = time.time()
        while s._q and time.time() - t0 < 5:  # the copier took it
            time.sleep(0.005)
        t0 = time.time()
        s.put_async([(2, 2)], _mk_leaves(1), 0)  # queued (len 1)
        ok3 = s.put_async([(3, 3)], _mk_leaves(1), 0)  # full -> dropped
        assert time.time() - t0 < 0.25  # never blocked on the copier
        assert ok3 is False
        assert s.flush(10.0)
        assert s.stats()["dropped"] >= 1
        assert s.has((1, 1)) and s.has((2, 2)) and not s.has((3, 3))
    finally:
        s.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_shadow_store_save_load_round_trip(tmp_path, dtype):
    """Landed leaves are numpy, bf16 as its int16 view (no numpy bf16 on
    the card's machine); save / load keeps them and their seq bit-exact,
    and they view back to the tensors that went in."""
    s = ShadowStore(2, max_blocks=16)
    try:
        _put_sync(s, [(1, 2), (1, 2, 3, 4), (9, 9)], tag=7.0, seq=42, dtype=dtype)
        assert s.save(str(tmp_path)) == 3
    finally:
        s.close()
    t = ShadowStore(2, max_blocks=16)
    try:
        assert t.load(str(tmp_path)) == 3
        assert t.has((1, 2, 3, 4)) and t.has((9, 9))
        data = dict(t.select(10)[0])
        leaf = data[(1, 2)].leaves[0]
        assert leaf.dtype == (np.int16 if dtype == torch.bfloat16
                              else torch.empty(0, dtype=dtype).numpy().dtype)
        back = torch.from_numpy(leaf)
        if dtype == torch.bfloat16:
            back = back.view(torch.bfloat16)
        assert torch.equal(back, torch.full((2, 3), 7.0, dtype=dtype))
        assert data[(1, 2)].seq == 42
    finally:
        t.close()
    u = ShadowStore(4, max_blocks=16)  # another block size: refused, cold
    try:
        assert u.load(str(tmp_path)) == 0
    finally:
        u.close()


# -- the disk tier (tests/test_kv_tiers.py's local cases) ----------------------

class _E:
    def __init__(self, leaves):
        self.leaves = leaves


def _chain(n_blocks: int, bs: int = 4, base: int = 1):
    """A chain of n full blocks with per-block host leaves (as put_host and
    the landed copier hold them: numpy, an fp32 and an int8 leaf)."""
    ids = [(base + i) % 250 + 1 for i in range(n_blocks * bs)]
    keys = [tuple(ids[: (i + 1) * bs]) for i in range(n_blocks)]
    entries = [_E([np.full((2, 3), i + base, np.float32),
                   (np.arange(6, dtype=np.int8) + i).reshape(2, 3)])
               for i in range(n_blocks)]
    return ids, keys, entries


def _store(tmp_path, **kw):
    kw.setdefault("max_blocks", 4)
    kw.setdefault("disk_dir", str(tmp_path / "kvdisk"))
    return ShadowStore(4, **kw)


def test_host_eviction_demotes_to_disk_and_promotes_back(tmp_path):
    st = _store(tmp_path)
    try:
        _, keys_a, entries_a = _chain(4, base=1)
        st.put_host(keys_a, [e.leaves for e in entries_a], seq=0)
        _, keys_b, entries_b = _chain(4, base=101)
        st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
        s = st.stats()
        assert s["demoted"] == 4 and s["disk_blocks"] == 4
        assert all(st.has_resident(k) for k in keys_a)
        assert len(glob.glob(os.path.join(st.disk_dir, "chunk_*.npz"))) == 4
        got = st.entries_for(keys_a)  # the admission's promotion read
        assert got is not None
        for e, ref in zip(got, entries_a):
            np.testing.assert_array_equal(e.leaves[0], ref.leaves[0])
            np.testing.assert_array_equal(e.leaves[1], ref.leaves[1])
            assert e.leaves[1].dtype == np.int8
        s = st.stats()
        assert s["disk_hits"] == 4 and s["promoted"] >= 4
    finally:
        st.close()


def test_no_disk_dir_keeps_drop_semantics(tmp_path):
    st = ShadowStore(4, max_blocks=4)
    try:
        _, keys_a, entries_a = _chain(4, base=1)
        st.put_host(keys_a, [e.leaves for e in entries_a], seq=0)
        _, keys_b, entries_b = _chain(4, base=101)
        st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
        assert st.entries_for(keys_a) is None
        assert st.stats()["demoted"] == 0
    finally:
        st.close()


def test_disk_scan_rebuilds_index_across_restart(tmp_path):
    st = _store(tmp_path)
    _, keys, entries = _chain(3, base=7)
    st.put_host(keys, [e.leaves for e in entries], seq=3)
    _, keys_b, entries_b = _chain(4, base=201)
    st.put_host(keys_b, [e.leaves for e in entries_b], seq=4)  # demotes the first
    st.close()
    st2 = _store(tmp_path)
    try:
        assert st2.stats()["disk_blocks"] >= 3
        got = st2.entries_for(keys)
        assert got is not None
        np.testing.assert_array_equal(got[1].leaves[0], entries[1].leaves[0])
    finally:
        st2.close()


def test_disk_scan_deletes_orphans_and_junk(tmp_path):
    st = _store(tmp_path)
    _, keys, entries = _chain(3, base=7)
    st.put_host(keys, [e.leaves for e in entries], seq=0)
    _, keys_b, entries_b = _chain(4, base=201)
    st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
    d = st.disk_dir
    root_digest = st.digest_of(keys[0])
    st.close()
    os.remove(os.path.join(d, f"chunk_{root_digest}.npz"))
    with open(os.path.join(d, "chunk_deadbeef00.npz"), "wb") as f:
        f.write(b"junk, not an npz")
    st2 = _store(tmp_path)
    try:
        assert all(st2.digest_tier(st2.digest_of(k)) is None for k in keys)
        assert "chunk_deadbeef00.npz" not in os.listdir(d)
        assert st2.stats()["disk_rejected"] >= 1
    finally:
        st2.close()


def test_disk_lru_bound_cascades_subtrees(tmp_path):
    st = _store(tmp_path, max_blocks=2, max_disk_blocks=4)
    try:
        chains = []
        for base in (1, 61, 121, 181):
            _, keys, entries = _chain(2, base=base)
            st.put_host(keys, [e.leaves for e in entries], seq=base)
            chains.append(keys)
        s = st.stats()
        assert s["disk_blocks"] <= 4
        assert all(st.digest_tier(st.digest_of(k)) is None for k in chains[0])
        for keys in chains:  # whole chains on disk, or none of a chain
            on_disk = [k for k in keys if st.digest_tier(st.digest_of(k)) == "disk"]
            assert len(on_disk) in (0, len(keys))
        assert len(glob.glob(os.path.join(st.disk_dir, "chunk_*.npz"))) == s["disk_blocks"]
    finally:
        st.close()


def test_copier_backpressure_spills_to_disk_not_drop(tmp_path):
    """put_async past max_pending lands a batch straight in tier 2 (a
    demotion); only a doubly-full queue drops. Sentinels appended without
    a notify hold the depth until put_async's own notify."""
    st = _store(tmp_path, max_blocks=64, max_pending=1)
    try:
        with st._lock:
            st._q.append(([], TS._HostCopy([]), 0, False))
        _, keys, _ = _chain(1, base=31)
        assert st.put_async(keys, _mk_leaves(1, 3.0), seq=0)  # a spill
        assert st.flush(10.0)
        assert st.stats()["dropped"] == 0 and st.stats()["demoted"] == 1
        assert st.digest_tier(st.digest_of(keys[0])) == "disk"
        with st._lock:
            st._q.append(([], TS._HostCopy([]), 0, False))
            st._q.append(([], TS._HostCopy([]), 0, False))
        assert not st.put_async([(9, 9, 9, 9)], _mk_leaves(1), seq=0)
        assert st.stats()["dropped"] == 1
    finally:
        st.close()


def test_select_spans_disk_tier(tmp_path):
    st = _store(tmp_path, max_blocks=2)
    try:
        _, keys, entries = _chain(2, base=1)
        st.put_host(keys, [e.leaves for e in entries], seq=0)
        _, keys_b, entries_b = _chain(2, base=61)
        st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
        sel, leaf_keys = st.select(4)  # the host chain (b) and the disk chain (a)
        got_keys = [k for k, _ in sel]
        assert set(got_keys) == set(keys) | set(keys_b)
        assert sorted(map(len, got_keys)) == [len(k) for k, _ in sel]
        assert set(leaf_keys) == {keys[-1], keys_b[-1]}
        assert {k for k, _ in st.select(2)[0]} == set(keys_b)  # MRU first
    finally:
        st.close()


@pytest.mark.parametrize("tamper", ["truncate", "tokens", "block_size"])
def test_corrupt_chunk_file_rejects_into_miss(tmp_path, tamper):
    """A truncated, token-tampered or wrong-block-size chunk file is
    rejected and deleted on load: the lookup misses (a cold re-prefill),
    never wrong KV."""
    st = _store(tmp_path)
    try:
        _, keys, entries = _chain(2, base=1)
        st.put_host(keys, [e.leaves for e in entries], seq=0)
        _, keys_b, entries_b = _chain(4, base=101)
        st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
        deep = st.digest_of(keys[-1])
        path = os.path.join(st.disk_dir, f"chunk_{deep}.npz")
        assert st.digest_tier(deep) == "disk" and os.path.exists(path)
        if tamper == "truncate":
            data = open(path, "rb").read()
            with open(path, "wb") as f:
                f.write(data[: len(data) // 2])
        else:
            with np.load(path, allow_pickle=False) as z:
                manifest = json.loads(str(z["manifest"]))
                arrays = {k: np.array(z[k]) for k in z.files if k != "manifest"}
            if tamper == "tokens":
                manifest["t"][0] = (manifest["t"][0] % 250) + 1
            else:
                manifest["block_size"] = 8
            arrays["manifest"] = np.array(json.dumps(manifest))
            with open(path, "wb") as f:
                np.savez(f, **arrays)
        before = st.stats()["disk_rejected"]
        assert st.entries_for(keys) is None  # a miss, not an error
        assert st.stats()["disk_rejected"] == before + 1
        assert not os.path.exists(path) and st.digest_tier(deep) is None
    finally:
        st.close()


# -- the fleet: warm against cold, through both packages -----------------------

@pytest.fixture(scope="module")
def weights():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    return params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu"), \
        IdTokenizer()


_ENGINES: dict = {}


def _engines(weights, kv_quant=None, **ecfg):
    """(JAX engine, port engine) on the same weights, built once per
    setting for the module."""
    key = (kv_quant, tuple(sorted(ecfg.items())))
    if key not in _ENGINES:
        params, tparams, tok = weights
        over = dict(OVERRIDES, **({"kv_quant": kv_quant} if kv_quant else {}))
        ecfg = dict(dict(prefill_buckets=(32, 64), prefix_cache_entries=8), **ecfg)
        jeng = JaxEngine(jax_cfg(MODEL, **over), params=params,
                         engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
        teng = create_engine(get_model_config(MODEL, **over), params=tparams,
                             engine_cfg=EngineConfig(**ecfg), tokenizer=tok,
                             device="cpu")
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


def _cont(mod, eng, warm=True, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("kv_pool_blocks", POOL)
    kw.setdefault("kv_block_size", BS)
    return mod.ContinuousEngine(eng, kv_shadow=warm, **kw)


def _ctr(eng, name) -> float:
    """A counter family's total over its series, in either package."""
    if hasattr(eng.metrics, "snapshot"):
        snap = eng.metrics.snapshot()
        return sum(s["value"] for s in snap.get(name, {}).get("series", []))
    fam = eng.metrics.get(name)
    return 0.0 if fam is None else sum(c.value for _, c in fam._items())


def _ids(r) -> list:
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


def _pool_ptrs(cont) -> list:
    return [t.data_ptr() for t in TP.pool_leaves(cont.cache)]


def _clean(cont) -> bool:
    st = cont.stats()["paged"]
    return st["free_blocks"] + st["cached_blocks"] == st["pool_blocks"] - 1


def _quiesce(cont, timeout=30.0):
    """Wait until the fleet's worker parks on its condition with nothing in
    flight: a launch of the clean serve still unfetched would otherwise
    count toward the armed fault's calls, at a time that depends on the
    host."""
    t0 = time.time()
    while not cont._cv._waiters:
        assert time.time() - t0 < timeout, "the fleet never went idle"
        time.sleep(0.002)


def _crash_run(mod, fm, eng, rules, warm=True, **kw):
    """One clean serve (it fills the shadow), then the same prompt under the
    fault rules: what the second serve and the fleet report."""
    cont = _cont(mod, eng, warm=warm, **kw)
    try:
        r0 = cont.submit(PROMPT, **GEN)
        if cont._shadow is not None:
            assert cont._shadow.flush(10.0)
        ptrs = _pool_ptrs(cont) if mod is TC else None
        base = _ctr(eng, "dli_recovery_tokens_recomputed_total")
        _quiesce(cont)
        fm.arm([fm.FaultRule(*rule, **opts) for rule, opts in rules])
        r1 = cont.submit(PROMPT, **GEN)
        fm.disarm()
        if ptrs is not None:
            # every restore wrote the static pool in place
            assert _pool_ptrs(cont) == ptrs
        return dict(first=_ids(r0), ids=_ids(r1), status=r1["status"],
                    recovered=r1.get("recovered"), restarts=cont.restarts_total,
                    restored=cont.shadow_restored_total,
                    recomputed=_ctr(eng, "dli_recovery_tokens_recomputed_total") - base,
                    ready=cont.stats()["supervisor"]["ready"], clean=_clean(cont))
    finally:
        fm.disarm()
        cont.close()


def _both(weights, rules, warm=True, kv_quant=None, **kw):
    jeng, teng = _engines(weights, kv_quant=kv_quant)
    return (_crash_run(JC, jax_faults, jeng, rules, warm, **kw),
            _crash_run(TC, port_faults, teng, rules, warm, **kw))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("point", sorted(_MATRIX_RULES))
def test_crash_matrix_warm_vs_cold(weights, point, warm):
    """A crash at each fault point, shadow on and off: the port's fleet
    reports what the JAX fleet reports (greedy ids, restarts, restored
    blocks, recomputed tokens), warm recovery re-prefills only the partial
    tail block and cold the whole sequence."""
    want, got = _both(weights, [((point, "transient"), _MATRIX_RULES[point])], warm)
    assert got == want
    assert got["ids"] == got["first"]
    if point == "shadow_copy" and not warm:
        assert got["restarts"] == 0  # no store: the point is never reached
        return
    assert got["restarts"] == 1 and got["ready"] and got["clean"]
    if warm:
        assert 0 < got["recomputed"] < BS and got["restored"] > 0
    else:
        assert got["recomputed"] > 2 * BS and got["restored"] == 0


def test_double_fault_crash_during_restore(weights):
    """A second crash inside the restore is contained like any crash: the
    index is cleared, the pool zeroed again in place and the restore
    retried; two restarts, the JAX fleet's ids and restored blocks."""
    rules = [(("decode_launch", "transient"), dict(on_call=4)),
             (("shadow_copy", "transient"), dict(match="restore", on_call=1))]
    want, got = _both(weights, rules)
    assert got == want
    assert got["restarts"] == 2 and got["restored"] > 0 and got["ids"] == got["first"]
    assert got["ready"] and got["clean"]


def test_warm_beats_cold_on_recompute(weights):
    rules = [(("decode_launch", "transient"), dict(on_call=4))]
    costs = {warm: _both(weights, rules, warm)[1]["recomputed"] for warm in (True, False)}
    assert costs[True] < costs[False], costs


def test_warm_recovery_int8_pool(weights):
    """An int8 pool's KVQuant leaves (int8 blocks and fp32 scales) gather,
    land and restore through the same code: warm and bit-exact, as in the
    JAX fleet."""
    rules = [(("decode_launch", "transient"), dict(on_call=4))]
    want, got = _both(weights, rules, kv_quant="int8")
    assert got == want
    assert got["restarts"] == 1 and got["restored"] > 0
    assert 0 < got["recomputed"] < BS and got["ids"] == got["first"]


def test_drain_persists_and_restore_dir_warms_successor(weights, tmp_path):
    """A drain writes the shadow to restore_dir; a successor fleet started
    on it restores before serving, so the prompt hits at once at the JAX
    successor's depth, with the same greedy ids."""
    jeng, teng = _engines(weights)
    seen = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        d = str(tmp_path / name)
        cont1 = _cont(mod, eng, restore_dir=d)
        try:
            first = _ids(cont1.submit(PROMPT, **GEN))
            assert cont1._shadow.flush(10.0)
            assert cont1.drain(deadline_s=30.0) is True
        finally:
            cont1.close()
        assert os.path.exists(os.path.join(d, "shadow.npz"))
        cont2 = _cont(mod, eng, restore_dir=d)
        try:
            ptrs = _pool_ptrs(cont2) if mod is TC else None
            t0 = time.time()
            while cont2.shadow_restored_total == 0 and time.time() - t0 < 10:
                time.sleep(0.02)
            r = cont2.submit(PROMPT, **GEN)
            if ptrs is not None:
                assert _pool_ptrs(cont2) == ptrs
            seen[name] = (first, _ids(r), r.get("prefix_cached_tokens"),
                          cont2.stats()["shadow"]["restored_blocks"])
        finally:
            cont2.close()
    assert seen["port"] == seen["jax"]
    first, ids, depth, restored = seen["port"]
    assert ids == first and depth >= 2 * BS and restored > 0


def test_restore_dir_missing_or_invalid_starts_cold(weights, tmp_path):
    """A missing or corrupt persisted shadow is a cold start, never an
    error, in both fleets."""
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "shadow.npz").write_bytes(b"not an npz at all")
    jeng, teng = _engines(weights)
    for mod, eng in ((JC, jeng), (TC, teng)):
        for d in (str(tmp_path / "nothing-here"), str(bad)):
            cont = _cont(mod, eng, restore_dir=d)
            try:
                r = cont.submit(PROMPT, max_tokens=4, greedy=True, chat=False)
                assert r["status"] == "success"
                assert cont.shadow_restored_total == 0
            finally:
                cont.close()


def test_crash_writes_flight_next_to_restore_dir(weights, tmp_path):
    """A crash on a fleet with a restore_dir persists the flight recorder's
    ring there (flight_crash.json, ending in the crash), as the JAX
    supervisor does."""
    jeng, teng = _engines(weights)
    for name, mod, fm, eng in (("jax", JC, jax_faults, jeng),
                               ("port", TC, port_faults, teng)):
        d = tmp_path / name
        cont = _cont(mod, eng, restore_dir=str(d))
        try:
            _quiesce(cont)
            fm.arm([fm.FaultRule("decode_launch", "transient", on_call=2)])
            assert cont.submit(PROMPT, **GEN)["status"] == "success"
        finally:
            fm.disarm()
            cont.close()
        dump = json.loads((d / "flight_crash.json").read_text())
        assert dump["consecutive"] == 1 and "simulated" in dump["error"]
        assert dump["events"][-1]["kind"] == "crash"


# -- the disk tier through the fleet -------------------------------------------

TIER_PROMPT = "tiered cache workload preamble " * 3 + "tail one!"
TIER_BS = 16


def _demote_all(cont):
    """Every host-tier entry to the disk tier (the LRU under pressure)."""
    with cont._shadow._lock:
        for k in list(cont._shadow._entries):
            cont._shadow._evict_subtree_locked(k)
        cont._shadow._note_tiers_locked()


def _tier_cont(mod, eng):
    return _cont(mod, eng, kv_pool_blocks=48, kv_block_size=TIER_BS, slot_max_seq=192)


def test_disk_warm_admission_bit_identical(weights, tmp_path):
    """A chain demoted to DISK and dropped from the pool re-enters through
    promotion at admission (_promote_local_chain -> _import_fabric_chain,
    a `tier_promote` flight event): the JAX fleet's ids, promoted blocks and
    depth, the pool written in place."""
    seen = {}
    for name, mod in (("jax", JC), ("port", TC)):
        eng = _engines(weights, kv_disk_dir=str(tmp_path / name))[0 if mod is JC else 1]
        cont = _tier_cont(mod, eng)
        try:
            first = _ids(cont.submit(TIER_PROMPT, **GEN))
            assert cont._shadow.flush(10.0)
            _demote_all(cont)
            assert cont._shadow.stats()["disk_blocks"] >= 2
            cont._bpx.evict(10**9)
            ptrs = _pool_ptrs(cont) if mod is TC else None
            r = cont.submit(TIER_PROMPT, **GEN)
            if ptrs is not None:
                assert _pool_ptrs(cont) == ptrs
            s = cont._shadow.stats()
            kinds = [e["kind"] for e in eng.flight.dump()["events"]]
            seen[name] = (first, _ids(r), r.get("kv_promoted_blocks"),
                          r.get("prefix_cached_tokens"), s["disk_hits"], s["promoted"],
                          "tier_promote" in kinds)
        finally:
            cont.close()
    assert seen["port"] == seen["jax"]
    first, ids, promoted, depth, hits, _, event = seen["port"]
    assert ids == first and promoted >= 2 and depth >= 2 * TIER_BS
    assert hits >= 2 and event


def test_crash_restart_restores_from_disk_tier(weights, tmp_path):
    """The first fleet dies with its chains on disk (no drain, no save); a
    new fleet over the same kv_disk_dir rescans the tier and serves the
    prompt warm, with the JAX fleet's ids and promoted blocks."""
    seen = {}
    for name, mod in (("jax", JC), ("port", TC)):
        eng = _engines(weights, kv_disk_dir=str(tmp_path / name))[0 if mod is JC else 1]
        cont = _tier_cont(mod, eng)
        try:
            first = _ids(cont.submit(TIER_PROMPT, **GEN))
            assert cont._shadow.flush(10.0)
            _demote_all(cont)
        finally:
            cont.close()
        cont = _tier_cont(mod, eng)
        try:
            assert cont._shadow.stats()["disk_blocks"] >= 2
            r = cont.submit(TIER_PROMPT, **GEN)
            seen[name] = (first, _ids(r), r.get("kv_promoted_blocks"))
        finally:
            cont.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == seen["port"][0] and seen["port"][2] >= 2


# -- every restore path keeps the pool's storage ---------------------------------

def _count_calls(cont, names) -> dict:
    calls = {n: 0 for n in names}
    for name in names:
        inner = getattr(cont, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        setattr(cont, name, counted)
    return calls


def test_restores_write_the_pool_in_place(weights):
    """_restore_shadow (a warm restart), _import_fabric_chain (a tier
    promotion) and _prepare_resume (a warm "swap" resume) each restored
    blocks, and the pool leaves kept their storage throughout: every CUDA
    graph captured over the pool reads the restored bytes."""
    _, teng = _engines(weights)
    cont = _cont(TC, teng, kv_pool_blocks=16, slot_max_seq=64)
    calls = _count_calls(cont, ("_restore_shadow", "_import_fabric_chain"))
    try:
        ptrs = _pool_ptrs(cont)
        a = "the quick brown fox jumps over the lazy dog"
        _ids(cont.submit(a, **GEN))
        assert cont._shadow.flush(10.0)
        # a crash: the restart restores the shadow
        _quiesce(cont)
        port_faults.arm([port_faults.FaultRule("decode_launch", "transient", on_call=2)])
        _ids(cont.submit(a, **GEN))
        port_faults.disarm()
        assert cont.restarts_total == 1 and cont.shadow_restored_total > 0
        assert _pool_ptrs(cont) == ptrs
        # a promotion: the chain left the pool, the host tier still has it
        cont._bpx.evict(10**9)
        r = cont.submit(a, **GEN)
        assert r.get("kv_promoted_blocks", 0) >= 1 and _pool_ptrs(cont) == ptrs
    finally:
        port_faults.disarm()
        cont.close()
    assert all(calls.values()), calls
    # a warm swap on 12 usable blocks: the interactive B preempts the batch
    # A, which cannot preempt B back; A's resume waits for B, then restores
    # its shadowed chain (B's admission evicted it from the pool)
    cont = _cont(TC, teng, kv_pool_blocks=13, slot_max_seq=64)
    calls = _count_calls(cont, ("_prepare_resume",))
    try:
        ptrs = _pool_ptrs(cont)
        restored0 = _ctr(teng, "dli_shadow_restored_blocks_total")
        out = {}
        ta = threading.Thread(target=lambda: out.update(a=cont.submit(
            "pack my box with five dozen liquor jugs", max_tokens=40, greedy=True,
            chat=False, slo_class="batch")))
        ta.start()
        t0 = time.time()
        while not any(r is not None and r.first_id is not None for r in cont._assignment):
            assert time.time() - t0 < 60
            time.sleep(0.002)
        rb = cont.submit("sphinx of black quartz judge my vow now", max_tokens=20,
                         greedy=True, chat=False, slo_class="interactive")
        ta.join(timeout=120)
        assert out["a"]["status"] == rb["status"] == "success"
        assert out["a"].get("preempted", 0) >= 1
        assert _ctr(teng, "dli_shadow_restored_blocks_total") > restored0
        assert _pool_ptrs(cont) == ptrs and _clean(cont)
    finally:
        cont.close()
    assert calls["_prepare_resume"] >= 1


# -- the server: the flags' settings, /stats and the fabric's routes -----------

def test_server_reports_prefix_cache_and_shadow_and_501s_the_fabric(weights, tmp_path):
    """Both servers over a fleet with the prefix cache, the shadow and a
    disk tier: /stats `continuous.prefix_cache` and `continuous.shadow` with
    the JAX keys and, after the same two requests, the JAX hit counts; both
    serve the KV fabric (fabric_serving true, the JAX default wherever the
    shadow is) and answer its routes with the same codes: GET /kv 404 (no
    digest), GET /kv/{unknown digest} 404, POST /kv of a payload that is
    not a chain 400. /metrics carries the JAX names of the prefix, shadow,
    tier, recovery and fabric families."""
    import urllib.error
    import urllib.request

    from distributed_llm_inference_tpu.serving import server as JS
    from distributed_llm_inference_tpu_torch.serving import server as TSV

    def call(port, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    got = {}
    for name, S, mod in (("jax", JS, JC), ("port", TSV, TC)):
        eng = _engines(weights, kv_disk_dir=str(tmp_path / name))[0 if mod is JC else 1]
        fleet = _cont(mod, eng)
        srv = S.InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=64,
                                continuous=fleet)
        srv.start()
        try:
            for _ in range(2):
                code, r = call(srv.port, "/generate", dict(prompt=PROMPT, **GEN))
                assert code == 200, r
            st = call(srv.port, "/stats")[1]["continuous"]
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                        timeout=60) as m:
                families = {line.split()[2] for line in m.read().decode().splitlines()
                            if line.startswith("# TYPE dli_") and any(
                                k in line for k in ("prefix", "shadow", "kv_tier",
                                                    "recovery", "ragged_exact",
                                                    "kv_fabric"))}
            kv_codes = tuple(call(srv.port, path, body)[0] for path, body in
                             (("/kv", None), ("/kv/0123abcd", None), ("/kv", {})))
            got[name] = (st["prefix_cache"], set(st["shadow"]), st["shadow"]["disk_dir"],
                         r["prefix_cached_tokens"], fleet.fabric_serving, families,
                         kv_codes)
        finally:
            srv.shutdown()
    (jpc, jkeys, jdir, jdepth, jserving, jfam, jcodes), \
        (tpc, tkeys, tdir, tdepth, serving, tfam, tcodes) = got["jax"], got["port"]
    assert tfam == jfam and len(tfam) >= 21, sorted(jfam ^ tfam)
    assert tpc == jpc and tpc["hits"] == 1
    assert tkeys == jkeys and {"blocks", "restored_blocks", "disk_blocks"} <= tkeys
    assert tdepth == jdepth >= 2 * BS and tdir.endswith("port")
    assert serving is jserving is True
    assert tcodes == jcodes == (404, 404, 400)


def test_rebuild_zeroes_an_int8_pool_in_place(weights):
    """The supervisor's rebuild zeroes an int8 pool's KVQuant leaves (data
    and scales) in place, in one pass per tensor. It used to iterate the
    KVQuant, which slices it one index at a time down to 0-d scales: a
    restart of an int8 fleet zeroed nothing and took seconds on the CPU
    (minutes at tinyllama's pool on the card)."""
    _, teng = _engines(weights, kv_quant="int8")
    cont = _cont(TC, teng)
    try:
        leaves = TP.pool_leaves(cont.cache)
        ptrs = [t.data_ptr() for t in leaves]
        for t in leaves:
            t.fill_(3)
        t0 = time.perf_counter()
        TC._zero_tree(cont.cache)
        assert time.perf_counter() - t0 < 1.0
        assert all(not bool(t.any()) for t in leaves)
        assert [t.data_ptr() for t in TP.pool_leaves(cont.cache)] == ptrs
    finally:
        cont.close()
