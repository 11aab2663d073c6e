"""PyTorch port vs JAX package: the paged runtime LoRA adapter pool.

test-llama-tiny in fp32 with no EOS, the JAX params (PRNGKey 0) carried
over by models/bridge.py, and PEFT adapter directories written from
seeded numpy factors by the port's `write_peft_adapter` (ranks 4 and 2
in a rank-4 pool, one BF16 file):

  * the pool units of tests/test_adapters.py on the port's AdapterPool
    (refcounts, the LRU, eviction never touching a referenced page,
    backpressure, reset_refs, registration checks, the leaves);
  * the layers with mixed `lora_pages` against the JAX layers, page-0
    rows bit-equal to the layers without adapter leaves; scripted
    `mixed_step_ragged` launches and a `decode_slots_paged` chunk with
    `pages`, against the JAX launches on the same operands;
  * the fleet against the JAX fleet on the same adapter mix: greedy ids
    equal (a threaded wave included), a base request bit-identical to a
    fleet without a pool, one adapter equal to merge-at-load, the
    rejections, a crash with adapters resident, an adapter victim's
    preemption, the block-prefix root per adapter, and the shadow and
    fabric fences;
  * the server routes of tests/test_adapters.py through both servers.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import adapters as JA  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import (  # noqa: E402
    SingleDeviceBackend as JaxBackend,
)
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import llama as JL  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import adapters as A  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import SingleDeviceBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models import lora as L  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    cache_from_numpy,
    params_from_numpy,
    slots_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402
from test_torch_continuous import IdTokenizer  # noqa: E402
from test_torch_lora import peft_factors  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
RANK = 4
KW = dict(max_tokens=8, greedy=True, chat=False)
PROMPTS = ["the quick brown fox jumps over the lazy dog",
           "pack my box with five dozen liquor jugs",
           "how vexingly quick daft zebras jump",
           "short"]
ENGINE = dict(prefix_cache_entries=0, prefill_buckets=(64, 128, 256), step_token_budget=64)
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16, restart_backoff_s=0.01)
# name -> (rank, seed, modules, write_peft_adapter keywords)
ADAPTERS = {
    "ad-a": (4, 1, None, dict(lora_alpha=8)),
    "ad-b": (2, 2, None, dict(lora_alpha=4, use_rslora=True)),
    "ad-c": (4, 3, ("q_proj", "v_proj", "down_proj"), dict(lora_alpha=8, bf16=True)),
}


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, port params, {adapter name: PEFT dir})."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    root = tmp_path_factory.mktemp("peft")
    dirs = {}
    for name, (rank, seed, modules, kw) in ADAPTERS.items():
        f = peft_factors(tcfg, rank, seed) if modules is None else \
            peft_factors(tcfg, rank, seed, modules)
        dirs[name] = L.write_peft_adapter(str(root / name), f, r=rank, **kw)
    return params, tparams, dirs


def _fleet(which, weights, adapters=2, names=("ad-a", "ad-b"), fleet_kw=None, **ecfg):
    """A fleet of either package on the same weights, with an adapter pool
    of `adapters` pages (0: none) holding `names`, attached before the
    fleet is built, as create_engine does."""
    params, tparams, dirs = weights
    ecfg = {**ENGINE, **ecfg}
    if which == "jax":
        eng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                        engine_cfg=JaxEngineConfig(**ecfg), tokenizer=IdTokenizer())
        attach, mod = JA.attach_adapter_pool, JC
    else:
        eng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                            engine_cfg=EngineConfig(**ecfg), tokenizer=IdTokenizer(),
                            device="cpu")
        attach, mod = A.attach_adapter_pool, TC
    if adapters:
        pool = attach(eng, slots=adapters, rank=RANK)
        for n in names:
            pool.register(n, dirs[n])
    return mod.ContinuousEngine(eng, **{**FLEET, **(fleet_kw or {})})


def _ids(r) -> list:
    """A greedy envelope's token ids (the IdTokenizer spells them)."""
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


def _wave(fleet, jobs, **kw):
    out = {}

    def run(job):
        p, ad = job
        extra = {"adapter": ad} if ad else {}
        out[job] = fleet.submit(p, **{**KW, **kw}, **extra)

    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


# -- pool units (no device work) ------------------------------------------------


class _FakeBackend:
    """Records page writes; the pool never reads them back."""

    def __init__(self):
        self.writes = []

    def write_adapter_page(self, page, updates):
        self.writes.append((page, tuple(sorted(updates))))


def _host(cfg, seed, rank=RANK):
    rng = np.random.default_rng(seed)
    return {leaf: ((rng.standard_normal((cfg.n_layers, i, rank)) * 0.05).astype(np.float32),
                   (rng.standard_normal((cfg.n_layers, rank, o)) * 0.05).astype(np.float32))
            for leaf, (i, o) in A.adapter_leaf_dims(cfg).items()}


@pytest.fixture
def cfg():
    return get_model_config(MODEL, **OVERRIDES)


def _pool(cfg, slots=2, **kw):
    return A.AdapterPool(cfg, _FakeBackend(), slots, RANK, **kw)


def test_pool_refcount_and_lru_eviction(cfg):
    pool = _pool(cfg, slots=2)
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        pool.register(name, _host(cfg, seed))
    pa = pool.acquire("a")
    assert pa in (1, 2)
    assert pool.acquire("a") == pa  # a second holder, same page, no write
    assert len(pool.backend.writes) == 1
    pb = pool.acquire("b")
    assert pb != pa
    assert pool.acquire("c") is None  # every page referenced: backpressure
    assert pool.free == 0
    pool.release("a")
    assert pool.acquire("c") is None  # a still has a holder
    pool.release("a")  # refcount 0: parked in the LRU, still resident
    assert pool.free == 1
    assert pool.acquire("c") == pa  # evicts a, reuses its page
    st = pool.stats()
    assert st["evictions"] == 1 and st["swaps"] == 1 and st["loads"] == 3
    assert pool.acquire("a") is None
    pool.release("b")
    assert pool.acquire("a") == pb  # evicts b, the only refcount-0 page
    pool.release("a")
    pool.release("c")
    assert pool.free == pool.total and pool.referenced() == 0
    assert pool.page_name(pa) == "c" and pool.page_name(pb) == "a"


def test_pool_acquire_unknown_adapter_raises(cfg):
    with pytest.raises(KeyError):
        _pool(cfg).acquire("never-registered")


def test_pool_over_release_clamps(cfg):
    pool = _pool(cfg)
    pool.register("a", _host(cfg, 1))
    page = pool.acquire("a")
    pool.release("a")
    pool.release("a")  # an accounting bug, logged, then clamped
    assert pool.referenced() == 0
    assert pool.acquire("a") == page
    assert len(pool.backend.writes) == 1


def test_pool_reset_refs_parks_residents(cfg):
    pool = _pool(cfg, slots=2)
    pool.register("a", _host(cfg, 1))
    pool.register("b", _host(cfg, 2))
    pa, pb = pool.acquire("a"), pool.acquire("b")
    pool.acquire("a")
    pool.reset_refs()
    assert pool.referenced() == 0 and pool.free == 2
    writes = len(pool.backend.writes)
    assert pool.acquire("a") == pa and pool.acquire("b") == pb
    assert len(pool.backend.writes) == writes  # nothing reloaded


def test_register_validation(cfg):
    pool = _pool(cfg)
    with pytest.raises(ValueError, match="non-empty"):
        pool.register("", _host(cfg, 1))
    with pytest.raises(ValueError, match="base model name"):
        pool.register(cfg.name, _host(cfg, 1))
    pool.register("a", _host(cfg, 1))
    with pytest.raises(ValueError, match="already registered"):
        pool.register("a", _host(cfg, 1))
    bad = dict(_host(cfg, 2), nope=_host(cfg, 2)["wq"])
    with pytest.raises(ValueError, match="no adapter leaves"):
        pool.register("b", bad)
    wrong = _host(cfg, 3)
    a, b = wrong["wq"]
    wrong["wq"] = (a[:, :, :-1], b)
    with pytest.raises(ValueError, match="do not match"):
        pool.register("c", wrong)
    assert pool.names() == ["a"] and pool.is_registered("a")


def test_register_rejects_the_merged_adapter(cfg, weights):
    dirs = weights[2]
    pool = _pool(cfg, merged_source=dirs["ad-a"])
    with pytest.raises(ValueError, match="already merged"):
        pool.register("tuned", dirs["ad-a"] + "/../ad-a")
    pool.register("other", dirs["ad-b"])  # another directory loads
    with pytest.raises(ValueError, match="exceeds the adapter pool rank"):
        A.AdapterPool(cfg, _FakeBackend(), 2, 2).register("a", dirs["ad-a"])


def test_install_leaves_and_pool_bytes_equal_jax(cfg, weights):
    params, tparams, _ = weights
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    jout = JA.install_adapter_leaves(jcfg, params, slots=2, rank=RANK)
    out = A.install_adapter_leaves(cfg, tparams, slots=2, rank=RANK)
    lora = sorted(k for k in out["layers"] if k.startswith("lora_"))
    assert lora == sorted(k for k in jout["layers"] if k.startswith("lora_"))
    assert len(lora) == 14
    for k in lora:
        assert tuple(out["layers"][k].shape) == jout["layers"][k].shape
        assert out["layers"][k].dtype == torch.float32 and not out["layers"][k].any()
    assert "lora_wq_a" not in tparams["layers"]
    with pytest.raises(ValueError, match="llama"):
        A.install_adapter_leaves(cfg.replace(arch="gpt2", n_kv_heads=cfg.n_heads),
                                 tparams, 2, RANK)
    with pytest.raises(ValueError, match="adapter_slots"):
        A.install_adapter_leaves(cfg, tparams, 0, RANK)
    with pytest.raises(ValueError, match="adapter_rank"):
        A.install_adapter_leaves(cfg, tparams, 2, 0)
    assert (A.AdapterPool(cfg, None, 3, 8).pool_bytes
            == JA.AdapterPool(jcfg, None, 3, 8).pool_bytes)
    with pytest.raises(ValueError, match="adapter_slots"):
        EngineConfig(adapter_slots=-1)
    with pytest.raises(ValueError, match="adapter_rank"):
        EngineConfig(adapter_slots=1, adapter_rank=0)


# -- the layers and the launches --------------------------------------------------


def _paged_params(weights, names=("ad-a", "ad-b"), slots=2):
    """Both packages' params with the lora leaves installed and `names`
    written into pages 1.. through each backend's write_adapter_page."""
    params, tparams, dirs = weights
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES), get_model_config(MODEL, **OVERRIDES)
    jbe = JaxBackend(jcfg, JA.install_adapter_leaves(jcfg, params, slots, RANK))
    tbe = SingleDeviceBackend(tcfg, A.install_adapter_leaves(tcfg, tparams, slots, RANK),
                              "cpu")
    for page, n in enumerate(names, start=1):
        host = L.load_lora_stacked(tcfg, dirs[n], RANK)
        jbe.write_adapter_page(page, host)
        tbe.write_adapter_page(page, host)
    for k, v in tbe.params["layers"].items():
        if k.startswith("lora_"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jbe.params["layers"][k]))
    return jcfg, jbe.params, tcfg, tbe.params


def test_layers_with_mixed_pages_equal_jax(weights):
    """forward_layers over a dense cache with rows on pages 0, 1, 2 and 1:
    within 1e-5 of the JAX layers; the page-0 row bit-equal to the layers
    without lora leaves at all, and every adapter row moved."""
    _, tparams, _ = weights
    jcfg, jparams, tcfg, pparams = _paged_params(weights)
    rng = np.random.default_rng(3)
    B, T = 4, 5
    x = (rng.standard_normal((B, T, tcfg.dim)) * 0.5).astype(np.float32)
    pages = np.array([0, 1, 2, 1], np.int32)
    jout, _ = JM.forward_layers(jcfg, jparams["layers"], jnp.asarray(x),
                                JM.init_kv_cache(jcfg, B, max_seq=16), 0,
                                lora_pages=jnp.asarray(pages))
    got, _ = M.forward_layers(tcfg, pparams["layers"], torch.from_numpy(x),
                              M.init_kv_cache(tcfg, B, max_seq=16), 0,
                              lora_pages=torch.from_numpy(pages))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    base, _ = M.forward_layers(tcfg, tparams["layers"], torch.from_numpy(x),
                               M.init_kv_cache(tcfg, B, max_seq=16), 0)
    assert torch.equal(got[0], base[0])
    for b in (1, 2, 3):
        assert not torch.allclose(got[b], base[b], atol=1e-4), b
    # the no-pages call on the paged params is the base program too
    nopages, _ = M.forward_layers(tcfg, pparams["layers"], torch.from_numpy(x),
                                  M.init_kv_cache(tcfg, B, max_seq=16), 0)
    assert torch.equal(nopages, base)
    # JAX's own page-0 row is its base row: the select holds in both
    jbase, _ = JL.forward_layers(jcfg, jax.tree.map(jnp.asarray, weights[0]["layers"]),
                                 jnp.asarray(x), JM.init_kv_cache(jcfg, B, max_seq=16), 0)
    np.testing.assert_array_equal(np.asarray(jout)[0], np.asarray(jbase)[0])


B, N_BLOCKS, BS, MB = 4, 32, 8, 6
W, TILE = 32, 8
PROMPT_LENS = {0: 10, 1: 5, 2: 20}
MAX_TOKENS = {0: 12, 1: 4, 2: 6}


@pytest.mark.parametrize("device_meta", [False, True], ids=["host_meta", "device_meta"])
def test_scripted_launches_with_pages_equal_jax(weights, device_meta):
    """test_torch_paged's script (two prompts land, decode beside a third
    prompt's chunks, then a decode chunk) with slots on pages 1, 0 and 2:
    packed results and state equal to the JAX launches, the pool within
    1e-5; the launches padding rides page 0."""
    jcfg, jparams, tcfg, tparams = _paged_params(weights)
    rng = np.random.default_rng(11)
    V = jcfg.vocab_size
    prompts = {s: rng.integers(3, V, n).astype(np.int32) for s, n in PROMPT_LENS.items()}
    table = np.zeros((B, MB), np.int32)
    table[:3] = (rng.permutation(N_BLOCKS - 1)[: 3 * MB] + 1).reshape(3, MB)
    pages = np.array([1, 0, 2, 0], np.int32)
    jpool = JP.init_pool(jcfg, N_BLOCKS, BS)
    tpool = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jpool), "cpu")
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = slots_from_numpy([np.asarray(a) for a in jstate],
                                   [np.asarray(a) for a in jsp], "cpu")
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    jpages, tpages = jnp.asarray(pages), torch.from_numpy(pages)

    def pool_close(what):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tpool[leaf].numpy()[:, 1:],
                                       np.asarray(jpool[leaf])[:, 1:], atol=1e-5,
                                       rtol=0, err_msg=f"{what}: {leaf}")

    launches = [([(0, 0, 10), (1, 0, 5)], []), ([(2, 0, 8)], [0, 1]),
                ([(2, 8, 8)], [0, 1]), ([(2, 16, 4)], [0, 1])]
    for li, (chunks, dec_slots) in enumerate(launches):
        tpos_now = tstate.pos.numpy()
        entries = [(s, 0 if device_meta else int(tpos_now[s]), 1, P.RAGGED_DECODE)
                   for s in dec_slots]
        entries += [(s, start, n, P.RAGGED_PREFILL) for s, start, n in chunks]
        meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W, tile=TILE)
        toks = np.zeros(W, np.int32)
        dec_flag = np.zeros(W, bool)
        dec_idx = np.zeros(B, np.int32)
        for s, off in zip(dec_slots, offsets):
            dec_flag[off] = True
            dec_idx[s] = off
        on = np.zeros(B, bool)
        idx, plen, mtk = (np.zeros(B, np.int32) for _ in range(3))
        for e, ((s, start, n), off) in enumerate(zip(chunks, offsets[len(dec_slots):])):
            toks[off: off + n] = prompts[s][start: start + n]
            if start + n == PROMPT_LENS[s]:
                on[s], idx[s] = True, off + n - 1
                plen[s], mtk[s] = PROMPT_LENS[s], MAX_TOKENS[s]
        sp = [np.ones(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32),
              np.ones(B, bool), np.zeros(B, np.float32), np.ones(B, np.float32),
              np.zeros(B, np.float32), np.zeros(B, np.float32)]
        presence = np.zeros((B, V), bool)
        jarm = JP.MixedArm(*(jnp.asarray(a) for a in (on, idx, plen, mtk)),
                           JG.SlotParams(*(jnp.asarray(a) for a in sp)), jnp.asarray(presence))
        tarm = P.MixedArm(*(torch.from_numpy(a) for a in (on, idx, plen, mtk)),
                          G.SlotParams(*(torch.from_numpy(a) for a in sp)),
                          torch.from_numpy(presence))
        jdev = tdev = None
        if device_meta:
            dev = P.build_device_meta(entries, offsets, len(dec_slots), width=W, tile=TILE)
            jdev = JP.DeviceMeta(*(jnp.asarray(a) for a in dev))
            tdev = P.DeviceMeta(*(torch.from_numpy(a) for a in dev))
        ops = (toks, tok_row, tok_pos, dec_flag, meta)
        jpacked, jstate, jsp, jpool = JP.mixed_step_ragged(
            jcfg, jparams, *(jnp.asarray(a) for a in ops), jpool, jtable, jstate, jsp,
            key, jnp.asarray(dec_idx), jarm, dev=jdev, pages=jpages)
        tpacked, tstate, tsp, tpool = P.mixed_step_ragged(
            tcfg, tparams, *(torch.from_numpy(a) for a in ops), tpool, ttable, tstate,
            tsp, gen, torch.from_numpy(dec_idx), tarm, dev=tdev, pages=tpages)
        what = f"launch {li + 1}"
        np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked), err_msg=what)
        for name, a, b in zip(G.SlotState._fields, jstate, tstate):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")
        pool_close(what)
    tok_pages = P._token_pages(tpages, torch.from_numpy(tok_row))
    assert tok_pages.tolist() == [int(pages[r]) if r >= 0 else 0 for r in tok_row]
    jem, jmask, jstate, jpool = JP.decode_slots_paged(
        jcfg, jparams, jstate, jpool, jtable, key, jsp, num_steps=4, pages=jpages)
    tem, tmask, tstate, tpool = P.decode_slots_paged(
        tcfg, tparams, tstate, tpool, ttable, gen, tsp, num_steps=4, pages=tpages)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    pool_close("decode chunk")


# -- the fleet ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleets(weights):
    """The JAX and the port fleet with pools of 2 pages and three adapters
    registered (a third one swaps a page in), and both without a pool."""
    names = ("ad-a", "ad-b", "ad-c")
    out = {"jax": _fleet("jax", weights, names=names),
           "port": _fleet("port", weights, names=names),
           "plain": _fleet("port", weights, adapters=0),
           "plain_jax": _fleet("jax", weights, adapters=0)}
    yield out
    for f in out.values():
        f.close()


JOBS = [(p, ad) for p in PROMPTS for ad in (None, "ad-a", "ad-b", "ad-c")]


@pytest.fixture(scope="module")
def jax_ids(weights):
    """The JAX fleet's greedy ids of every (prompt, adapter), one at a time,
    over a pool of a page per adapter: no page is reused, so each adapter's
    ids are its own (a JAX page swap keeps the evicted adapter's leaves that
    the incoming one does not target)."""
    names = ("ad-a", "ad-b", "ad-c")
    fleet = _fleet("jax", weights, adapters=len(names), names=names)
    try:
        return {(p, ad): _ids(fleet.submit(p, **KW, **({"adapter": ad} if ad else {})))
                for p, ad in JOBS}
    finally:
        fleet.close()


def test_fleet_greedy_ids_equal_jax(fleets, jax_ids):
    """Every (prompt, adapter) alone and inside a threaded mixed wave (three
    adapters over two pages: backpressure, then swaps; the wave in the
    unsheddable "batch" class): the greedy ids of the JAX fleet with a page
    per adapter. One at a time, `ad-c` (q, v and down only) takes the page
    of `ad-a` (every projection) for each prompt, and the page then holds
    `ad-c` alone: its other leaves are zero. The adapters move the output;
    afterwards no page is referenced and every block is back."""
    port = fleets["port"]
    pool = port.engine.adapters
    for job in JOBS:
        extra = {"adapter": job[1]} if job[1] else {}
        page_of = dict(pool._page_of)
        r = port.submit(job[0], **KW, **extra)
        assert r["token_ids"] == jax_ids[job], job
        assert r.get("adapter") == job[1]
        if job[1] == "ad-c":
            page = pool._page_of["ad-c"]
            assert page == page_of["ad-a"]
            layers = port.engine.backend.params["layers"]
            for leaf in ("wk", "wo", "w_gate", "w_up"):
                for s in ("a", "b"):
                    assert not layers[f"lora_{leaf}_{s}"][:, page].any(), (leaf, s)
    swaps = port.stats()["adapters"]["swaps"]
    # the "batch" class is never shed, so a loaded host cannot turn a
    # member of the wave into an slo_shed envelope
    got = _wave(port, JOBS, slo_class="batch")
    assert {j: r["token_ids"] for j, r in got.items()} == jax_ids
    assert port.stats()["adapters"]["swaps"] > swaps
    assert any(jax_ids[(p, "ad-a")] != jax_ids[(p, None)] for p in PROMPTS)
    st = port.stats()
    assert st["adapters"]["referenced"] == 0 and st["adapters"]["free"] == 2
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    # the JAX fleet's stats schema
    assert sorted(st["adapters"]) == sorted(fleets["jax"].stats()["adapters"])


def test_base_request_bit_identical_to_no_pool_fleet(fleets):
    """A base request on the pool fleet (page 0) emits the tokens of a fleet
    with no lora leaves at all, alone and beside adapter rows."""
    for p in PROMPTS:
        assert (fleets["port"].submit(p, **KW)["token_ids"]
                == fleets["plain"].submit(p, **KW)["token_ids"]), p
    jobs = [(PROMPTS[0], None), (PROMPTS[1], "ad-a"), (PROMPTS[2], "ad-b"), (PROMPTS[3], None)]
    got = _wave(fleets["port"], jobs)
    for p, ad in jobs:
        if ad is None:
            assert got[(p, ad)]["token_ids"] == fleets["plain"].submit(p, **KW)["token_ids"]


def test_single_adapter_equals_merge_at_load(weights, fleets):
    """The same adapter through a runtime page and merged at load
    (create_engine(lora=DIR)): the same greedy stream."""
    _, tparams, dirs = weights
    eng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                        lora=dirs["ad-a"], engine_cfg=EngineConfig(**ENGINE),
                        tokenizer=IdTokenizer(), device="cpu")
    merged = TC.ContinuousEngine(eng, **FLEET)
    try:
        for p in PROMPTS[:3]:
            assert (fleets["port"].submit(p, adapter="ad-a", **KW)["token_ids"]
                    == merged.submit(p, **KW)["token_ids"]), p
    finally:
        merged.close()


@pytest.mark.parametrize("case", ["unknown", "solo_contract", "no_pool", "stream_unknown"])
def test_adapter_request_rejections_equal_jax(fleets, case):
    """The 400 envelopes of the JAX fleet, key for key."""
    def call(fleet):
        if case == "unknown":
            return fleet.submit(PROMPTS[0], adapter="nope", **KW)
        if case == "solo_contract":
            return fleet.submit(PROMPTS[0], adapter="ad-a", seed=7, max_tokens=4, chat=False)
        if case == "stream_unknown":
            evs = list(fleet.stream(PROMPTS[0], adapter="nope", **KW))
            assert len(evs) == 1 and evs[0]["done"] is True
            return evs[0]
        return fleet.submit(PROMPTS[0], adapter="ad-a", **KW)

    want = call(fleets["jax"] if case != "no_pool" else fleets["plain_jax"])
    got = call(fleets["port"] if case != "no_pool" else fleets["plain"])
    assert got == want
    assert got["error_type"] == "invalid_request"


@pytest.mark.parametrize("which", ["jax", "port"])
def test_crash_with_adapters_resident_recovers(weights, which):
    """A transient decode fault with adapter pages referenced: the fleet
    rebuilds, the refcounts reset (reset_refs), every greedy stream comes
    back as the clean run's, no page is loaded again, and the pool's
    books are clean."""
    faults = jax_faults if which == "jax" else port_faults
    jobs = [(PROMPTS[0], None), (PROMPTS[1], "ad-a"), (PROMPTS[2], "ad-b")]

    def serve(rule):
        faults.disarm()
        fleet = _fleet(which, weights)
        try:
            fleet.submit("warm", **KW)
            fleet.submit("warm", adapter="ad-a", **KW)
            fleet.submit("warm", adapter="ad-b", **KW)
            loads = fleet.engine.adapters.stats()["loads"]
            if rule:
                faults.arm([faults.FaultRule("decode_launch", "transient", on_call=2)])
            out = _wave(fleet, jobs, max_tokens=12)
            faults.disarm()
            return ({j: _ids(r) for j, r in out.items()}, fleet.restarts_total,
                    fleet.engine.adapters.stats(), loads)
        finally:
            faults.disarm()
            fleet.close()

    clean, restarts0, _, _ = serve(False)
    assert restarts0 == 0
    got, restarts, st, loads = serve(True)
    assert restarts >= 1
    assert got == clean
    assert st["referenced"] == 0 and st["free"] == st["total"]
    assert st["loads"] == loads  # the pages survived the crash


def test_adapter_victim_preempted_recomputes(weights):
    """A tight pool with the KV shadow on: the adapter request A is
    preempted for B and resumes by recompute (its KV was never shadowed);
    both answer with the tokens of their unpressured runs, which are the
    JAX fleet's, and the books are clean."""
    tight = dict(n_slots=2, chunk_steps=2, slot_max_seq=64, kv_pool_blocks=10,
                 kv_block_size=8)
    ecfg = dict(prefix_cache_entries=4, prefill_buckets=(32, 64))
    a = ("the quick brown fox jumps over the", dict(max_tokens=24, greedy=True, chat=False))
    b = ("pack my box with five dozen liquor", dict(max_tokens=10, greedy=True, chat=False))
    ids = {}
    for which in ("jax", "port"):
        fleet = _fleet(which, weights, fleet_kw=dict(tight, kv_pool_blocks=40), **ecfg)
        try:
            ids[which] = (_ids(fleet.submit(a[0], adapter="ad-a", **a[1])),
                          _ids(fleet.submit(b[0], **b[1])))
        finally:
            fleet.close()
    assert ids["port"] == ids["jax"]
    fleet = _fleet("port", weights, fleet_kw=tight, **ecfg)
    try:
        out = {}
        ta = threading.Thread(target=lambda: out.__setitem__(
            "a", fleet.submit(a[0], adapter="ad-a", **a[1])))
        ta.start()
        t0 = time.time()
        while not any(r is not None and r.first_id is not None for r in fleet._assignment):
            assert time.time() - t0 < 60
            time.sleep(0.002)
        out["b"] = fleet.submit(b[0], **b[1])
        ta.join(timeout=120)
        assert out["a"].get("preempted", 0) >= 1, out["a"]
        assert (_ids(out["a"]), _ids(out["b"])) == ids["port"]
        st = fleet.stats()
        assert st["shadow"]["restored_blocks"] == 0
        assert st["adapters"]["referenced"] == 0
        assert st["preemption"]["preempted_total"] >= 1
    finally:
        fleet.close()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_prefix_chains_hang_under_the_adapter_root(weights, which):
    """The same prompt under the base, ad-a twice and ad-b on a fleet with
    the block-prefix cache: only the second ad-a request hits (its own
    root), with the tokens of its cold run; the counts are the JAX
    fleet's."""
    fleet = _fleet(which, weights, prefix_cache_entries=8)
    prompt = "the quick brown fox jumps over the lazy dog " * 3
    try:
        rs = [fleet.submit(prompt, **KW, **({"adapter": ad} if ad else {}))
              for ad in (None, "ad-a", "ad-a", "ad-b")]
    finally:
        fleet.close()
    hits = [r.get("prefix_cached_tokens", 0) for r in rs]
    assert hits[0] == hits[1] == hits[3] == 0 and hits[2] > 0, hits
    assert _ids(rs[2]) == _ids(rs[1])
    assert _ids(rs[1]) != _ids(rs[0]) or _ids(rs[3]) != _ids(rs[0])


def test_shadow_and_fabric_fences(weights):
    """On a fleet with the shadow and the fabric, an adapter request's KV is
    never shadowed, exports no digests and never fetches over the fabric
    (a hint naming a dead local peer), where a base request does each."""
    fleet = _fleet("port", weights, prefix_cache_entries=8)
    prompt = "sphinx of black quartz, judge my vow " * 3
    hint = {"peer": "http://127.0.0.1:9", "digest": "ab" * 32}
    try:
        copied0 = fleet.stats()["shadow"]["copied"]
        r = fleet.submit(prompt, adapter="ad-a", kv_hint=hint, **KW)
        assert r["status"] == "success" and "kv_digests" not in r
        fleet._shadow.flush(timeout_s=5.0)
        assert fleet.stats()["shadow"]["copied"] == copied0
        events = [e["kind"] for e in fleet.engine.flight.events()]
        assert "fabric_fetch" not in events
        r = fleet.submit(prompt, kv_hint=hint, **KW)
        assert r["status"] == "success" and r.get("kv_digests")
        fleet._shadow.flush(timeout_s=5.0)
        assert fleet.stats()["shadow"]["copied"] > copied0
        events = [e["kind"] for e in fleet.engine.flight.events()]
        assert "fabric_fetch" in events
    finally:
        fleet.close()


# -- the HTTP routes -------------------------------------------------------------


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(weights):
    """Both servers over a fleet with ad-a registered, and over one with no
    pool."""
    from distributed_llm_inference_tpu.serving.server import InferenceServer as JaxServer
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    out = {}
    for which, cls in (("jax", JaxServer), ("port", InferenceServer)):
        for pool in (1, 0):
            fleet = _fleet(which, weights, adapters=2 * pool,
                           names=("ad-a",) if pool else ())
            server = cls(fleet.engine, host="127.0.0.1", port=0, continuous=fleet)
            server.start()
            out[(which, pool)] = server
    yield out
    for server in out.values():
        server.shutdown()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_models_route_lists_adapters(served, which):
    port = served[(which, 1)].port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
        models = json.loads(r.read())
    ids = {m["id"]: m for m in models["data"]}
    assert MODEL in ids and "ad-a" in ids
    assert ids["ad-a"]["root"] == MODEL


@pytest.mark.parametrize("which", ["jax", "port"])
def test_generate_adapter_resolution(served, which):
    port = served[(which, 1)].port
    status, body = _post(port, "/generate", {"prompt": "hi there", "adapter": "ad-a",
                                             "max_tokens": 4, "greedy": True,
                                             "chat": False})
    assert status == 200 and body["status"] == "success" and body["adapter"] == "ad-a"
    status, body = _post(port, "/generate", {"prompt": "hi", "adapter": "nope",
                                             "max_tokens": 4})
    assert status == 400 and "unknown adapter" in body["error"]
    status, body = _post(port, "/generate", {"prompt": "hi", "adapter": 7, "max_tokens": 4})
    assert status == 400
    status, body = _post(port, "/generate", {"prompt": "hi", "adapter": MODEL,
                                             "max_tokens": 4, "greedy": True,
                                             "chat": False})
    assert status == 200 and body["status"] == "success" and "adapter" not in body


@pytest.mark.parametrize("which", ["jax", "port"])
def test_openai_model_resolves_to_adapter(served, which):
    port = served[(which, 1)].port
    status, body = _post(port, "/v1/completions",
                         {"model": "ad-a", "prompt": "hello", "max_tokens": 4})
    assert status == 200 and body["model"] == "ad-a"
    status, body = _post(port, "/v1/completions",
                         {"model": "not-registered", "prompt": "hello", "max_tokens": 4})
    assert status == 400 and "neither the base model" in body["error"]["message"]
    assert body["error"]["param"] == "model"
    status, body = _post(port, "/v1/completions",
                         {"model": MODEL, "prompt": "hello", "max_tokens": 4})
    assert status == 200 and body["model"] == MODEL


@pytest.mark.parametrize("which", ["jax", "port"])
def test_tenant_field_validation(served, which):
    port = served[(which, 1)].port
    assert _post(port, "/generate", {"prompt": "hi", "tenant": 12, "max_tokens": 4})[0] == 400
    assert _post(port, "/v1/completions", {"model": MODEL, "prompt": "hi", "tenant": 12,
                                           "max_tokens": 4})[0] == 400
    status, body = _post(port, "/generate", {"prompt": "hi", "tenant": "acme",
                                             "max_tokens": 4, "greedy": True,
                                             "chat": False})
    assert status == 200 and body["status"] == "success"


@pytest.mark.parametrize("which", ["jax", "port"])
def test_generate_adapter_without_pool_is_400(served, which):
    port = served[(which, 0)].port
    status, body = _post(port, "/generate", {"prompt": "hi", "adapter": "ad-a",
                                             "max_tokens": 4})
    assert status == 400
    assert "adapter serving is not configured" in body["error"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
        assert [m["id"] for m in json.loads(r.read())["data"]] == [MODEL]


def test_server_flags_parse_and_refuse_as_jax(weights):
    """The server's adapter flags: the same refusals at start as the JAX
    server's, before any model is built."""
    from distributed_llm_inference_tpu.serving import server as jax_server
    from distributed_llm_inference_tpu_torch.serving import server as port_server

    dirs = weights[2]
    base = ["--model", MODEL, "--device", "cpu"]
    for argv, msg in (
            (["--adapter", f"a={dirs['ad-a']}"], "needs --adapter-slots"),
            (["--adapter-slots", "2"], "needs --continuous"),
            (["--adapter-slots", "2", "--continuous", "2", "--kv-pool-blocks", "40",
              "--adapter", "nodir"], "expected NAME=DIR")):
        for mod, extra in ((port_server, base), (jax_server, ["--model", MODEL])):
            with pytest.raises(SystemExit, match=msg):
                mod.main(extra + argv)
