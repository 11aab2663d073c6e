"""PyTorch port vs JAX package: KV preemption on the continuous paged fleet.

The cases of tests/test_preemption.py, run through the JAX ContinuousEngine
and the port's on the CPU with the same weights (test-llama-tiny, fp32, no
EOS, params from the reference's init_params carried over by
models/bridge.py), with no prefix cache in either ("swap" then recomputes)
unless a case says so: the warm swap case gives both fleets the
block-prefix cache and the KV shadow. A pool of 10
blocks of 8 tokens cannot hold the long request A (35 ids + 24 tokens) and
B (35 ids + 10) at once, so B can only be placed by preempting A: the
greedy token ids, the envelopes' `preempted` / `recovered`, the preemption
stats and a clean pool must be the JAX fleet's, and the tokens those of an
unpressured run."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.engine.scheduler import SLOClass as JaxSLOClass  # noqa: E402
from distributed_llm_inference_tpu.engine.scheduler import (  # noqa: E402
    TokenBudgetScheduler as JaxScheduler,
)
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.scheduler import SLOClass  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.scheduler import TokenBudgetScheduler  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
BS = 8  # kv_block_size for every fleet here
PROMPT_A = "the quick brown fox jumps over the"
PROMPT_B = "pack my box with five dozen liquor"
KW = dict(max_tokens=10, greedy=True, chat=False)
# the victim decodes LONG (and holds 8 of the 9 usable blocks)
KW_LONG = dict(max_tokens=24, greedy=True, chat=False)
# 9 usable blocks: A needs ceil(59 / 8) = 8, B ceil(45 / 8) = 6 > 1 free
TIGHT_POOL = 10
STORM = [PROMPT_A, PROMPT_B, "sphinx of black quartz judge my vow today",
         "how vexingly quick daft zebras jump now"]
# the crash drill of tests/test_preemption.py: a transient fault at each
# point lands inside the contended preempt / resume cycle
_CYCLE_RULES = {
    "preempt": dict(on_call=1),
    "admission": dict(on_call=3),
    "alloc": dict(on_call=3),
    "prefill": dict(on_call=2),
    "decode_launch": dict(on_call=6),
    "fetch": dict(on_call=4),
}


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


@pytest.fixture(scope="module")
def weights():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    return params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu"), \
        IdTokenizer()


def _engines(weights, **ecfg):
    """(JAX engine, port engine) on the same weights and settings."""
    params, tparams, tok = weights
    ecfg = dict(dict(prefill_buckets=(32, 64), prefix_cache_entries=0), **ecfg)
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
    teng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                         engine_cfg=EngineConfig(**ecfg), tokenizer=tok, device="cpu")
    return jeng, teng


def _cont(mod, eng, pool=TIGHT_POOL, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_steps", 2)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("slot_max_seq", 64)  # 8 blocks of BS
    return mod.ContinuousEngine(eng, kv_pool_blocks=pool, kv_block_size=BS, **kw)


def _ids(r) -> list:
    """A greedy envelope's token ids (the IdTokenizer spells them)."""
    return [int(t) for t in r["response"].split()]


def _wait(pred, timeout=30.0, what="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _pool_clean(cont) -> bool:
    st = cont.stats()["paged"]
    return st["free_blocks"] + st["cached_blocks"] == st["pool_blocks"] - 1


def _contended_pair(cont):
    """A (long decode) and B (admitted once A decodes, against a pool that
    cannot hold both) served concurrently: (result A, result B)."""
    out = {}

    def run(tag, prompt, kw):
        out[tag] = cont.submit(prompt, **kw)

    ta = threading.Thread(target=run, args=("a", PROMPT_A, KW_LONG))
    ta.start()
    # B arrives once A has fetched its first token, so that A's salvage
    # record (and with it `recovered`) never depends on the host's speed
    _wait(lambda: any(r is not None and r.first_id is not None
                      for r in cont._assignment), what="A decoding")
    tb = threading.Thread(target=run, args=("b", PROMPT_B, KW))
    tb.start()
    ta.join(timeout=120)
    tb.join(timeout=120)
    assert not ta.is_alive() and not tb.is_alive(), "requests hung"
    return out["a"], out["b"]


@pytest.fixture(scope="module")
def unpressured(weights):
    """Each prompt's greedy ids on a port fleet whose pool holds them all."""
    _, teng = _engines(weights)
    cont = _cont(TC, teng, pool=64, n_slots=4)
    try:
        return {p: _ids(cont.submit(p, **(KW_LONG if p == PROMPT_A else KW)))
                for p in STORM}
    finally:
        cont.close()


def _both_pairs(weights, **ecfg):
    """The contended pair through the JAX fleet, then the port's."""
    jeng, teng = _engines(weights, **ecfg)
    out = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        cont = _cont(mod, eng)
        try:
            out[name] = (*_contended_pair(cont), cont.stats(), _pool_clean(cont))
        finally:
            cont.close()
    return out


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_preempt_resume_bit_exact_as_in_jax(weights, unpressured, policy):
    """B preempts A in both fleets; both finish with the JAX fleet's greedy
    ids, which are the unpressured run's, and every block comes back."""
    out = _both_pairs(weights, preempt_policy=policy)
    (ja, jb, jst, jclean), (ta, tb, tst, tclean) = out["jax"], out["port"]
    for r in (ja, jb, ta, tb):
        assert r["status"] == "success", r
    assert ta["token_ids"] == _ids(ja) == unpressured[PROMPT_A]
    assert tb["token_ids"] == _ids(jb) == unpressured[PROMPT_B]
    assert jst["preemption"]["preempted_total"] >= 1
    assert tst["preemption"]["preempted_total"] >= 1
    assert jclean and tclean


def _restored(eng) -> float:
    """dli_shadow_restored_blocks_total in either package."""
    if hasattr(eng.metrics, "snapshot"):
        series = eng.metrics.snapshot().get("dli_shadow_restored_blocks_total", {})
        return sum(s["value"] for s in series.get("series", []))
    return sum(c.value for _, c in
               eng.metrics.get("dli_shadow_restored_blocks_total")._items())


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_preempt_resume_bit_exact_warm_as_in_jax(weights, unpressured, policy):
    """tests/test_preemption.py's test_preempt_resume_bit_exact, whose
    engines carry the block-prefix cache (prefix_cache_entries=8) and, under
    "swap", the KV shadow: the victim's filled blocks go to the shadow when
    it is preempted and its resume restores them (restored blocks rise, as
    many as in the JAX fleet); both finish with the unpressured ids and
    every block free or cached."""
    jeng, teng = _engines(weights, prefix_cache_entries=8, preempt_policy=policy)
    got = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        cont = _cont(mod, eng, kv_shadow=policy == "swap")
        try:
            restored0 = _restored(eng)
            ra, rb = _contended_pair(cont)
            got[name] = (ra, rb, cont.preempted_total, _restored(eng) - restored0,
                         _pool_clean(cont))
        finally:
            cont.close()
    (ja, jb, jn, jrest, jclean), (ta, tb, tn, trest, tclean) = got["jax"], got["port"]
    assert ta["token_ids"] == _ids(ja) == unpressured[PROMPT_A]
    assert tb["token_ids"] == _ids(jb) == unpressured[PROMPT_B]
    assert tn == jn >= 1 and trest == jrest and jclean and tclean
    if policy == "swap":
        assert trest > 0  # the victim's chain came back through the shadow
    else:
        assert trest == 0


def test_preempted_envelope_and_stats_as_in_jax(weights):
    """The victim's envelope carries `preempted` (and `recovered` when it
    had fetched tokens), with the JAX fleet's counts and the JAX stats keys;
    the resume latency histogram counts the resumes."""
    out = _both_pairs(weights)
    (ja, jb, jst, _), (ta, tb, tst, _) = out["jax"], out["port"]
    assert ta.get("preempted", 0) >= 1
    for key in ("preempted", "recovered"):
        assert ta.get(key) == ja.get(key), key
        assert tb.get(key) == jb.get(key), key
    assert tst["preemption"] == jst["preemption"]
    assert set(tst["supervisor"]) == set(jst["supervisor"])


def test_preempt_policy_off_waits_as_in_jax(weights, unpressured):
    """preempt_policy "off": B waits for A's release in both fleets."""
    out = _both_pairs(weights, preempt_policy="off")
    (ja, jb, jst, jclean), (ta, tb, tst, tclean) = out["jax"], out["port"]
    assert ta["token_ids"] == _ids(ja) == unpressured[PROMPT_A]
    assert tb["token_ids"] == _ids(jb) == unpressured[PROMPT_B]
    assert "preempted" not in ta and "preempted" not in ja
    assert tst["preemption"]["preempted_total"] == jst["preemption"]["preempted_total"] == 0
    assert jclean and tclean


def test_bad_preempt_policy_rejected_as_in_jax(weights):
    jeng, teng = _engines(weights, preempt_policy="sometimes")
    for mod, eng in ((JC, jeng), (TC, teng)):
        with pytest.raises(ValueError, match="preempt_policy"):
            _cont(mod, eng)


# -- victim selection: the same candidate lists through both schedulers --------

def _scheduler(port: bool):
    cls = SLOClass if port else JaxSLOClass
    classes = [cls("interactive", 0.5, 0.1, 4.0, True), cls("standard", 2.0, 0.5, 2.0, True),
               cls("batch", 30.0, 2.0, 1.0, False)]
    sched = (TokenBudgetScheduler if port else JaxScheduler)(
        {c.name: c for c in classes}, "standard", 128, 8, 2)
    return sched, {c.name: c for c in classes}


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_victim_order(port):
    """Lowest weight first, youngest within a tie, never a victim that
    outranks the beneficiary (equal weight is eligible)."""
    s, c = _scheduler(port)
    assert s.select_victim([("i", c["interactive"], 1.0), ("b", c["batch"], 2.0),
                            ("s", c["standard"], 3.0)], c["interactive"]) == "b"
    assert s.select_victim([("old", c["standard"], 1.0), ("young", c["standard"], 9.0)],
                           c["standard"]) == "young"
    assert s.select_victim([("i", c["interactive"], 1.0), ("s", c["standard"], 2.0)],
                           c["batch"]) is None
    assert s.select_victim([("b2", c["batch"], 5.0)], c["batch"]) == "b2"


def test_victim_cap_respected_as_in_jax(weights, unpressured):
    """max_preemptions_per_req=0: every request immune from the start, so
    both fleets wait instead (the same ids, no preemption)."""
    out = _both_pairs(weights, max_preemptions_per_req=0)
    (ja, jb, jst, _), (ta, tb, tst, _) = out["jax"], out["port"]
    assert ta["token_ids"] == _ids(ja) == unpressured[PROMPT_A]
    assert tb["token_ids"] == _ids(jb) == unpressured[PROMPT_B]
    assert tst["preemption"]["preempted_total"] == jst["preemption"]["preempted_total"] == 0


def test_preemption_storm_all_complete_as_in_jax(weights, unpressured):
    """Four requests against a pool that holds about one: repeated
    preemption, every request completes with the JAX fleet's ids (the
    unpressured ones) and the books balance in both fleets."""
    jeng, teng = _engines(weights)
    got = {}
    for name, mod, eng in (("jax", JC, jeng), ("port", TC, teng)):
        cont = _cont(mod, eng, n_slots=4)
        try:
            out = {}

            def run(p, cont=cont, out=out):
                out[p] = cont.submit(p, **KW)

            threads = [threading.Thread(target=run, args=(p,)) for p in STORM]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
                assert not t.is_alive(), f"{name}: storm request hung"
            assert _pool_clean(cont), name
            got[name] = out
        finally:
            cont.close()
    for p in STORM:
        assert got["port"][p]["status"] == got["jax"][p]["status"] == "success"
        want = unpressured[p][:KW["max_tokens"]]
        assert got["port"][p]["token_ids"] == _ids(got["jax"][p]) == want, p


@pytest.mark.parametrize("point", sorted(_CYCLE_RULES))
def test_crash_during_preempt_cycle_as_in_jax(weights, unpressured, point):
    """A transient crash anywhere in the contended preempt / resume cycle,
    the preempt hook included, is contained by both supervisors: both
    requests finish with the JAX fleet's ids, the pool is clean, the fleet
    ready."""
    jeng, teng = _engines(weights)
    got = {}
    for name, mod, fm, eng in (("jax", JC, jax_faults, jeng),
                               ("port", TC, port_faults, teng)):
        cont = _cont(mod, eng)
        try:
            fm.arm([fm.FaultRule(point, "transient", **_CYCLE_RULES[point])])
            got[name] = _contended_pair(cont)
            fm.disarm()
            assert _pool_clean(cont), name
            assert cont.stats()["supervisor"]["ready"] is True, name
        finally:
            fm.disarm()
            cont.close()
    (ja, jb), (ta, tb) = got["jax"], got["port"]
    for r in (ja, jb, ta, tb):
        assert r["status"] == "success", (point, r)
    assert ta["token_ids"] == _ids(ja) == unpressured[PROMPT_A], point
    assert tb["token_ids"] == _ids(jb) == unpressured[PROMPT_B], point
