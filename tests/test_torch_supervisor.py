"""PyTorch port vs JAX package: the continuous fleet's crash supervisor,
driven by fault injection (the cases of tests/test_faults.py).

The harness units run against both `faults` modules (the port keeps its
own copy, with its own armed plan). The fleet cases run the same requests
through the JAX ContinuousEngine and the port's on the CPU, with the same
weights (test-llama-tiny, fp32, no EOS, params from the reference's
init_params carried over by models/bridge.py), no prefix cache in either,
each fleet's own `faults` module armed with the same rule: the envelopes'
status and error type, the greedy token ids, the restart / recovered /
poisoned counts and a clean pool must be the JAX fleet's."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog while the band plays on"]
POISON = "POISONPILL do not serve this"
KW = dict(max_tokens=10, greedy=True, chat=False)
# the paged fleet (chunked admission, the main path) and the dense one
# (whole-prefill admission)
FLEETS = {"paged": dict(kv_pool_blocks=24, kv_block_size=8), "dense": {}}
BOTH = pytest.mark.parametrize("fm", [jax_faults, port_faults], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


# -- harness units, for both faults modules --------------------------------------

@BOTH
def test_rule_triggers_nth_every_times(fm):
    r = fm.FaultRule("fetch", "transient", on_call=2, every=3, times=2)
    fired = [r.should_fire("") for _ in range(9)]
    assert fired == [False, True, False, False, True, False, False, False, False]
    assert r.fired == 2


@BOTH
def test_rule_match_restricts_and_counts_matching_calls_only(fm):
    r = fm.FaultRule("prefill", "fatal", match="BAD", every=1, times=0)
    assert not r.should_fire("good prompt")
    assert r.should_fire("a BAD prompt")
    assert not r.should_fire("still good")
    assert r.should_fire("BAD again")


@BOTH
def test_check_is_noop_when_disarmed(fm):
    fm.disarm()
    fm.check("decode_launch", tag="anything")


@BOTH
def test_armed_check_raises_typed_errors(fm):
    fm.arm([fm.FaultRule("fetch", "transient")])
    with pytest.raises(fm.TransientFault, match="RESOURCE_EXHAUSTED"):
        fm.check("fetch")
    fm.arm([fm.FaultRule("fetch", "fatal")])
    with pytest.raises(fm.FatalFault):
        fm.check("fetch")
    fm.check("prefill")


@BOTH
def test_spec_parsing_round_trip(fm):
    plan = fm.arm("decode_launch:transient:on=3,every=2,times=4;"
                  "prefill:fatal:match=XYZ,wedge=0.001")
    assert {(r.point, r.kind) for r in plan.rules} == {
        ("decode_launch", "transient"), ("prefill", "fatal")}
    assert plan.rules[0].on_call == 3 and plan.rules[0].every == 2
    assert plan.rules[1].match == "XYZ" and plan.rules[1].wedge_s == 0.001
    for bad in ("nonsense", "fetch", "fetch:weird", "fetch:fatal:zz=1", ""):
        with pytest.raises(ValueError):
            fm.parse_spec(bad)


@BOTH
def test_arm_from_env(fm):
    assert fm.arm_from_env({}) is None
    plan = fm.arm_from_env({"DLI_FAULTS": "alloc:transient:on=5"})
    assert plan is not None and plan.rules[0].point == "alloc"


@BOTH
def test_seeded_probabilistic_rule_is_deterministic(fm):
    def draws():
        r = fm.FaultRule("fetch", "transient", on_call=1, every=1, times=0, p=0.5, seed=7)
        return [r.should_fire("") for _ in range(32)]

    a, b = draws(), draws()
    assert a == b and any(a) and not all(a)


@BOTH
def test_wedge_sleeps_before_raising(fm):
    fm.arm([fm.FaultRule("fetch", "transient", wedge_s=0.15)])
    t0 = time.time()
    with pytest.raises(fm.TransientFault):
        fm.check("fetch")
    assert time.time() - t0 >= 0.14


def test_the_two_plans_are_separate():
    """Arming one package's plan leaves the other's disarmed."""
    port_faults.arm([port_faults.FaultRule("fetch", "fatal")])
    assert jax_faults.active() is None
    jax_faults.check("fetch")
    with pytest.raises(port_faults.FatalFault):
        port_faults.check("fetch")


# -- the fleets ----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tok = IdTokenizer()
    ecfg = dict(prefill_buckets=(32, 64), prefix_cache_entries=0)
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ecfg), tokenizer=tok, device="cpu")
    return {"jax": (JC, jax_faults, jeng), "port": (TC, port_faults, teng)}


def _cont(mod, eng, fleet="paged", **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("slot_max_seq", 64)
    return mod.ContinuousEngine(eng, **FLEETS[fleet], **kw)


def _ids(r) -> list:
    return [int(t) for t in r["response"].split()]


def _pool_clean(cont) -> bool:
    if not cont.paged:
        return True
    return cont._alloc.outstanding == 0 and \
        cont._alloc.free_blocks == cont._alloc.n_blocks - 1


def _submit_all(cont, prompts, stagger=0.05, **kw):
    out = {}

    def run(p, delay):
        time.sleep(delay)
        out[p] = cont.submit(p, **dict(KW, **kw))

    threads = [threading.Thread(target=run, args=(p, stagger * i))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _each(engines, drill, fleet="paged", **kw):
    """Run drill(cont, faults module) on the JAX fleet, then the port's;
    {"jax": ..., "port": ...} of (its result, stats, pool clean)."""
    got = {}
    for name, (mod, fm, eng) in engines.items():
        cont = _cont(mod, eng, fleet, **kw)
        try:
            res = drill(cont, fm)
            fm.disarm()
            got[name] = (res, cont.stats(), _pool_clean(cont))
        finally:
            fm.disarm()
            cont.close()
    return got


@pytest.fixture(scope="module")
def clean(engines):
    """Each prompt's fault-free greedy ids on the port's paged fleet."""
    mod, _, eng = engines["port"]
    cont = _cont(mod, eng)
    try:
        return {p: cont.submit(p, **KW)["token_ids"] for p in PROMPTS}
    finally:
        cont.close()


@pytest.mark.parametrize("fleet,point", [
    *((f, p) for f in FLEETS for p in ("admission", "prefill", "decode_launch", "fetch")),
    ("paged", "alloc")])
@pytest.mark.parametrize("kind", ["transient", "fatal"])
def test_one_shot_fault_recovers_as_in_jax(engines, clean, fleet, point, kind):
    """One injected crash at each host-loop point: one restart, the request
    salvaged as a continuation prefill, the JAX fleet's ids (the fault-free
    ones), and the fleet serves the next request."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule(point, kind, on_call=1)])
        r = cont.submit(PROMPTS[0], **KW)
        fm.disarm()
        r2 = cont.submit(PROMPTS[1], **KW)
        return r, r2, cont.restarts_total

    got = _each(engines, drill, fleet)
    (jr, jr2, jn), jst, jclean = got["jax"]
    (tr, tr2, tn), tst, tclean = got["port"]
    assert tr["status"] == jr["status"] == "success", (tr, jr)
    assert tr["token_ids"] == _ids(jr) == clean[PROMPTS[0]]
    assert tr.get("recovered") == jr.get("recovered")
    assert tn == jn == 1
    assert tr2["token_ids"] == _ids(jr2) == clean[PROMPTS[1]]
    assert tst["supervisor"]["ready"] and jst["supervisor"]["ready"]
    assert tst["supervisor"]["restarts"] == jst["supervisor"]["restarts"] == 1
    assert tclean and jclean


def test_mid_decode_crash_recovers_fleet_as_in_jax(engines, clean):
    """A fetch fault with several requests in flight: each is salvaged and
    re-admitted serially, with the JAX fleet's ids; one restart each."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("fetch", "transient", on_call=3)])
        return _submit_all(cont, PROMPTS), cont.restarts_total

    got = _each(engines, drill)
    (jout, jn), jst, _ = got["jax"]
    (tout, tn), tst, tclean = got["port"]
    for p in PROMPTS:
        assert tout[p]["token_ids"] == _ids(jout[p]) == clean[p], p
    assert tn == jn == 1
    assert tst["supervisor"]["recovered"] >= 1 and jst["supervisor"]["recovered"] >= 1
    assert any(tout[p].get("recovered") for p in PROMPTS)
    assert tst["occupied"] == 0 and tclean


def test_repeated_transient_faults_within_budget_as_in_jax(engines, clean):
    """Two crashes separated by a healthy fetch: the consecutive window
    resets, and the default budget absorbs both in both fleets."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("decode_launch", "transient", on_call=2),
                fm.FaultRule("fetch", "transient", on_call=2)])
        return cont.submit(PROMPTS[2], **KW), cont.restarts_total

    got = _each(engines, drill)
    (jr, jn), _, _ = got["jax"]
    (tr, tn), _, tclean = got["port"]
    assert tr["token_ids"] == _ids(jr) == clean[PROMPTS[2]]
    assert tn == jn == 2 and tclean


def test_restart_metrics_exposed_as_in_jax(engines):
    """The supervisor's families under the JAX names, on /metrics."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("fetch", "transient", on_call=1)])
        r = cont.submit(PROMPTS[1], max_tokens=6, greedy=True, chat=False)
        m = cont.engine.metrics
        return (r["status"],
                m.get("dli_scheduler_restarts_total").labels(engine="continuous").value,
                m.get("dli_requests_recovered_total").labels(engine="continuous").value,
                m.render())

    got = _each(engines, drill)
    for name in ("jax", "port"):
        status, restarts, recovered, render = got[name][0]
        assert status == "success" and restarts >= 1 and recovered >= 1, name
        for fam in ("dli_scheduler_restarts_total", "dli_poison_requests_total",
                    "dli_drain_duration_seconds", "dli_preempted_resume_seconds",
                    "dli_requests_recovered_total"):
            assert fam in render, (name, fam)


def test_poison_quarantined_within_strikes_as_in_jax(engines, clean):
    """A request that crashes every admission is failed ALONE ("poison")
    within poison_strikes restarts; its fleet-mate completes with the JAX
    fleet's ids, and the fleet keeps serving."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("prefill", "fatal", match="POISONPILL", every=1, times=0)])
        out = {}

        def bg(name, prompt):
            out[name] = cont.submit(prompt, **KW)

        t1 = threading.Thread(target=bg, args=("good", PROMPTS[2]))
        t1.start()
        time.sleep(0.05)
        t2 = threading.Thread(target=bg, args=("bad", POISON))
        t2.start()
        t1.join(timeout=300)
        t2.join(timeout=300)
        fm.disarm()
        after = cont.submit("hello", max_tokens=5, greedy=True, chat=False)
        return out, after, cont.poisoned_total, cont.restarts_total

    got = _each(engines, drill, poison_strikes=2)
    (jout, jafter, jp, jn), jst, _ = got["jax"]
    (tout, tafter, tp, tn), tst, tclean = got["port"]
    for out in (jout, tout):
        assert out["bad"]["status"] == "failed"
        assert out["bad"]["error_type"] == "poison", out["bad"]
        assert out["good"]["status"] == "success", out["good"]
    assert tout["good"]["token_ids"] == _ids(jout["good"]) == clean[PROMPTS[2]]
    assert tp == jp == 1
    assert tn <= 2 and jn <= 2
    assert tafter["token_ids"] == _ids(jafter)
    assert tst["supervisor"]["ready"] and jst["supervisor"]["ready"] and tclean


def test_budget_exhaustion_fails_fleet_cleanly_as_in_jax(engines):
    """A crash on every launch: after restart_budget restarts both fleets
    are dead, the waiter gets `unavailable`, readiness is false, every
    block is back, and a later submission fails fast."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("decode_launch", "fatal", every=1, times=0)])
        r = cont.submit("doomed", max_tokens=6, greedy=True, chat=False)
        fm.disarm()
        r2 = cont.submit("after death", max_tokens=3, chat=False)
        return r, r2, cont.restarts_total, cont.ready

    got = _each(engines, drill, restart_budget=2, poison_strikes=99)
    for name in ("jax", "port"):
        (r, r2, n, ready), st, clean_pool = got[name]
        assert r["status"] == "failed" and r["error_type"] == "unavailable", (name, r)
        assert st["supervisor"]["dead"] is True and ready is False, name
        assert n == 2, name
        assert r2["status"] == "failed", name
        assert clean_pool, name


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_pool_zero_leak_after_fatal_loop_death_as_in_jax(engines, fleet):
    """No restart budget: the loop-death path releases every block."""
    def drill(cont, fm):
        fm.arm([fm.FaultRule("decode_launch", "fatal")])
        return cont.submit("leak check", max_tokens=8, greedy=True, chat=False)

    got = _each(engines, drill, fleet, restart_budget=0)
    for name in ("jax", "port"):
        r, _, clean_pool = got[name]
        assert r["error_type"] == "unavailable", (name, r)
        assert clean_pool, name


def test_paged_recovery_pool_clean_and_alloc_fault_as_in_jax(engines, clean):
    """A mid-decode crash and a crash at the block grant: the JAX fleet's
    ids, one restart each, the books back to zero outstanding blocks."""
    def drill(cont, fm):
        out = []
        for point, on_call, prompt in (("fetch", 2, PROMPTS[0]), ("alloc", 1, PROMPTS[1])):
            fm.arm([fm.FaultRule(point, "transient", on_call=on_call)])
            out.append(cont.submit(prompt, **KW))
            fm.disarm()
        return out, cont.restarts_total

    got = _each(engines, drill)
    (jout, jn), _, _ = got["jax"]
    (tout, tn), _, tclean = got["port"]
    for j, t, p in zip(jout, tout, PROMPTS):
        assert t["token_ids"] == _ids(j) == clean[p]
    assert tn == jn == 2 and tclean


def test_restart_keeps_the_static_buffers(engines):
    """The port's rebuild resets the fleet in place: the pool, slot state,
    block table and mixed-launch inputs keep their storage across a restart
    (the CUDA graphs captured over them stay valid), and the state comes
    back idle."""
    mod, fm, eng = engines["port"]
    cont = _cont(mod, eng)
    try:
        def ptrs():
            bufs = [cont.cache["k"], cont.cache["v"], cont._table_dev,
                    *cont.state, *cont.sparams, *cont._mixed_in[:6]]
            return [t.data_ptr() for t in bufs]

        before = ptrs()
        fm.arm([fm.FaultRule("fetch", "transient", on_call=2)])
        r = cont.submit(PROMPTS[0], **KW)
        fm.disarm()
        assert r["status"] == "success" and cont.restarts_total == 1
        assert ptrs() == before
        assert not bool(cont.state.active.any())
    finally:
        cont.close()
