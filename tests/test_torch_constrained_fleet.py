"""PyTorch port vs JAX package: grammar constraints in the continuous
fleet (the continuous half of tests/test_constrained_pp.py, :108-245, and
more), on test-llama-tiny in fp32 with the same weights in both packages.
Each package's engine decodes through a byte tokenizer whose decode
spells every id, so a response pins the exact token ids; the constraint
vocabulary is the byte tokenizer's in both (TokenVocab reads the class).

  * the dense fleet serves constrained tenants beside an unconstrained one:
    greedy ids equal the JAX fleet's, the unconstrained one equals its
    solo run, a sampled one satisfies its constraint;
  * a constraint admitted twice reuses its resident rows, release frees
    them: stats()["constraints"] and the three gauges equal the JAX
    fleet's, and the next unconstrained chunk is the plain one again, with
    every FSM row back at 0 in the same storage;
  * the paged fleet sends constrained requests solo (the solo envelope);
  * a constrained stream's deltas join to its response;
  * a DFA that never fits the fleet table goes solo; two constraints that
    cannot co-reside backpressure (dli_constraint_backpressure_total);
  * a supervisor restart mid-constraint (utils/faults.py) re-admits the
    request with its DFA re-walked over the salvaged tokens: its ids equal
    the uninterrupted run's and the JAX fleet's.
"""

import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JCont  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TCont  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32")
ECFG = dict(prefill_buckets=(32, 64))
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
          "required": ["name", "age"]}
GREEDY = dict(greedy=True, chat=False)
BYTES = ByteTokenizer()


class PortIds(ByteTokenizer):
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


class JaxIds(JaxByteTokenizer):
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _ids(r) -> list:
    return [int(t) for t in r["response"].split()]


def _text(r) -> str:
    return BYTES.decode(_ids(r))


@pytest.fixture(scope="module")
def engines():
    """{"jax": (continuous module, faults module, engine), "port": ...}."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(4))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ECFG), tokenizer=JaxIds())
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ECFG), tokenizer=PortIds(), device="cpu")
    return {"jax": (JCont, jax_faults, jeng), "port": (TCont, port_faults, teng)}


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


def _fleet(mod, eng, paged=False, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("max_queue", 16)
    kw.setdefault("restart_backoff_s", 0.01)
    if paged:
        kw.update(kv_pool_blocks=40, kv_block_size=16)
    return mod.ContinuousEngine(eng, **kw)


def _each(engines, drill, **kw):
    """drill(fleet, engine, faults module) on the JAX fleet, then the port's."""
    out = {}
    for name, (mod, fm, eng) in engines.items():
        cont = _fleet(mod, eng, **kw)
        try:
            out[name] = drill(cont, eng, fm)
        finally:
            fm.disarm()
            cont.close()
    return out


def _concurrent(cont, jobs, stagger=0.0):
    out = {}

    def run(name, prompt, kw):
        out[name] = cont.submit(prompt, **kw)

    threads = []
    for i, (name, prompt, kw) in enumerate(jobs):
        t = threading.Thread(target=run, args=(name, prompt, kw))
        threads.append(t)
        t.start()
        if stagger:
            time.sleep(stagger)
    for t in threads:
        t.join(timeout=300)
    assert set(out) == {n for n, _, _ in jobs}
    return out


MIXED = [
    ("color", "pick a color:", dict(max_tokens=20, constraint={"regex": "(red|green|blue)"},
                                    **GREEDY)),
    ("free", "tell me something", dict(max_tokens=10, **GREEDY)),
    ("digits", "digits:", dict(max_tokens=20, constraint={"regex": "[0-9]{2,3}x"}, **GREEDY)),
    ("json", "emit:", dict(max_tokens=140, constraint={"json_schema": SCHEMA}, **GREEDY)),
    ("choice", "pick:", dict(max_tokens=20, temperature=1.5, top_k=0, top_p=1.0, chat=False,
                             constraint={"choices": ["on", "off"]})),
]
CHECKS = {
    "color": lambda t: re.fullmatch("red|green|blue", t),
    "digits": lambda t: re.fullmatch("[0-9]{2,3}x", t),
    "json": lambda t: isinstance(__import__("json").loads(t)["age"], int),
    "choice": lambda t: t in ("on", "off"),
}


def test_dense_mixed_slots_equal_jax(engines):
    """Constrained and unconstrained tenants share the dense fleet: every
    greedy tenant's ids equal the JAX fleet's, each constrained answer
    satisfies its OWN constraint, and the unconstrained one decodes exactly
    its solo stream."""
    def drill(cont, eng, fm):
        solo = eng.generate("tell me something", max_tokens=10, **GREEDY)
        return _concurrent(cont, MIXED, stagger=0.02), solo, cont.stats()

    got = _each(engines, drill)
    (jres, jsolo, jst), (tres, tsolo, tst) = got["jax"], got["port"]
    for name, _, kw in MIXED:
        j, t = jres[name], tres[name]
        assert t["status"] == j["status"] == "success", (name, t, j)
        assert t.get("constrained") == j.get("constrained") == (
            True if "constraint" in kw else None)
        assert t["backend"] == j["backend"] == "continuous"
        if kw.get("greedy"):
            assert _ids(t) == _ids(j), name
            assert t["finish_reason"] == j["finish_reason"], name
        if name in CHECKS:
            assert CHECKS[name](_text(t)), (name, _text(t))
    assert _ids(tres["free"]) == _ids(tsolo) == _ids(jsolo)
    for st in (jst, tst):
        assert st["constraints"]["active"] == 0
    assert tst["launches"]["constrained_chunks"] > 0
    assert "decode_chunk_constrained" in tst["graphs"]


def _gauges(eng):
    return tuple(eng.metrics.get(n).labels().value for n in (
        "dli_constraint_entries_resident", "dli_constraint_states_resident",
        "dli_constraint_backpressure_total"))


def test_reuse_release_stats_gauges_and_back_to_plain(engines):
    """One constraint twice, then another: resident rows reused, released,
    compacted — stats()["constraints"] and the gauges equal the JAX
    fleet's at each step. Mid-request the stats show the entry active.
    Afterwards an unconstrained request runs the PLAIN chunk (the
    constrained count stops), every FSM row is 0, in the same storage."""
    specs = [{"choices": ["yes", "no"]}, {"choices": ["yes", "no"]},
             {"regex": "[0-9]{3}-[0-9]{4}"}]

    def drill(cont, eng, fm):
        steps = []
        for spec in specs:
            r = cont.submit("q:", max_tokens=15, constraint=spec, **GREEDY)
            steps.append((_ids(r), r.get("constrained"), cont.stats()["constraints"],
                          _gauges(eng)))
        seen = []

        def watch():
            while not done.is_set():
                c = cont.stats().get("constraints")
                if c:
                    seen.append(c)
                time.sleep(0.001)

        done = threading.Event()
        w = threading.Thread(target=watch)
        w.start()
        r = cont.submit("emit:", max_tokens=100, constraint={"json_schema": SCHEMA},
                        **GREEDY)
        done.set()
        w.join()
        extra = {}
        if hasattr(cont, "_fsm") and isinstance(cont._fsm, torch.Tensor):
            ptr = cont._fsm.data_ptr()
            before = cont.stats()["launches"]
            plain_calls = cont._chunk_graph.calls
            free = cont.submit("tell me something", max_tokens=10, **GREEDY)
            after = cont.stats()["launches"]
            extra = dict(
                fsm_zero=bool((cont._fsm == 0).all()), same=cont._fsm.data_ptr() == ptr,
                constrained_delta=after["constrained_chunks"] - before["constrained_chunks"],
                plain_delta=cont._chunk_graph.calls - plain_calls,
                free=free["status"])
        return steps, _ids(r), seen, extra

    got = _each(engines, drill)
    (jsteps, jids, _, _), (tsteps, tids, tseen, extra) = got["jax"], got["port"]
    assert tsteps == jsteps
    assert tsteps[1][2]["resident"] == 1 and tsteps[1][2]["active"] == 0
    assert tsteps[2][3][0] == 1  # compacted to the one new entry
    assert tids == jids
    assert any(c["active"] == 1 and c["bucket"] >= c["states"] for c in tseen)
    assert extra == dict(fsm_zero=True, same=True, constrained_delta=0,
                         plain_delta=extra["plain_delta"], free="success")
    assert extra["plain_delta"] > 0


def test_paged_fleet_sends_constraints_solo(engines):
    """A constrained request on the paged fleet is served by the solo
    engine (the solo envelope, no "continuous"), with the JAX fleet's ids."""
    def drill(cont, eng, fm):
        return cont.submit("pick:", max_tokens=20, constraint={"regex": "(red|green|blue)"},
                           **GREEDY)

    got = _each(engines, drill, paged=True)
    j, t = got["jax"], got["port"]
    assert t["status"] == j["status"] == "success"
    assert t.get("continuous") is j.get("continuous") is None
    assert t["backend"] == j["backend"] == "single-device"
    assert t["constrained"] is True and _ids(t) == _ids(j)
    assert re.fullmatch("red|green|blue", _text(t))


def test_constrained_stream(engines):
    """A constrained stream on the dense fleet: its deltas join to the
    final response, which equals the JAX fleet's stream."""
    def drill(cont, eng, fm):
        deltas, final = [], None
        for ev in cont.stream("pick a color:", max_tokens=20,
                              constraint={"regex": "(red|green|blue)"}, **GREEDY):
            if ev.get("done"):
                final = ev
                break
            deltas.append(ev.get("delta", ""))
        return deltas, final

    got = _each(engines, drill)
    (jd, jf), (td, tf) = got["jax"], got["port"]
    assert tf["status"] == jf["status"] == "success"
    assert "".join(td) == tf["response"] and len(td) >= 1
    assert tf["response"] == jf["response"]
    assert tf["constrained"] is True and tf["backend"] == "continuous"
    assert re.fullmatch("red|green|blue", _text(tf))


def test_table_overflow_goes_solo(engines):
    """A DFA that can never fit the fleet table is served solo."""
    def drill(cont, eng, fm):
        cont._ctable.max_states = 8
        return cont.submit("emit:", max_tokens=140, constraint={"json_schema": SCHEMA},
                           **GREEDY)

    got = _each(engines, drill)
    j, t = got["jax"], got["port"]
    assert t.get("continuous") is j.get("continuous") is None
    assert _ids(t) == _ids(j)
    assert isinstance(__import__("json").loads(_text(t))["age"], int)


def test_backpressure_counts_and_serves(engines):
    """Two constraints that cannot be resident together: the second
    admission is refused (counted), waits for the first's release, and
    both answer with the JAX fleet's ids."""
    jobs = [("a", "phone:", dict(max_tokens=20, constraint={"regex": "[0-9]{3}-[0-9]{4}"},
                                 **GREEDY)),
            ("b", "word:", dict(max_tokens=20, constraint={"choices": ["alpha", "beta"]},
                                **GREEDY))]

    def drill(cont, eng, fm):
        cont._ctable.max_states = 12
        before = _gauges(eng)[2]
        out = _concurrent(cont, jobs)
        return out, _gauges(eng)[2] - before

    got = _each(engines, drill)
    (jout, jbp), (tout, tbp) = got["jax"], got["port"]
    for name in ("a", "b"):
        assert tout[name]["status"] == "success" and tout[name]["constrained"] is True
        assert _ids(tout[name]) == _ids(jout[name])
    assert re.fullmatch("[0-9]{3}-[0-9]{4}", _text(tout["a"]))
    assert _text(tout["b"]) in ("alpha", "beta")
    assert tbp >= 1 and jbp >= 1


@pytest.mark.parametrize("point,call", [("decode_launch", 3), ("fetch", 2),
                                        ("prefill", 1)])
def test_recovery_mid_constraint_equals_uninterrupted(engines, point, call):
    """A one-shot crash while a constrained request decodes: the
    supervisor re-admits it as a continuation prefill whose first-token
    mask and FSM row come from the DFA re-walked over the salvaged tokens;
    its ids equal the uninterrupted run's and the JAX fleet's."""
    kw = dict(max_tokens=60, constraint={"json_schema": SCHEMA}, **GREEDY)

    def drill(cont, eng, fm):
        clean = cont.submit("emit:", **kw)
        fm.arm([fm.FaultRule(point, "transient", on_call=call)])
        r = cont.submit("emit:", **kw)
        fm.disarm()
        return clean, r, cont.restarts_total, cont.stats()

    got = _each(engines, drill)
    (jclean, jr, jn, jst), (tclean, tr, tn, tst) = got["jax"], got["port"]
    assert tn == jn == 1
    assert tr["status"] == jr["status"] == "success"
    assert _ids(tr) == _ids(tclean) == _ids(jr) == _ids(jclean)
    assert tr.get("recovered") == jr.get("recovered")
    assert tr["constrained"] is True
    assert tst["constraints"]["active"] == 0
