"""PyTorch port vs JAX package: the fleet's tracing substrate.

The port's utils/tracing.py (`sample_decision`, the traceparent context),
serving/trace_store.py (`TraceStore`, `assemble_tree`, `span_tree_total`,
`to_chrome_trace`) and utils/metrics.py's histogram exemplars against the
JAX package's, on the same scripted inputs. Both stores run one script on
one fake clock; span ids are random in each, so the JAX spans' ids are
mapped onto the port's (by record order) before the outputs are compared.
Then the continuous fleet's launch attribution on the CPU: at
trace_sample_rate 0 it is never entered, and at rate 1 a wave makes no
more packed fetches than at rate 0 (attribution adds no fetch or sync).
"""

import itertools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import distributed_llm_inference_tpu.serving.trace_store as JTS  # noqa: E402
import distributed_llm_inference_tpu.utils.tracing as JT  # noqa: E402
import distributed_llm_inference_tpu_torch.serving.trace_store as PTS  # noqa: E402
import distributed_llm_inference_tpu_torch.utils.tracing as PT  # noqa: E402
from distributed_llm_inference_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.metrics import MetricsRegistry  # noqa: E402

SEED = 21
# trace and root span ids, shared by both packages' scripts
IDS = np.random.default_rng(SEED).integers(0, 16, size=(16, 48))
TRACE_IDS = ["".join("0123456789abcdef"[d] for d in row[:32]) for row in IDS]
ROOT_SPANS = ["".join("0123456789abcdef"[d] for d in row[32:]) for row in IDS]


# -- sampling and the traceparent context --------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.01, 0.5, 1.0])
def test_sample_decision_equals_jax(rate):
    rng = np.random.default_rng(SEED)
    ids = ["".join(f"{b:02x}" for b in rng.integers(0, 256, 16)) for _ in range(10000)]
    ids += [PT.new_trace_id() for _ in range(100)]
    want = [JT.sample_decision(t, rate) for t in ids]
    got = [PT.sample_decision(t, rate) for t in ids]
    assert got == want
    if 0.0 < rate < 1.0:
        assert 0.5 * rate < sum(got) / len(got) < 1.5 * rate


def test_traceparent_context_equals_jax():
    for tid, sid in zip(TRACE_IDS, ROOT_SPANS):
        for flags in ("01", "00"):
            raw = f"00-{tid}-{sid}-{flags}"
            j, p = JT.parse_traceparent(raw), PT.parse_traceparent(raw)
            assert (p.trace_id, p.span_id, p.sampled) == (j.trace_id, j.span_id, j.sampled)
            assert p.header() == j.header() == raw
            jc, pc = j.child("e" * 16), p.child("e" * 16)
            assert pc.header() == jc.header()
    for bad in (None, "", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "00-xyz-01"):
        assert PT.parse_traceparent(bad) is None and JT.parse_traceparent(bad) is None
    assert len(PT.new_trace_id()) == 32 and len(PT.new_span_id()) == 16
    root = PT.SpanContext.new_root()
    assert len(root.trace_id) == 32 and len(root.child().span_id) == 16


# -- the span store, scripted ----------------------------------------------------

class _Clock:
    """A deterministic wall clock: each read advances 0.25 s."""

    def __init__(self):
        self._t = itertools.count()

    def time(self):
        return 1.0e9 + 0.25 * next(self._t)


def _pairing(S, T):
    store = S.TraceStore(service="unit")
    root = T.SpanContext(TRACE_IDS[0], ROOT_SPANS[0])
    with store.span("parent", root) as sp:
        sub = root.child(sp["span_id"])
        with store.span("child", sub, attrs={"k": 1}):
            pass
        store.add_span(root.trace_id, "measured", 5.0, 6.0, parent_id=sp["span_id"],
                       attrs={"rows": 3}, service="elsewhere")
    return store, [TRACE_IDS[0]]


def _commit_once(S, T):
    store = S.TraceStore(service="unit")
    ctx = T.SpanContext(TRACE_IDS[1], ROOT_SPANS[1])
    sp = store.start_span("once", ctx, attrs={"z": 0})
    store.end_span(sp, attrs={"a": 1})
    store.end_span(sp, attrs={"b": 2})  # a defensive second end: attrs only
    return store, [TRACE_IDS[1]]


def _error_path(S, T):
    store = S.TraceStore(service="unit")
    ctx = T.SpanContext(TRACE_IDS[2], ROOT_SPANS[2])
    with pytest.raises(RuntimeError):
        with store.span("boom", ctx):
            raise RuntimeError("x")
    return store, [TRACE_IDS[2]]


def _lru_and_bounds(S, T):
    store = S.TraceStore(service="unit", max_traces=4, max_spans_per_trace=8)
    for tid in TRACE_IDS[:6]:
        store.add_span(tid, "s", 0.0, 1.0)
    busy = TRACE_IDS[5]
    for i in range(20):
        store.add_span(busy, f"s{i}", float(i), float(i) + 0.5)
    store.get(TRACE_IDS[2])  # a read refreshes recency
    store.add_span(TRACE_IDS[6], "s", 0.0, 1.0)
    return store, TRACE_IDS[:7]


def _orphans(S, T):
    store = S.TraceStore(service="s1")
    ctx = T.SpanContext(TRACE_IDS[3], ROOT_SPANS[3])
    with store.span("a", ctx) as sp:
        store.add_span(ctx.trace_id, "kid", 2.0, 3.0, parent_id=sp["span_id"])
    # its parent lives in a process that was never queried
    store.add_span(ctx.trace_id, "orphan", 1.5, 2.0, parent_id="f" * 16, service="s2")
    store.add_span(ctx.trace_id, "open-ended", 1.0, 1.0)
    return store, [TRACE_IDS[3]]


SCRIPTS = {"pairing": _pairing, "commit_once": _commit_once, "error_path": _error_path,
           "lru_and_bounds": _lru_and_bounds, "orphan_forest": _orphans}


def _run(script, S, T, monkeypatch):
    monkeypatch.setattr(S, "time", _Clock())
    store, tids = script(S, T)
    return store, {tid: store.get(tid) for tid in tids}


def _id_map(jax_spans: dict, port_spans: dict) -> dict:
    """JAX span id -> port span id, pairing spans by trace and record order."""
    mapping = {}
    for tid, js in jax_spans.items():
        ps = port_spans[tid]
        assert [s["name"] for s in ps] == [s["name"] for s in js], tid
        for j, p in zip(js, ps):
            mapping[j["span_id"]] = p["span_id"]
    return mapping


def _mapped(obj, mapping):
    """`obj` with every span id (as a dict value) replaced through mapping."""
    if isinstance(obj, dict):
        return {k: (mapping.get(v, v) if k in ("span_id", "parent_id") else _mapped(v, mapping))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mapped(v, mapping) for v in obj]
    return obj


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_trace_store_equals_jax(name, monkeypatch):
    jstore, jspans = _run(SCRIPTS[name], JTS, JT, monkeypatch)
    pstore, pspans = _run(SCRIPTS[name], PTS, PT, monkeypatch)
    mapping = _id_map(jspans, pspans)
    assert _mapped(jspans, mapping) == pspans
    assert pstore.trace_ids() == jstore.trace_ids()
    assert pstore.stats() == jstore.stats()
    for tid in jspans:
        jtree = JTS.assemble_tree(jspans[tid])
        ptree = PTS.assemble_tree(pspans[tid])
        assert _mapped(jtree, mapping) == ptree
        assert PTS.span_tree_total(ptree) == JTS.span_tree_total(jtree)
        jdoc = JTS.to_chrome_trace(jspans[tid])
        pdoc = PTS.to_chrome_trace(pspans[tid])
        for ev in jdoc["traceEvents"]:  # span ids ride the events' args
            if "args" in ev:
                ev["args"] = _mapped(ev["args"], mapping)
        assert pdoc == jdoc


def test_chrome_trace_of_two_services_and_an_unfinished_span():
    spans = [
        {"name": "a", "trace_id": TRACE_IDS[4], "span_id": "a" * 16, "parent_id": None,
         "t0": 1.0, "t1": 3.0, "attrs": {"x": 1}, "service": "router"},
        {"name": "b", "trace_id": TRACE_IDS[4], "span_id": "b" * 16,
         "parent_id": "a" * 16, "t0": 2.0, "t1": None, "attrs": {},
         "service": "replica-decode"},
    ]
    assert PTS.to_chrome_trace(spans) == JTS.to_chrome_trace(spans)
    roots = PTS.assemble_tree(spans)
    assert roots == JTS.assemble_tree(spans)
    assert PTS.span_tree_total(roots) == JTS.span_tree_total(roots) == 2.0


# -- histogram exemplars ---------------------------------------------------------

def _observe(reg):
    h = reg.histogram("dli_ttft_seconds", "t", ("engine",), buckets=(0.1, 1.0))
    c = h.labels(engine="continuous")
    c.observe(0.05)  # untraced: no exemplar
    c.observe(0.06, trace_id=TRACE_IDS[0])
    c.observe(0.07, trace_id=TRACE_IDS[1])  # the same bucket: the latest wins
    c.observe(0.5, trace_id=TRACE_IDS[2])
    c.observe(5.0, trace_id=TRACE_IDS[3])  # the +Inf bucket
    h.labels(engine="solo").observe(0.2)
    reg.counter("dli_requests_total", "r", ("engine",)).labels(engine="solo").inc(2)
    reg.gauge("dli_slots_occupied", "o").labels().set(3)
    return reg


def _no_ts(snap):
    for fam in snap.values():
        for series in fam["series"]:
            for ex in series.get("exemplars", {}).values():
                ex.pop("ts")
    return snap


def test_exemplars_and_metrics_lines_equal_jax():
    j, p = _observe(JaxRegistry()), _observe(MetricsRegistry())
    assert p.render() == j.render()
    psnap = _no_ts(p.snapshot())
    assert psnap == _no_ts(j.snapshot())
    ex = psnap["dli_ttft_seconds"]["series"][0]["exemplars"]
    assert [e["trace_id"] for e in ex.values()] == TRACE_IDS[1:4]


# -- launch attribution on the port's fleet (CPU) --------------------------------

PROMPTS = ["the quick brown fox jumps over the lazy dog",
           " ".join(f"w{i}" for i in range(12)), "short one", "a b c d e f g"]


def _fleet(rate):
    eng = create_engine("test-llama-tiny", device="cpu", seed=0,
                        engine_cfg=EngineConfig(trace_sample_rate=rate))
    return eng, ContinuousEngine(eng, n_slots=2, chunk_steps=4, kv_pool_blocks=64,
                                 kv_block_size=16, restart_backoff_s=0.01)


def _count_fetches(cont):
    box = [0]
    inner = cont._fetch

    def fetch(handle):
        box[0] += 1
        return inner(handle)

    cont._fetch = fetch
    return box


def _settle(cont, fetches, timeout_s=10.0) -> bool:
    """Whether, once the fleet's last launches in flight are fetched, it
    made exactly one packed fetch per launch."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        st = cont.stats()["launches"]
        if fetches[0] == st["mixed"] + st["decode_chunks"]:
            return True
        time.sleep(0.02)
    return False


def _wave(cont, ctxs):
    out = [None] * len(PROMPTS)

    def run(i):
        out[i] = cont.submit(PROMPTS[i], max_tokens=8, greedy=True, chat=False,
                             trace_ctx=ctxs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_rate_zero_never_enters_launch_attribution(monkeypatch):
    def bomb(*a, **k):
        raise AssertionError("launch attribution entered at trace_sample_rate 0")

    monkeypatch.setattr(ContinuousEngine, "_prof_note_launch", bomb)
    monkeypatch.setattr(ContinuousEngine, "_prof_close_launch", bomb)
    monkeypatch.setattr(PTS.TraceStore, "add_span", bomb)
    eng, cont = _fleet(0.0)
    try:
        assert cont._trace_rate == 0.0
        ctxs = [PT.SpanContext(t, s) for t, s in zip(TRACE_IDS[:4], ROOT_SPANS)]
        out = _wave(cont, ctxs)
        assert all(r["status"] == "success" for r in out), out
        assert not cont._launch_log
        assert all(eng.trace_store.get(c.trace_id) == [] for c in ctxs)
    finally:
        cont.close()


def test_rate_one_spans_add_no_fetch():
    runs = {}
    for rate in (0.0, 1.0):
        eng, cont = _fleet(rate)
        fetches = _count_fetches(cont)
        try:
            ctxs = [PT.SpanContext(t, s) for t, s in zip(TRACE_IDS[:4], ROOT_SPANS)]
            out = _wave(cont, ctxs)
            settled = _settle(cont, fetches)
        finally:
            cont.close()
        assert all(r["status"] == "success" for r in out), out
        runs[rate] = (out, settled, eng, ctxs)
    out0, settled0, _, _ = runs[0.0]
    out1, settled1, eng, ctxs = runs[1.0]
    assert [r["token_ids"] for r in out1] == [r["token_ids"] for r in out0]
    # one packed fetch per launch at either rate: attribution adds none
    assert settled0 and settled1
    for ctx in ctxs:
        spans = eng.trace_store.get(ctx.trace_id)
        launches = [s for s in spans if s["name"] in ("launch.mixed", "launch.chunk")]
        assert launches, [s["name"] for s in spans]
        for sp in launches:
            assert sp["parent_id"] == ctx.span_id
            assert sp["t1"] >= sp["t0"] and sp["attrs"]["launch_to_fetch_s"] >= 0
    # the exemplars name these traces
    ex = eng.stats()["exemplars"]["dli_request_duration_seconds"]
    assert {e["trace_id"] for e in ex.values()} <= {c.trace_id for c in ctxs}
