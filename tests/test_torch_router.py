"""PyTorch port vs JAX package: the replica router's decisions, with no
subprocess.

The JAX router suite's scripted stub replicas (tests/test_router.py:
in-process fake engine servers that answer ok, draining, overloaded,
500 or die mid-stream) stand in front of the JAX package's `Router` and
the port's `Router` in turn, and each scenario drives both through the
same sequence: requests through the HTTP surface, picks, probe sweeps by
hand. Each side writes an observation log (status codes, envelopes with
their timings' values dropped, picks, replica states, cool-downs,
Retry-After, residency entries and every `dli_router_*` counter and
gauge), and the logs must be equal. `_affinity_key` is compared on
generate, completions, chat and adapter bodies. Last, importing the
port's router in a fresh interpreter must leave torch out of
sys.modules: the router touches no device.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import distributed_llm_inference_tpu.client as JC  # noqa: E402
import distributed_llm_inference_tpu.serving.router as JR  # noqa: E402
import distributed_llm_inference_tpu_torch.client as PC  # noqa: E402
import distributed_llm_inference_tpu_torch.serving.router as PR  # noqa: E402
from distributed_llm_inference_tpu.engine.block_prefix import (  # noqa: E402
    chunk_digests as jax_chunk_digests,
)
from distributed_llm_inference_tpu_torch.engine.block_prefix import chunk_digests  # noqa: E402
from test_router import LONG_PREFIX, _get, _post, _Stub  # noqa: E402

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"jax": (JR, JC), "port": (PR, PC)}


class Side:
    """One package's router over fresh stubs, and its observation log."""

    def __init__(self, R, C, modes, classes=None, **kw):
        self.R, self.C = R, C
        self.stubs = [_Stub(name, mode=mode) for name, mode in modes]
        kw.setdefault("probe_interval_s", 3600.0)  # probes driven by hand
        kw.setdefault("probe_timeout_s", 2.0)
        kw.setdefault("eject_threshold", 3)
        kw.setdefault("request_timeout_s", 30.0)
        reps = [R.Replica(s.name, s.url, replica_class=(classes or {}).get(s.name, "mixed"))
                for s in self.stubs]
        self.router = R.Router(reps, **kw)
        self.server = R.RouterServer(self.router, host="127.0.0.1", port=0)
        self.server.start()
        self.base = f"http://127.0.0.1:{self.server.port}"
        self.log = []
        self._n = 0

    def close(self):
        self.server.shutdown()
        for s in self.stubs:
            s.stop()

    def stub(self, name):
        return next(s for s in self.stubs if s.name == name)

    def rep(self, rid):
        return next(r for r in self.router.replicas if r.rid == rid)

    def note(self, *what):
        self.log.append(what)

    def post(self, payload, path="/generate", headers=None):
        """POST through the router with a fixed X-Request-Id; log the
        code, the envelope (timings' values dropped), Retry-After and the
        echoed request id."""
        self._n += 1
        rid = f"rid-{self._n}"
        code, body, hdrs = _post(self.base, payload, path=path,
                                 headers={"X-Request-Id": rid, **(headers or {})})
        self.note("post", path, code, _envelope(body), hdrs.get("Retry-After"),
                  hdrs.get("X-Request-Id"))
        return code, body

    def get(self, path):
        code, body, hdrs = _get(self.base, path)
        self.note("get", path, code, body, hdrs.get("Retry-After") is not None)
        return code, body

    def states(self):
        self.note("states", [(r.rid, r.state, r.consecutive_failures, r.outstanding,
                              r.cooldown_until > time.monotonic())
                             for r in self.router.replicas])

    def served(self):
        self.note("served", {s.name: s.served() for s in self.stubs})

    def metrics(self):
        """Every dli_router_* counter and gauge, by labels."""
        snap = self.router.metrics.snapshot()
        out = {}
        for name, fam in sorted(snap.items()):
            if name.startswith("dli_router_") and fam["type"] in ("counter", "gauge"):
                out[name] = sorted((tuple(sorted(s["labels"].items())), s["value"])
                                   for s in fam["series"])
        self.note("metrics", out)

    def pin(self, prompt, rid):
        self.router.record_residency(
            self.R.chunk_digests(prompt, self.router.affinity_chunk, 32), rid)


def _envelope(body):
    if not isinstance(body, dict):
        return body
    out = dict(body)
    if isinstance(out.get("timings"), dict):
        out["timings"] = sorted(out["timings"])
    return out


# -- scenarios: each the JAX suite's test of the same name, as a script ------------

def s_proxies_and_annotates_envelope(side):
    side.post({"prompt": "hello world", "max_tokens": 4})
    side.served()
    side.metrics()


def s_prefix_affinity_pins_chain_to_one_replica(side):
    for i in range(5):
        side.post({"prompt": LONG_PREFIX + f"question {i}"})
    side.note("residency", side.router.residency_entries())
    side.metrics()


def s_least_outstanding_fallback_on_miss(side):
    ra, rb = side.router.replicas
    ra.outstanding = 5
    rep, digests = side.router.pick("short")
    side.note("pick", rep.rid, digests)
    rb.outstanding = 9
    rep, _ = side.router.pick("short")
    side.note("pick", rep.rid)
    ra.outstanding = rb.outstanding = 0


def s_dead_replica_failover_ejection_readmission(side):
    a = side.stub("a")
    a.stop()
    side.pin(LONG_PREFIX, "a")
    side.post({"prompt": LONG_PREFIX + "q"})
    side.note("pick", side.router.pick(LONG_PREFIX + "q")[0].rid)
    side.states()
    for _ in range(side.router.eject_threshold):
        side.router.probe_once()
        side.states()
    side.metrics()
    a.restart()
    side.router.probe_once()
    side.states()
    side.router.probe_once()
    side.states()
    side.metrics()


def s_draining_replica_fails_over_with_cooldown(side):
    side.stub("a").retry_after = "5"
    side.pin(LONG_PREFIX, "a")
    side.post({"prompt": LONG_PREFIX + "q"})
    side.states()
    side.post({"prompt": LONG_PREFIX + "q2"})
    side.served()
    side.metrics()


def s_overloaded_replica_spills_to_peer(side):
    side.pin(LONG_PREFIX, "a")
    side.post({"prompt": LONG_PREFIX + "q"})
    side.states()
    side.metrics()


def s_500_is_never_failed_over(side):
    side.pin(LONG_PREFIX, "a")
    side.post({"prompt": LONG_PREFIX + "q"})
    side.served()
    side.metrics()


def s_all_replicas_rejecting_propagates_retry_after(side):
    for s in side.stubs:
        s.retry_after = "3"
    side.post({"prompt": "anything"})
    side.states()
    side.metrics()


def s_router_ready_and_aggregated_health(side):
    side.get("/ready")
    _, h = _get(side.base, "/health")[:2]
    side.note("health", h["status"], h["replicas_ready"],
              {rid: (r["state"], r["reachable"], r["health"]) for rid, r in h["replicas"].items()})
    for rep in side.router.replicas:
        rep.state = side.R.EJECTED
    side.get("/ready")
    _, h = _get(side.base, "/health")[:2]
    side.note("health", h["status"], h["replicas_ready"])


def s_rolling_restart_rejected_for_url_replicas(side):
    side.post({}, path="/admin/rolling-restart")


def s_stream_never_fails_over_after_partial_output(side):
    side.pin(LONG_PREFIX, "a")
    c = side.C.DistributedLLMClient(side.base, max_retries=3, retry_backoff_s=0.01)
    r = c.generate_stream(LONG_PREFIX + "q", max_tokens=4)
    side.note("stream", r.get("status"))
    side.note("served", [len(s.served()) for s in side.stubs])
    side.metrics()


def s_stream_pre_stream_rejection_fails_over(side):
    side.stub("a").retry_after = "0"
    side.pin(LONG_PREFIX, "a")
    c = side.C.DistributedLLMClient(side.base, max_retries=0)
    r = c.generate_stream(LONG_PREFIX + "q", max_tokens=4)
    side.note("stream", r.get("status"), r.get("served_by"))
    side.note("served", [len(s.served()) for s in side.stubs])


def s_client_retry_through_router_is_bounded(side):
    side.stub("a").retry_after = "0"
    c = side.C.DistributedLLMClient(side.base, max_retries=2, retry_backoff_s=0.01)
    r = c.generate("never succeeds", verbose=False)
    side.note("client", r["status"], len(side.stub("a").served()))
    side.metrics()


def s_tenant_inflight_quota(side):
    side.router.tenant_max_inflight_share = 0.5
    got = [side.router.tenant_begin("t1") for _ in range(6)]
    got += [side.router.tenant_begin(None) for _ in range(3)]
    got += [side.router.tenant_begin("t2") for _ in range(2)]
    side.router.tenant_end("t1")
    got.append(side.router.tenant_begin("t1"))
    side.note("tenants", got)
    side.metrics()


def s_handoff_to_decode_tier_degrades_without_digests(side):
    """A prefill-class and a decode-class stub: a long fresh prompt runs
    phase 1 on the prefill tier; the stub's envelope names no digests, so
    the request is served whole by the decode tier."""
    side.note("topology", side.router.handoff_topology())
    side.post({"prompt": LONG_PREFIX * 2 + "handoff", "max_tokens": 4})
    side.post({"prompt": "short prompt", "max_tokens": 4})
    side.served()
    side.metrics()


def s_residency_learning_and_purge(side):
    side.post({"prompt": LONG_PREFIX + "one"})
    side.note("residency", side.router.residency_entries())
    side.router.purge_residency(side.router.replicas[0].rid)
    side.router.purge_residency(side.router.replicas[1].rid)
    side.note("residency", side.router.residency_entries())
    toks = ["d" * 32, "e" * 32]
    side.router.record_kv_residency(toks, "b")
    side.note("kv_residency", side.router.kv_residency_entries())
    side.pin(LONG_PREFIX, "b")
    rep, digests = side.router.pick(LONG_PREFIX + "x")
    side.note("pick", rep.rid, len(digests))


SCENARIOS = {
    "proxies_and_annotates_envelope": (s_proxies_and_annotates_envelope, "ok", "ok"),
    "prefix_affinity": (s_prefix_affinity_pins_chain_to_one_replica, "ok", "ok"),
    "least_outstanding": (s_least_outstanding_fallback_on_miss, "ok", "ok"),
    "dead_failover_eject_readmit": (s_dead_replica_failover_ejection_readmission, "ok", "ok"),
    "draining_cooldown": (s_draining_replica_fails_over_with_cooldown, "draining", "ok"),
    "overloaded_spills": (s_overloaded_replica_spills_to_peer, "overloaded", "ok"),
    "500_not_failed_over": (s_500_is_never_failed_over, "error500", "ok"),
    "all_rejecting_retry_after": (s_all_replicas_rejecting_propagates_retry_after,
                                  "draining", "draining"),
    "ready_and_health": (s_router_ready_and_aggregated_health, "ok", "ok"),
    "rolling_restart_url_replicas": (s_rolling_restart_rejected_for_url_replicas, "ok", "ok"),
    "stream_partial_no_failover": (s_stream_never_fails_over_after_partial_output,
                                   "stream_die", "ok"),
    "stream_pre_stream_failover": (s_stream_pre_stream_rejection_fails_over,
                                   "draining", "ok"),
    "client_retry_bounded": (s_client_retry_through_router_is_bounded, "draining", None),
    "tenant_quota": (s_tenant_inflight_quota, "ok", "ok"),
    "handoff_degrades": (s_handoff_to_decode_tier_degrades_without_digests, "ok", "ok"),
    "residency": (s_residency_learning_and_purge, "ok", "ok"),
}


def _run(which, name):
    script, mode_a, mode_b = SCENARIOS[name]
    modes = [("a", mode_a)] + ([("b", mode_b)] if mode_b else [])
    classes = {"a": "prefill", "b": "decode"} if name == "handoff_degrades" else None
    side = Side(*SIDES[which], modes, classes=classes)
    try:
        script(side)
    finally:
        side.close()
    return side.log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_decisions_equal_jax(name):
    want = _run("jax", name)
    got = _run("port", name)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w


def test_client_retry_honors_retry_after_like_jax():
    """Every stub rejects with Retry-After 0.4; they recover 0.15 s in:
    both packages' clients through both routers wait the server's delay,
    not their 1 ms backoff, and then succeed."""
    for which in ("jax", "port"):
        side = Side(*SIDES[which], [("a", "draining"), ("b", "draining")])
        try:
            for s in side.stubs:
                s.retry_after = "0.4"

            def recover(side=side):
                time.sleep(0.15)
                for s in side.stubs:
                    s.mode = "ok"
                for rep in side.router.replicas:
                    rep.cooldown_until = 0.0

            threading.Thread(target=recover, daemon=True).start()
            c = side.C.DistributedLLMClient(side.base, max_retries=3,
                                            retry_backoff_s=0.001)
            t0 = time.time()
            r = c.generate("retry me", verbose=False)
            assert r["status"] == "success", (which, r)
            assert time.time() - t0 >= 0.4, which
        finally:
            side.close()


AFFINITY_BODIES = [
    {"prompt": "hello world"},
    {"prompt": LONG_PREFIX + "q", "adapter": "tuned"},
    {"prompts": ["first of a batch", "second"]},
    {"prompts": []},
    {"prompt": "with model", "model": "chat-lora"},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "hi"}, "junk"]},
    {"messages": [{"role": "user", "content": "hi"}], "model": "tuned"},
    {"prompt": "", "messages": None},
    {"prompt": 7},
    {},
]


@pytest.mark.parametrize("i", range(len(AFFINITY_BODIES)))
def test_affinity_key_equals_jax(i):
    body = AFFINITY_BODIES[i]
    key = PR._affinity_key(body)
    assert key == JR._affinity_key(body)
    assert chunk_digests(key, 64, 32) == jax_chunk_digests(key, 64, 32)


def test_router_import_leaves_torch_out():
    """The router is host-side glue: importing it in a fresh interpreter
    imports no torch (and no jax)."""
    code = ("import sys; import distributed_llm_inference_tpu_torch.serving.router; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
