"""PyTorch port vs JAX package: the bounded batching queue
(serving/queue.py) in front of the solo engine.

The cases of tests/test_queue.py at tier-1 sizes (test-llama-tiny, fp32,
the reference's init_params carried over by models/bridge.py): concurrent
seedless singles coalesce into one left-padded batch whose rows equal the
same requests sent alone, and whose envelopes (`batched_with` included)
equal the JAX queue's for the same burst; a full queue sheds with a 429
envelope carrying a Retry-After hint, over HTTP too; a request whose wait
blew the engine deadline or its own deadline_ms fails while queued; a
drain refuses new work and waits for the dispatcher; seeded, logprobs and
differently penalized requests never share a batch; max_batch is clamped
to the engine's largest batch bucket."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.serving import queue as JQ  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import (  # noqa: E402
    BATCH_BUCKETS,
    InferenceEngine,
    SingleDeviceBackend,
)
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import queue as TQ  # noqa: E402
from distributed_llm_inference_tpu_torch.serving.server import InferenceServer  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (64,)
PROMPTS = ["prompt number 0", "a second prompt", "three"]
GREEDY = dict(max_tokens=5, greedy=True, chat=False)
# the keys that carry ids and clocks, never compared
VOLATILE = ("request_id", "timings", "time_taken", "tokens_per_sec", "ttft_s")


@pytest.fixture(scope="module")
def engines():
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(0))
    tparams = params_from_numpy(get_model_config(MODEL),
                                jax.tree.map(np.asarray, params), "cpu")
    je = JaxEngine(jax_cfg(MODEL), params,
                   engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    pe = create_engine(get_model_config(MODEL), params=tparams,
                       engine_cfg=EngineConfig(prefill_buckets=BUCKETS), device="cpu")
    return je, pe


def _fire(queue, prompts, **kwargs):
    """Submit prompts at once; the results in prompt order."""
    results = [None] * len(prompts)

    def run(i):
        results[i] = queue.submit(prompts[i], **dict(kwargs))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return results


def _stable(env: dict) -> dict:
    return {k: v for k, v in env.items() if k not in VOLATILE}


def test_coalesced_envelopes_equal_jax_and_rows_equal_solo(engines):
    """One burst of three: a single batch in both packages, each member's
    envelope equal to the JAX queue's member, each row equal to its
    request sent alone. The server's non-batch kwargs (speculative,
    logprobs=False, debug=False) ride along without breaking the batch."""
    je, pe = engines
    kw = dict(GREEDY, seed=None, debug=False, speculative=False, logprobs=False)
    out = {}
    for name, mod, eng in (("jax", JQ, je), ("port", TQ, pe)):
        q = mod.BatchingQueue(eng, max_queue=8, max_batch=4, max_wait_ms=300)
        try:
            out[name] = (_fire(q, PROMPTS, **kw), q.coalesced_batches)
        finally:
            q.close()
    (got, n_port), (want, n_jax) = out["port"], out["jax"]
    assert n_port == n_jax == 1
    for g, w, prompt in zip(got, want, PROMPTS):
        assert g["status"] == "success" and g["batched_with"] == 3, g
        assert _stable(g) == _stable(w)
        assert g["prompt"] == prompt
        assert g["response"] == pe.generate(prompt, **GREEDY)["response"]
    assert pe.metrics.get("dli_coalesced_fleets_total").labels().value == 1


class _SlowBackend(SingleDeviceBackend):
    def prefill(self, *a, **kw):
        time.sleep(0.4)
        return super().prefill(*a, **kw)


def _slow_engine(engines, **ecfg):
    _, pe = engines
    return InferenceEngine(pe.cfg, backend=_SlowBackend(pe.cfg, pe.backend.params, "cpu"),
                           engine_cfg=EngineConfig(prefill_buckets=BUCKETS, **ecfg))


def test_full_queue_sheds_with_a_retry_hint(engines):
    q = TQ.BatchingQueue(_slow_engine(engines), max_queue=1, max_batch=1, max_wait_ms=0)
    try:
        results = _fire(q, [f"p{i}" for i in range(6)], max_tokens=2, greedy=True,
                        chat=False)
    finally:
        q.close()
    shed = [r for r in results if r.get("error_type") == "overloaded"]
    assert shed and [r for r in results if r.get("status") == "success"]
    for r in shed:
        assert set(r) == {"error", "status", "error_type", "slo_class", "retry_after_s"}
        assert r["error"] == "Error: request queue full (1)" and r["retry_after_s"] >= 1


class _GatedBackend(_SlowBackend):
    """A slow backend whose first prefill starts its sleep only once
    `waiting` requests sit in `queue`: each of them then waits in the queue
    at least that sleep, however late the host started its thread."""

    queue = None
    waiting = 0

    def prefill(self, *a, **kw):
        limit = time.monotonic() + 30
        while self.queue is not None and self.queue.depth() < self.waiting \
                and time.monotonic() < limit:
            time.sleep(0.005)
        self.queue = None
        return super().prefill(*a, **kw)


def _gated_queue(engines, n: int, **ecfg):
    """A one-at-a-time queue whose first request holds the dispatcher until
    the other n - 1 are queued, then for the slow prefill's 0.4 s."""
    _, pe = engines
    backend = _GatedBackend(pe.cfg, pe.backend.params, "cpu")
    q = TQ.BatchingQueue(InferenceEngine(pe.cfg, backend=backend, engine_cfg=EngineConfig(
        prefill_buckets=BUCKETS, **ecfg)), max_queue=8, max_batch=1, max_wait_ms=0)
    backend.queue, backend.waiting = q, n - 1
    return q


# under the 0.4 s every queued request waits behind the first
QUEUED_DEADLINE_S = 0.2


def test_deadlines_expire_while_queued(engines):
    """The engine deadline counts the wait: a request that waited past it
    fails at dequeue ("while queued"); a request's own deadline_ms that
    ran out in the queue answers deadline_exceeded. The first request holds
    the dispatcher until the others are queued and then for 0.4 s, so each
    of them outlives a 0.2 s deadline in the queue however loaded the host
    is."""
    q = _gated_queue(engines, 4, request_deadline_s=QUEUED_DEADLINE_S)
    try:
        results = _fire(q, [f"p{i}" for i in range(4)], max_tokens=2, greedy=True,
                        chat=False)
        timeouts = [r for r in results if r.get("error_type") == "timeout"]
        assert [r for r in timeouts if "while queued" in r["error"]], results
    finally:
        q.close()
    q = _gated_queue(engines, 3)
    try:
        results = _fire(q, [f"p{i}" for i in range(3)], max_tokens=2, greedy=True,
                        chat=False, deadline_ms=int(QUEUED_DEADLINE_S * 1000))
        late = [r for r in results if r.get("error_type") == "deadline_exceeded"]
        assert any("while queued" in r["error"] for r in late), results
        assert all(r["request_id"] and "timings" in r for r in late
                   if "while queued" in r["error"])
    finally:
        q.close()


def test_drain_refuses_new_work_and_waits(engines):
    q = TQ.BatchingQueue(_slow_engine(engines), max_queue=8, max_batch=1, max_wait_ms=0)
    try:
        t = threading.Thread(target=q.submit, args=("first",),
                             kwargs=dict(max_tokens=2, greedy=True, chat=False))
        t.start()
        time.sleep(0.05)
        assert q.drain(deadline_s=30) is True
        t.join(30)
        r = q.submit("late", max_tokens=2, greedy=True, chat=False)
        assert r == {"error": "Error: server draining", "status": "failed",
                     "error_type": "draining"}
        assert q.depth() == 0
    finally:
        q.close()


def test_coalesce_keys_equal_jax():
    """The grouping rule is the JAX queue's, request shape by request
    shape (a copied module held to its source)."""
    shapes = [
        {"greedy": True, "frequency_penalty": 1.0},
        {"greedy": True, "frequency_penalty": 0.5},
        {"greedy": True, "seed": 3},
        {"greedy": True, "logprobs": True},
        {"greedy": True, "num_beams": 2},
        {"greedy": True, "deadline_ms": 50},
        {"greedy": True, "logit_bias": {"5": 1.0}},
        {"greedy": True, "constraint": {"regex": "[a-z]+"}, "stop": ["x"]},
        {"greedy": True, "speculative": True, "max_tokens": 4},
    ]
    for kw in shapes:
        assert TQ._Pending("x", dict(kw)).coalesce_key() == \
            JQ._Pending("x", dict(kw)).coalesce_key()
    a, b = TQ._Pending("x", dict(shapes[0])), TQ._Pending("y", dict(shapes[1]))
    assert a.coalesce_key() != b.coalesce_key()


def test_max_batch_clamped_to_engine_limit(engines):
    _, pe = engines
    q = TQ.BatchingQueue(pe, max_queue=4, max_batch=999, max_wait_ms=0)
    try:
        assert q.max_batch == BATCH_BUCKETS[-1]
    finally:
        q.close()


def test_queue_over_http_sheds_429_with_retry_after(engines):
    eng = _slow_engine(engines)
    q = TQ.BatchingQueue(eng, max_queue=1, max_batch=1, max_wait_ms=0)
    server = InferenceServer(eng, host="127.0.0.1", port=0, queue=q)
    server.start()
    codes, retry = [], []

    def post():
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate",
            data=json.dumps({"prompt": "x", "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
            if e.code == 429:
                retry.append(e.headers.get("Retry-After"))

    try:
        threads = [threading.Thread(target=post) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats") as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    assert 429 in codes and 200 in codes, codes
    assert retry and all(float(ra) >= 1 for ra in retry), retry
    assert set(stats["queue"]) == {"depth", "coalesced_batches"}
