"""PyTorch port vs JAX package: the solo engine's features through the
HTTP server.

Each package's InferenceServer over the same weights (test-llama-tiny,
fp32, the reference's init_params carried over by models/bridge.py): a
solo server with the prefix cache, one with the batching queue in front
(`--queue`), and the dense fleet with its prefix cache. The same requests
go to both and the answers must be equal but for ids and clocks (beam
scores within 1e-5): `/generate` with `num_beams` and with
`"speculative": true`, a head shared by two requests on the solo server
and on the dense fleet (`prefix_cached_tokens`, `/stats` prefix_cache), a
burst on the queue server (`batched_with`, `/stats` queue), a fifth
concurrent echo scorer shed with 429. Last, the port's CLI: `--queue`,
`--queue-max-batch`, `--queue-wait-ms`, `--prefix-cache` on the solo
engine and the dense fleet, `--draft-model`, and `--continuous` with
`--queue` refused."""

import json
import threading
import urllib.error
import urllib.request

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
from distributed_llm_inference_tpu.serving import queue as JQ  # noqa: E402
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import queue as TQ  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402

MODEL = "test-llama-tiny"
ECFG = dict(prefill_buckets=(16, 32, 64), prefix_cache_entries=2, prefix_chunk=16)
VOLATILE = ("request_id", "timings", "time_taken", "tokens_per_sec", "ttft_s", "id",
            "created")
HEAD = "You are a helpful assistant. Answer briefly: "


@pytest.fixture(scope="module")
def servers():
    """{"solo" | "queue" | "dense": {pkg: InferenceServer}}."""
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(4))
    tparams = params_from_numpy(get_model_config(MODEL),
                                jax.tree.map(np.asarray, params), "cpu")

    def engine(pkg, **ecfg):
        if pkg == "jax":
            return JaxEngine(jax_cfg(MODEL), params, engine_cfg=JaxEngineConfig(**ecfg))
        return create_engine(get_model_config(MODEL), params=tparams,
                             engine_cfg=EngineConfig(**ecfg), device="cpu")

    out = {"solo": {}, "queue": {}, "dense": {}}
    for pkg, S, Q, C in (("jax", JS, JQ, JC), ("port", TS, TQ, TC)):
        out["solo"][pkg] = S.InferenceServer(engine(pkg, **ECFG), host="127.0.0.1", port=0)
        qeng = engine(pkg, prefill_buckets=(64,))
        out["queue"][pkg] = S.InferenceServer(
            qeng, host="127.0.0.1", port=0,
            queue=Q.BatchingQueue(qeng, max_queue=8, max_batch=4, max_wait_ms=300))
        deng = engine(pkg, **ECFG)
        out["dense"][pkg] = S.InferenceServer(
            deng, host="127.0.0.1", port=0,
            continuous=C.ContinuousEngine(deng, n_slots=2, slot_max_seq=128))
    for group in out.values():
        for srv in group.values():
            srv.start()
    yield out
    for group in out.values():
        for srv in group.values():
            srv.shutdown()


def _call(srv, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


def _both(servers, kind, path, body=None):
    return {pkg: _call(srv, path, body) for pkg, srv in servers[kind].items()}


def _equal(res):
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc, res
    assert _stable(t) == _stable(j)
    return tc, t


def test_generate_num_beams_equals_jax(servers):
    res = _both(servers, "solo", "/generate", {
        "prompt": "Once upon a time", "max_tokens": 8, "chat": False, "num_beams": 3,
        "length_penalty": 1.5, "early_stopping": True})
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc == 200
    for g, w in zip(t.pop("beams"), j.pop("beams")):
        assert g.pop("score") == pytest.approx(w.pop("score"), abs=1e-5)
        assert g == w
    assert _stable(t) == _stable(j) and t["num_beams"] == 3
    # a batch asks for one prompt per beam search: the same 400
    code, out = _equal(_both(servers, "solo", "/generate", {
        "prompts": ["a", "b"], "num_beams": 2}))
    assert code == 400 and "num_beams requires a single 'prompt'" in out["error"]


def test_generate_speculative_equals_jax(servers):
    code, out = _equal(_both(servers, "solo", "/generate", {
        "prompt": "ab ab ab ab ab ab ab ab", "max_tokens": 12, "chat": False,
        "greedy": True, "speculative": True}))
    assert code == 200 and out["speculative"] is True and out["spec_path"] == "solo"


@pytest.mark.parametrize("kind", ["solo", "dense"])
def test_prefix_hits_equal_jax(servers, kind):
    """The second request behind the shared head splices the first one's
    snapshot; the dense fleet's answers differ from the solo engine's only
    in their fleet keys, which both packages' fleets carry alike but for
    the port's token_ids and prefill_chunks."""
    for tail in ("what is two plus two?", "name a colour."):
        res = _both(servers, kind, "/generate", {
            "prompt": HEAD + tail, "max_tokens": 6, "chat": False, "greedy": True})
        (jc, j), (tc, t) = res["jax"], res["port"]
        assert jc == tc == 200
        for k in ("token_ids", "prefill_chunks"):
            t.pop(k, None)
        assert _stable(t) == _stable(j)
    assert t["prefix_cached_tokens"] == 32
    (_, js), (_, ts) = _both(servers, kind, "/stats").values()
    stats = (lambda s: s["continuous"]) if kind == "dense" else (lambda s: s)
    assert stats(ts)["prefix_cache"] == stats(js)["prefix_cache"]


def test_queue_burst_equals_jax(servers):
    prompts = ["first queued prompt", "second", "a third one"]
    out = {}
    for pkg, srv in servers["queue"].items():
        res = [None] * len(prompts)

        def run(i, srv=srv, res=res):
            res[i] = _call(srv, "/generate", {"prompt": prompts[i], "max_tokens": 5,
                                              "chat": False, "greedy": True})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        out[pkg] = (res, _call(srv, "/stats")[1]["queue"])
    (got, gq), (want, wq) = out["port"], out["jax"]
    for (tc, t), (jc, j) in zip(got, want):
        assert tc == jc == 200 and t["batched_with"] == 3
        assert _stable(t) == _stable(j)
    assert gq == wq == {"depth": 0, "coalesced_batches": 1}


def test_fifth_concurrent_scorer_gets_429(servers):
    """Four scorers hold the four score slots (each engine's score blocked
    on an event); a fifth answers the JAX server's 429 OpenAI error, and
    the four answer once released."""
    body = {"prompt": "score me", "echo": True, "logprobs": 1, "max_tokens": 0}
    results = {}
    for pkg, srv in servers["solo"].items():
        eng = srv.engine
        release, entered = threading.Event(), threading.Semaphore(0)
        real = eng.score

        def held(prompt, top_n=0, real=real, release=release, entered=entered):
            entered.release()
            release.wait(60)
            return real(prompt, top_n=top_n)

        eng.score = held
        try:
            res = []
            threads = [threading.Thread(target=lambda: res.append(
                _call(srv, "/v1/completions", body))) for _ in range(4)]
            for th in threads:
                th.start()
            for _ in range(4):
                assert entered.acquire(timeout=60)
            fifth = _call(srv, "/v1/completions", body)
            release.set()
            for th in threads:
                th.join(60)
        finally:
            del eng.score
        results[pkg] = (fifth, sorted(code for code, _ in res))
    (tf, tcodes), (jf, jcodes) = results["port"], results["jax"]
    assert tf[0] == jf[0] == 429 and tf[1] == jf[1]
    assert tf[1]["error"]["type"] == "overloaded_error"
    assert tcodes == jcodes == [200] * 4


def test_cli_flags_reach_the_engine(monkeypatch):
    built = {}

    class Server:
        def __init__(self, engine, *a, continuous=None, queue=None, **kw):
            built.update(engine=engine, fleet=continuous, queue=queue)

        def serve_forever(self):
            pass

    monkeypatch.setattr(TS, "InferenceServer", Server)
    base = ["--model", MODEL, "--device", "cpu"]
    TS.main(base + ["--queue", "4", "--queue-max-batch", "2", "--queue-wait-ms", "7",
                    "--prefix-cache", "2", "--draft-model", MODEL])
    q = built["queue"]
    try:
        assert (q.max_queue, q.max_batch, q.max_wait_s) == (4, 2, 0.007)
        assert built["fleet"] is None and built["engine"]._prefix is not None
        assert built["engine"]._draft[0].name == MODEL
    finally:
        q.close()
    TS.main(base + ["--continuous", "2", "--prefix-cache", "2"])
    fleet = built["fleet"]
    try:
        assert fleet._prefix is not None and built["queue"] is None
    finally:
        fleet.close()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        TS.main(base + ["--continuous", "2", "--queue", "4"])
