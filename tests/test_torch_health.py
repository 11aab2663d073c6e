"""PyTorch port vs JAX package: the health sweep, the status page, the
flight recorder and the profiler routes.

The engine's `health()` / `workers()` and the servers' `GET /workers`,
`GET /`, `GET /debug/flight`, `GET /ready` and `POST /profiler/start|stop`
answer with the JAX envelopes (tests/test_server.py::test_workers_sweep,
tests/test_engine.py::test_health_and_workers,
tests/test_failure.py::test_workers_probe_reports_timing), each server in
process on the CPU over test-llama-tiny with its continuous paged fleet.
The profiler names a subdirectory under its base, never a path."""

import json
import os
import time
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
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.probe import probe_device  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
ENGINE = dict(prefill_buckets=(32, 64), prefix_cache_entries=0)
FLEET = dict(n_slots=2, chunk_steps=4, slot_max_seq=64, kv_pool_blocks=24,
             kv_block_size=8, restart_backoff_s=0.01)


@pytest.fixture(scope="module")
def servers():
    """{"jax": (engine, fleet, port), "port": (...)}, both serving."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ENGINE))
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ENGINE), device="cpu")
    out, started = {}, []
    for name, S, C, eng in (("jax", JS, JC, jeng), ("port", TS, TC, teng)):
        fleet = C.ContinuousEngine(eng, **FLEET)
        srv = S.InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=64,
                                continuous=fleet)
        srv.start()
        started.append(srv)
        out[name] = (eng, fleet, srv.port)
    yield out
    for srv in started:
        srv.shutdown()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_workers_as_in_jax(servers):
    """engine.health() and engine.workers(): the same keys and statuses."""
    (jeng, _, _), (teng, _, _) = servers["jax"], servers["port"]
    jh, th = jeng.health(), teng.health()
    assert th["status"] == jh["status"] == "healthy"
    assert th["n_stages"] == jh["n_stages"] == 1
    assert set(th) == set(jh)
    jw, tw = jeng.workers(), teng.workers()
    assert tw["total"] == jw["total"] == 1
    assert set(tw["workers"]) == set(jw["workers"]) == {"stage_0"}
    js, ts = jw["workers"]["stage_0"], tw["workers"]["stage_0"]
    assert ts["status"] == js["status"] == "online"
    assert set(ts) == set(js) == {"stage", "devices", "status", "probe_ms"}
    assert ts["probe_ms"] >= 0.0 and ts["devices"] == ["cpu"]


def test_workers_sweep_as_in_jax(servers):
    """GET /workers: the source system's shape, worker_1 online plus detail."""
    got = {}
    for name, (_, _, port) in servers.items():
        code, _, body = _get(port, "/workers")
        assert code == 200, name
        got[name] = json.loads(body)
    assert got["port"]["worker_1"] == got["jax"]["worker_1"] == "online"
    assert set(got["port"]) == set(got["jax"]) == {"worker_1", "detail"}
    assert [set(d) for d in got["port"]["detail"]] == [set(d) for d in got["jax"]["detail"]]


def test_workers_report_busy_while_a_generation_holds_the_engine(servers):
    """A probe that times out while a generation holds the engine lock
    reads "busy", not "offline", in both engines."""
    for name, (eng, _, _) in servers.items():
        real = eng.backend.health
        eng.backend.health = lambda: [{"stage": 0, "devices": ["cpu"], "status": "offline",
                                       "error": "device probe timed out after 5.0s"}]
        try:
            with eng._lock:
                busy = eng.workers()["workers"]["stage_0"]
            idle = eng.workers()["workers"]["stage_0"]
        finally:
            eng.backend.health = real
        assert busy["status"] == "busy" and "in-flight generation" in busy["error"], name
        assert idle["status"] == "offline", name


def test_probe_device_error_and_timeout_paths():
    def raising():
        raise RuntimeError("device exploded")

    r = probe_device(None, _op=raising)
    assert r["status"] == "error" and "device exploded" in r["error"]

    def hanging():
        time.sleep(5)

    r = probe_device(None, timeout_s=0.2, _op=hanging)
    assert r["status"] == "offline" and "timed out" in r["error"]
    r = probe_device("cpu")
    assert r["status"] == "online" and r["probe_ms"] >= 0.0


def test_status_page_and_flight_recorder_as_in_jax(servers):
    """GET / answers the HTML status page; GET /debug/flight the ring, in
    which a served request left its admission."""
    for name, (_, _, port) in servers.items():
        code, ctype, body = _get(port, "/")
        assert code == 200 and ctype.startswith("text/html"), name
        assert "<table" in body and "stage 0" in body, name
        code, r = _post(port, "/generate", {"prompt": "hello", "max_tokens": 3,
                                            "greedy": True, "chat": False})
        assert code == 200 and r["status"] == "success", (name, r)
        code, _, body = _get(port, "/debug/flight")
        flight = json.loads(body)
        assert code == 200, name
        assert set(flight) == {"capacity", "recorded_total", "events"}, name
        assert any(e["kind"] == "admit" for e in flight["events"]), name


def test_ready_reports_scheduler_restarting_and_dead_as_in_jax(servers):
    for name, (_, fleet, port) in servers.items():
        assert _get(port, "/ready")[0] == 200, name
        fleet._restarting = True
        try:
            code, _, body = _get(port, "/ready")
            assert code == 503 and json.loads(body)["reason"] == "scheduler_restarting", name
            fleet._dead = True
            code, _, body = _get(port, "/ready")
            assert code == 503 and json.loads(body)["reason"] == "scheduler_dead", name
        finally:
            fleet._restarting = fleet._dead = False
        assert _get(port, "/ready")[0] == 200, name


def test_poison_answers_500_as_in_jax(servers):
    """A request quarantined as poison answers HTTP 500 with error_type
    "poison" from both servers, and the fleet stays ready."""
    from distributed_llm_inference_tpu.utils import faults as jax_faults
    from distributed_llm_inference_tpu_torch.utils import faults as port_faults

    for name, fm in (("jax", jax_faults), ("port", port_faults)):
        port = servers[name][2]
        fm.arm([fm.FaultRule("prefill", "fatal", match="POISONPILL", every=1, times=0)])
        try:
            code, r = _post(port, "/generate", {"prompt": "POISONPILL x", "max_tokens": 3,
                                                "greedy": True, "chat": False})
        finally:
            fm.disarm()
        assert code == 500 and r["error_type"] == "poison", (name, r)
        # the supervisor restarts after the quarantine: ready again soon
        t0 = time.time()
        while _get(port, "/ready")[0] != 200:
            assert time.time() - t0 < 30, f"{name}: not ready after the quarantine"
            time.sleep(0.01)


def test_no_route_of_the_jax_server_answers_404(servers):
    """Every GET route of the JAX server's single-device fleet is served
    on the port, none with 404 or 501 (/debug/traces, the last one not
    ported, since the fleet tier's traces); the OpenAI routes are served."""
    port = servers["port"][2]
    for path in ("/", "/health", "/ready", "/workers", "/stats", "/metrics",
                 "/debug/flight", "/v1/models", "/debug/traces"):
        code, _, body = _get(port, path)
        assert code not in (404, 501), (path, body)
    assert _get(port, "/v1/models")[0] == 200
    code, _, body = _get(port, "/debug/traces")
    assert code == 200 and "traces" in json.loads(body)
    for path in ("/v1/completions", "/v1/chat/completions"):
        body = ({"prompt": "x", "max_tokens": 2} if path == "/v1/completions" else
                {"messages": [{"role": "user", "content": "x"}], "max_tokens": 2})
        # served: the JAX server's answer (the chat template's system turn
        # alone overflows this fleet's slot: 400 from both)
        code = _post(port, path, body)[0]
        assert code == _post(servers["jax"][2], path, body)[0] not in (404, 501), path
    assert _get(port, "/no/such/route")[0] == 404


@pytest.mark.parametrize("mod", [JS, TS], ids=["jax", "port"])
def test_profiler_path_guard(mod, tmp_path):
    """trace_dir is a subdirectory name under the base: an absolute path or
    a `..` escape is refused before anything starts."""
    prof = mod._Profiler(str(tmp_path))
    assert prof._resolve("run1") == os.path.join(str(tmp_path), "run1")
    for bad in ("/etc", "../escape", "a/../../b"):
        with pytest.raises(ValueError):
            prof._resolve(bad)
        assert "error" in prof.start(bad) and prof.dir is None


def test_profiler_routes_trace_a_request(servers):
    """POST /profiler/start, one request, POST /profiler/stop: a non-empty
    torch.profiler trace under the base; the guard answers 400."""
    port = servers["port"][2]
    code, r = _post(port, "/profiler/start", {"trace_dir": "../x"})
    assert code == 400 and "error" in r
    code, r = _post(port, "/profiler/stop", {})
    assert code == 400 and r["error"] == "no trace running"
    code, r = _post(port, "/profiler/start", {"trace_dir": "health-test"})
    assert code == 200 and r["status"] == "tracing", r
    trace_dir = r["trace_dir"]
    assert _post(port, "/profiler/start", {})[0] == 400  # already running
    code, g = _post(port, "/generate", {"prompt": "hello", "max_tokens": 3,
                                        "greedy": True, "chat": False})
    assert code == 200, g
    code, r = _post(port, "/profiler/stop", {})
    assert code == 200 and r == {"status": "stopped", "trace_dir": trace_dir}
    trace = os.path.join(trace_dir, "trace.json")
    assert os.path.getsize(trace) > 0
    assert json.load(open(trace))["traceEvents"]
