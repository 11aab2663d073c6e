"""The port's HTTP server on the CPU: /generate (solo and batch), /health,
/ready, /stats, and error answers whose codes and envelope keys are the
JAX server's for the same request."""

import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

from distributed_llm_inference_tpu import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu import create_engine as jax_create_engine  # noqa: E402
from distributed_llm_inference_tpu.serving.server import InferenceServer as JaxServer  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving.server import InferenceServer  # noqa: E402


def _start(server):
    server.start()
    return server


@pytest.fixture(scope="module")
def servers():
    port = _start(InferenceServer(
        create_engine("test-llama-tiny", device="cpu",
                      engine_cfg=EngineConfig(prefill_buckets=(64, 128))),
        host="127.0.0.1", port=0,
    ))
    ref = _start(JaxServer(
        jax_create_engine("test-llama-tiny",
                          engine_cfg=JaxEngineConfig(prefill_buckets=(64, 128))),
        host="127.0.0.1", port=0,
    ))
    yield port, ref
    port.shutdown()
    ref.shutdown()


def call(server, path, body=None):
    url = f"http://127.0.0.1:{server.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_solo_and_batch(servers):
    port, _ = servers
    code, r = call(port, "/generate", {"prompt": "Hello", "max_tokens": 6,
                                       "greedy": True})
    assert code == 200 and r["status"] == "success"
    assert 1 <= r["tokens_generated"] <= 6 and r["backend"] == "single-device"
    code, r = call(port, "/generate", {"prompts": ["a", "bcd"], "max_tokens": 4,
                                       "seed": 1})
    assert code == 200 and len(r["results"]) == 2


def test_health_ready_stats(servers):
    port, ref = servers
    code, h = call(port, "/health")
    assert code == 200 and h["status"] == "healthy" and h["ready"] is True
    assert set(h) == set(call(ref, "/health")[1])
    assert call(port, "/ready") == (200, {"ready": True})
    code, s = call(port, "/stats")
    assert code == 200 and "ttft_p50_s" in s


@pytest.mark.parametrize("body", [
    {"max_tokens": 5},  # no prompt
    {"prompt": "x" * 200, "max_tokens": 5, "chat": False},  # past the cache
    {"prompt": "x", "greedy": "maybe"},  # bad parameter
    {"prompt": "x", "slo_class": "gold"},  # unknown SLO class
])
def test_errors_match_jax_server(servers, body):
    port, ref = servers
    code, got = call(port, "/generate", body)
    ref_code, want = call(ref, "/generate", body)
    assert code == ref_code == 400
    assert set(got) == set(want)
