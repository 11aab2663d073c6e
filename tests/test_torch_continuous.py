"""PyTorch port vs JAX package: the continuous paged fleet end to end.

The port's ContinuousEngine on the CPU and the JAX package's, with the
same weights (test-llama-tiny, fp32, no EOS) and the fleet settings of
tests/test_scheduler.py (chunked prefill, no prefix cache, 4 slots, a
120-block pool of 16-token blocks, a 64-token step budget), serve the
same five prompts from threads, a 301-token one among them: the greedy
tokens must be identical, and every pool block comes back. The port's
HTTP server serves the fleet with `--continuous` on the CPU. (The dense
fleet and whole-prefill admission: tests/test_torch_dense_fleet.py and
tests/test_torch_whole_prefill.py.)"""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as S  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
ENGINE = dict(chunked_prefill=True, prefix_cache_entries=0, step_token_budget=64,
              prefill_buckets=(64, 128, 256))
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16)
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",
    " ".join(f"ctx{j}" for j in range(24)) + " question one",
    "short",
    "y " * 150,
    "a b c",
]


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id, so that a
    response pins the exact token ids (the byte decode drops ids past the
    byte range and replaces invalid UTF-8)."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _wave(cont, prompts, **kw):
    out = [None] * len(prompts)

    def run(i):
        out[i] = cont.submit(prompts[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.fixture(scope="module")
def fleets():
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tok = IdTokenizer()
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ENGINE), tokenizer=tok)
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ENGINE), tokenizer=tok, device="cpu")
    jax_fleet = JaxContinuousEngine(jeng, **FLEET)
    port_fleet = ContinuousEngine(teng, **FLEET)
    yield jax_fleet, port_fleet
    jax_fleet.close()
    port_fleet.close()


def test_threaded_greedy_wave_token_identical_to_jax(fleets):
    jax_fleet, port_fleet = fleets
    kw = dict(max_tokens=10, greedy=True, chat=False)
    want = _wave(jax_fleet, PROMPTS, **kw)
    got = _wave(port_fleet, PROMPTS, **kw)
    for w, g in zip(want, got):
        assert w["status"] == g["status"] == "success", (w, g)
        for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason",
                    "backend", "continuous"):
            assert g[key] == w[key], key
        assert g["token_ids"] == [int(t) for t in g["response"].split()]
    # the 301-token prompt landed in chunks over several mixed launches
    assert got[3]["prompt_tokens"] == 301 and got[3]["prefill_chunks"] >= 5
    st = port_fleet.stats()
    assert st["launches"]["mixed"] >= 5 and st["launches"]["decode_chunks"] >= 1
    assert st["scheduler"]["chunked_prefill"] is True
    # every block is back: the pool less its trash block
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    assert st["occupied"] == 0 and st["queued"] == 0
    assert st["completed"] == st["admitted"] == len(PROMPTS)


def test_fleet_answers_like_jax_for_edge_requests(fleets):
    """A prompt over the slot budget fails with invalid_request, and a
    textual stop frees its slot, in both packages."""
    jax_fleet, port_fleet = fleets
    too_long = dict(prompt="z" * 600, max_tokens=4, greedy=True, chat=False)
    a, b = jax_fleet.submit(**too_long), port_fleet.submit(**too_long)
    assert a["status"] == b["status"] == "failed"
    assert a["error_type"] == b["error_type"] == "invalid_request"
    kw = dict(max_tokens=10, greedy=True, chat=False)
    ids = port_fleet.submit("short", **kw)["response"].split()
    stop = dict(kw, stop=[f" {ids[3]} "])
    a, b = jax_fleet.submit("short", **stop), port_fleet.submit("short", **stop)
    assert b["status"] == "success" and b.get("stopped") is True
    for key in ("response", "tokens_generated", "finish_reason", "stopped"):
        assert b[key] == a[key], key
    assert b["response"] == " ".join(ids).split(f" {ids[3]} ")[0]
    free = port_fleet.stats()["paged"]["free_blocks"]
    assert free == FLEET["kv_pool_blocks"] - 1
    # no pool: the dense slot fleet over the same engine, no paged block
    dense = ContinuousEngine(port_fleet.engine, n_slots=2)
    try:
        assert "paged" not in dense.stats() and dense.cache["k"].shape[1] == 2
    finally:
        dense.close()
    # the JAX default policy builds a fleet and reports itself
    swap = ContinuousEngine(create_engine(
        MODEL, device="cpu", engine_cfg=EngineConfig(preempt_policy="swap")),
        n_slots=2, kv_pool_blocks=16)
    try:
        assert EngineConfig().preempt_policy == "swap"
        assert swap.stats()["preemption"] == {
            "policy": "swap", "max_per_request": 2, "preempted_total": 0, "parked": 0}
    finally:
        swap.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_server_continuous_flag_serves_on_the_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--model", MODEL, "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--continuous", "2", "--kv-pool-blocks", "20",
         "--kv-block-size", "16", "--continuous-max-seq", "128"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 90
        while True:
            try:
                if _call(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "server did not come up"
            time.sleep(0.5)
        code, r = _call(port, "/generate", {"prompt": "Hello", "max_tokens": 6,
                                            "greedy": True})
        assert code == 200 and r["status"] == "success", r
        assert r["backend"] == "continuous" and r["continuous"] is True
        assert 1 <= r["tokens_generated"] <= 6
        code, st = _call(port, "/stats")
        assert code == 200
        assert st["continuous"]["slots"] == 2
        assert st["continuous"]["paged"]["free_blocks"] == 19
        assert st["continuous"]["launches"]["mixed"] >= 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_server_rejects_the_dense_fleet_flags():
    # the dense fleet's slots must hold the smallest prefill bucket
    with pytest.raises(ValueError, match="smallest prefill bucket"):
        S.main(["--model", MODEL, "--device", "cpu", "--continuous", "2",
                "--continuous-max-seq", "16"])
    with pytest.raises(SystemExit, match="requires --continuous"):
        S.main(["--model", MODEL, "--device", "cpu", "--kv-pool-blocks", "8"])


def test_loop_crash_fails_requests_in_flight_and_marks_not_ready():
    """A crash in the worker loop goes through the supervisor: within the
    restart budget the fleet restarts and the request in flight answers in
    full (salvaged and re-admitted); past the budget every request in
    flight gets an `unavailable` envelope, and the engine turns not ready
    and refuses new work."""
    eng = create_engine(MODEL, device="cpu")
    fleet = ContinuousEngine(eng, n_slots=2, kv_pool_blocks=20, slot_max_seq=128,
                             restart_backoff_s=0.01)
    try:
        assert fleet.ready
        launch = fleet.backend.mixed_step_ragged
        calls = []

        def once(*a, **k):  # the first mixed launch fails, later ones run
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected launch fault")
            return launch(*a, **k)

        fleet.backend.mixed_step_ragged = once
        r = fleet.submit("hello", max_tokens=4, greedy=True, chat=False)
        assert r["status"] == "success" and 1 <= r["tokens_generated"] <= 4, r
        # the salvaged request can answer before the recovery's last step
        # marks the fleet ready again: wait for it, a few seconds at most
        deadline = time.time() + 5.0
        while not fleet.stats()["supervisor"]["ready"] and time.time() < deadline:
            time.sleep(0.01)
        st = fleet.stats()["supervisor"]
        assert st["restarts"] == 1 and st["ready"] is True and st["dead"] is False
        assert fleet.stats()["paged"]["free_blocks"] == 19
    finally:
        fleet.close()
    # past the budget: with no restart left, the same fault is fatal
    fleet = ContinuousEngine(eng, n_slots=2, kv_pool_blocks=20, slot_max_seq=128,
                             restart_budget=0)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected launch fault")

        fleet.backend.mixed_step_ragged = boom
        r = fleet.submit("hello", max_tokens=4, greedy=True, chat=False)
        assert r["status"] == "failed" and r["error_type"] == "unavailable"
        assert "injected launch fault" in r["error"]
        assert not fleet.ready and fleet.stats()["supervisor"]["dead"] is True
        assert fleet.stats()["paged"]["free_blocks"] == 19
        again = fleet.submit("hello", max_tokens=4, greedy=True, chat=False)
        assert again["status"] == "failed" and again["error_type"] == "unavailable"
    finally:
        fleet.close()
