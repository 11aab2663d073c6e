"""Multi-process serving of the port (parallel/mesh.multihost_initialize,
serving/multihost.py, the server's --coordinator / --num-processes /
--process-id), on the CPU.

The non-slow cases of tests/test_multihost.py with the process group's
bring-up stubbed: the argument plumbing, partial and out-of-range
coordination, the server CLI, the timing-dependent layers refused, and
the three bounded-shutdown cases. Then real processes: two joined in a
gloo group broadcast requests through `_broadcast_obj` and drive a
follower loop; two server processes' pp = 2 mesh, one rank in each, read
their shards off one store and generate the JAX single-device engine's
ids on the same store (and the port's single device's). The
two-process HTTP server run is slow-marked, as the JAX one is; chip_smoke
(H) runs it on the card.

Tolerance: greedy ids equal.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
import torch.distributed as dist  # noqa: E402

from distributed_llm_inference_tpu_torch.parallel import mesh as PM  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import multihost as mh  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")
# a process's bring-up (torch's import, the gloo rendezvous) and a tiny
# model's build and request on a loaded host, with room to spare
PROCESS_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def captured(monkeypatch):
    """init_process_group stubbed: its keyword arguments, and the group's
    size and rank taken from them (or from torch's env:// variables)."""
    calls = []
    monkeypatch.setattr(PM, "_HOSTS", None)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append({"backend": backend, **kw}))
    monkeypatch.setattr(dist, "get_world_size", lambda: calls[-1].get(
        "world_size", int(os.environ.get("WORLD_SIZE", 1))))
    monkeypatch.setattr(dist, "get_rank", lambda: calls[-1].get(
        "rank", int(os.environ.get("RANK", 0))))
    return calls


def _strip(call):
    return {k: v for k, v in call.items() if k != "timeout"}


def test_explicit_coordination_plumbs_through(captured):
    PM.multihost_initialize(coordinator_address="10.0.0.1:1234", num_processes=4,
                            process_id=2)
    assert [_strip(c) for c in captured] == [{
        "backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4,
        "rank": 2}]
    assert (PM.process_count(), PM.process_index()) == (4, 2)
    assert PM._HOSTS["host"] == "10.0.0.1" and PM._HOSTS["port"] == 1234
    # a mesh of 8 ranks over 4 processes: process 2 owns ranks 4 and 5
    assert list(PM.local_ranks(PM.MeshConfig(pp=4, tp=2))) == [4, 5]


def test_auto_detection_reads_the_environment(captured, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "7")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    PM.multihost_initialize()
    assert [_strip(c) for c in captured] == [{"backend": "gloo", "init_method": "env://"}]
    assert (PM.process_count(), PM.process_index()) == (2, 1)


def test_extra_kwargs_forwarded(captured):
    PM.multihost_initialize(coordinator_address="h:1", num_processes=2, process_id=0,
                            group_name="serving")
    assert captured[0]["group_name"] == "serving"


def test_partial_coordination_rejected(captured):
    with pytest.raises(ValueError, match="together"):
        PM.multihost_initialize(coordinator_address="h:1")
    with pytest.raises(ValueError, match="together"):
        PM.multihost_initialize(num_processes=2, process_id=0)
    assert captured == []  # refused before any group is made


def test_process_id_range_checked(captured):
    with pytest.raises(ValueError, match="out of range"):
        PM.multihost_initialize(coordinator_address="h:1", num_processes=2, process_id=2)
    assert captured == []


def test_server_cli_wires_coordination(captured, monkeypatch):
    """--coordinator / --num-processes / --process-id reach
    multihost_initialize before the engine is built."""
    from distributed_llm_inference_tpu_torch import runtime
    from distributed_llm_inference_tpu_torch.serving import server

    class _Stop(Exception):
        pass

    def bail(*a, **kw):
        raise _Stop

    monkeypatch.setattr(runtime, "create_engine", bail)
    with pytest.raises(_Stop):
        server.main(["--model", "test-llama-tiny", "--device", "cpu", "--coordinator",
                     "c:9999", "--num-processes", "2", "--process-id", "1"])
    assert [_strip(c) for c in captured] == [{
        "backend": "gloo", "init_method": "tcp://c:9999", "world_size": 2, "rank": 1}]


@pytest.mark.parametrize("flag", ["--continuous", "--queue"])
def test_multiprocess_rejects_timing_dependent_layers(monkeypatch, flag):
    """--continuous / --queue cannot mirror across processes: the server
    exits before any model is built."""
    from distributed_llm_inference_tpu_torch.serving import server

    monkeypatch.setattr(PM, "_HOSTS", {"host": "h", "port": 1, "num_processes": 2,
                                       "process_id": 0})
    with pytest.raises(SystemExit, match="ARRIVAL TIMING"):
        server.main(["--model", "test-llama-tiny", "--device", "cpu", flag, "2",
                     "--port", "0"])


def test_shutdown_followers_bounded_when_follower_dead(monkeypatch):
    """A dead follower never answers the shutdown broadcast: the leader's
    exit is bounded (the broadcast runs on a daemon thread abandoned past
    timeout_s)."""
    m = mh.MirroredEngine(object())
    hung = threading.Event()

    def _hang(obj, is_source):
        hung.set()
        time.sleep(30)

    monkeypatch.setattr(mh, "_broadcast_obj", _hang)
    t0 = time.time()
    assert m.shutdown_followers(timeout_s=0.2) is False
    assert time.time() - t0 < 5
    assert hung.wait(5)  # the broadcast really was attempted


def test_shutdown_followers_returns_true_on_fast_broadcast(monkeypatch):
    m = mh.MirroredEngine(object())
    seen = []
    monkeypatch.setattr(mh, "_broadcast_obj", lambda obj, is_source: seen.append(obj))
    assert m.shutdown_followers(timeout_s=5.0) is True
    assert seen == [mh._SHUTDOWN]


def test_shutdown_followers_bounded_when_issue_lock_held(monkeypatch):
    """A wedged mirrored call holds the issue lock: the shutdown's lock
    acquisition lives on the same abandoned thread as its broadcast."""
    m = mh.MirroredEngine(object())
    sent = threading.Event()
    monkeypatch.setattr(mh, "_broadcast_obj", lambda obj, is_source: sent.set())
    with m._issue_lock:
        assert m.shutdown_followers(timeout_s=0.2) is False
    # the lock released, the abandoned thread's broadcast completes (while
    # the stub is still in place)
    assert sent.wait(5)


_BROADCAST_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from distributed_llm_inference_tpu_torch.parallel import mesh as PM
from distributed_llm_inference_tpu_torch.serving import multihost as mh

pid = int(sys.argv[1])
PM.multihost_initialize("127.0.0.1:" + sys.argv[2], 2, pid)
if pid == 0:
    class Engine:
        def generate(self, *a, **kw):
            return "leader"
        def score(self, *a, **kw):
            return "scored"
    m = mh.MirroredEngine(Engine())
    print(m.generate("hello", max_tokens=3), flush=True)
    print(m.score("x" * 60000, top_n=1), flush=True)
    print(json.dumps(mh._broadcast_obj({{"m": "generate_batch", "a": [["p", "q"]],
                                        "kw": {{}}}}, True)), flush=True)
    print("shutdown", m.shutdown_followers(timeout_s=30), flush=True)
else:
    seen = []
    class Engine:
        def generate(self, *a, **kw):
            seen.append(["generate", a, kw])
        def score(self, *a, **kw):
            seen.append(["score", len(a[0]), kw])
        def generate_batch(self, *a, **kw):
            seen.append(["generate_batch", a, kw])
    mh.follower_loop(Engine(), pid)
    print("SEEN:" + json.dumps(seen), flush=True)
dist.destroy_process_group()
"""


def test_two_process_broadcast_drives_the_follower_loop(tmp_path):
    """Two processes in a gloo group at the coordinator: the leader's
    mirrored calls (a request of 60 000 bytes among them) and a raw
    broadcast reach the follower loop in order, with their arguments; the
    shutdown releases it."""
    probe = tmp_path / "probe.py"
    probe.write_text(_BROADCAST_PROBE.format(root=ROOT))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(probe), str(i), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert "leader" in outs[0] and "shutdown True" in outs[0], outs[0]
    seen = json.loads(next(line for line in outs[1].splitlines()
                           if line.startswith("SEEN:"))[len("SEEN:"):])
    assert seen == [["generate", ["hello"], {"max_tokens": 3}],
                    ["score", 60000, {"top_n": 1}],
                    ["generate_batch", [["p", "q"]], {}]]


def _store(tmp_path, seed):
    import jax

    from distributed_llm_inference_tpu.models import api as JM
    from distributed_llm_inference_tpu.models import checkpoint as JS
    from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg

    cfg = jax_cfg("test-llama-tiny")
    path = str(tmp_path / "mh_store")
    JS.save_params(path, cfg, JM.init_params(cfg, jax.random.PRNGKey(seed)))
    return path


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _references(store, prompt, tokenizer) -> dict:
    """One greedy request of 5 tokens on the store's weights: the JAX
    package's single-device InferenceEngine and the port's single device,
    both with `tokenizer`."""
    from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
    from distributed_llm_inference_tpu.models import checkpoint as JS
    from distributed_llm_inference_tpu_torch.models.checkpoint import load_params
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    kw = dict(max_tokens=5, greedy=True, chat=False)
    jcfg, jparams = JS.load_params(store)
    cfg, params = load_params(store)
    return {"jax": JaxEngine(jcfg, params=jparams, tokenizer=tokenizer).generate(prompt, **kw),
            "port": create_engine(cfg, params=params, tokenizer=tokenizer,
                                  device="cpu").generate(prompt, **kw)}


def test_two_process_pipelined_generate(tmp_path):
    """Two server processes, one pp = 2 mesh spanning both (one rank each,
    each reading its own shard off the store): both drivers run the same
    programs and return the JAX single-device engine's ids on the same
    store (and the port's single device's); each process sees its own
    stage online and the other's "remote"."""
    pytest.importorskip("jax")
    store = _store(tmp_path, 31)
    refs = _references(store, "multi host hello", IdTokenizer())
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), port, store],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    results = {}
    try:
        for i, p in enumerate(procs):
            out = p.communicate(timeout=PROCESS_S)[0]
            assert p.returncode == 0, f"process {i} rc={p.returncode}:\n{out[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT:")]
            assert line, out[-2000:]
            results[i] = json.loads(line[-1][len("RESULT:"):])
    finally:
        for p in procs:
            p.kill()
    assert refs["jax"]["response"] == refs["port"]["response"]
    assert refs["jax"]["response"].split()  # ids spelled, at least one
    for i in (0, 1):
        assert results[i]["status"] == "success", results[i]
        assert results[i]["response"] == refs["jax"]["response"]
        assert results[i]["tokens"] == refs["jax"]["tokens_generated"]
        assert results[i]["stages"] == {f"stage_{i}": "online",
                                        f"stage_{1 - i}": "remote"}
        assert len(results[i]["store_bytes"]) == 1 and results[i]["store_bytes"][0] > 0


@pytest.mark.slow
def test_two_process_server_cli(tmp_path):
    """The server CLI on a two-process mesh: process 0 serves HTTP and
    mirrors each request (serving/multihost.MirroredEngine), process 1
    runs the follower loop; /generate answers the JAX single-device
    engine's text on the same store (the byte tokenizer the server falls
    back to), as the port's single device does, and a SIGTERM to process 0
    ends both within the bounded shutdown."""
    import signal
    import urllib.request

    store = _store(tmp_path, 41)
    refs = _references(store, "serve me twice", ByteTokenizer())
    assert refs["jax"]["response"] == refs["port"]["response"]
    expected = refs["jax"]
    coord, http_port = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--checkpoint", store, "--pp", "2", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2",
         "--process-id", str(i), "--host", "127.0.0.1", "--port", str(http_port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True, cwd=ROOT)
        for i in range(2)]
    try:
        deadline = time.time() + PROCESS_S
        up = False
        while time.time() < deadline and not any(p.poll() is not None for p in procs):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/health",
                                            timeout=2) as r:
                    up = r.status == 200
                    break
            except OSError:
                time.sleep(0.5)
        assert up, "the server never came up"
        for _ in range(2):  # a second request rides the broadcast again
            req = urllib.request.Request(
                f"http://127.0.0.1:{http_port}/generate", method="POST",
                data=json.dumps({"prompt": "serve me twice", "max_tokens": 5,
                                 "greedy": True, "chat": False}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=PROCESS_S) as r:
                got = json.loads(r.read())
            assert got["status"] == "success" and got["response"] == expected["response"]
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            p.kill()
            p.communicate(timeout=30)
