"""PyTorch port vs JAX package: the multi-process MPMD stage pipeline
(serving/stage_runtime.py), its stage planning (parallel/schedule.py) and
its wire.

  * `plan_stages` and `mpmd_1f1b_order` equal the JAX functions over a
    grid of sizes.
  * In process, on the JAX package's `init_params(PRNGKey(0))` weights
    carried over by models/bridge.py: a chain of the port's StageWorkers
    at 2 and 3 stages against the JAX StageWorker chain on the same
    window stream (each stage's hidden state within 1e-5 in fp32, equal
    greedy ids, equal shadow positions with K/V within 1e-5), and a
    worker respawned on the restore directory taking the next step as the
    uninterrupted one; bf16 shadows restore bit-exact.
  * Both packages' stage HTTP planes in process: the same routes,
    statuses and headers, and each package's transport driving the other
    package's stages, raw and int8 (the wire format is shared).
  * A subprocess fleet of the port's stages on the CPU (`--device cpu`)
    against the port's single-process greedy reference on the same seed:
    the kill -9 chaos matrix (victim x boundary x restore; the decode x
    warm cells in the fast tier, the rest `slow` as in the JAX suite),
    transport fault points, traceparent, and, `slow`, the heartbeat
    wedge, the rolling restart under load, the int8 wire and the frontend
    CLI behind the port's router.
  * `DeviceStageTransport` refuses as the JAX one does; a stage or a
    frontend asked for `--device cuda` on a host with no card exits
    non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import (  # noqa: E402
    get_model_config as jax_cfg,
)
from distributed_llm_inference_tpu.parallel import schedule as JS  # noqa: E402
from distributed_llm_inference_tpu.serving import stage_runtime as JSR  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import schedule as PS  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import router as PR  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import stage_runtime as SR  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODEL = "test-llama-tiny"
BLOCK = 8
PROMPT = "stage chaos!"  # 13 tokens with bos: boundary-misaligned on purpose
N_NEW = 16
KILL_AFTER = 6  # decode steps before the mid-decode SIGKILL
ATOL = 1e-5


def _stage_env(extra=None):
    env = dict(os.environ)
    env.pop("DLI_FAULTS", None)
    # one intra-op thread: the stages share a small host with the suite
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra or {})
    return env


def wait_until(pred, timeout_s: float, interval_s: float = 0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return False


# -- pure glue: stage planning + 1F1B order ----------------------------------

@pytest.mark.parametrize("n_layers", [1, 2, 3, 4, 5, 7, 22, 32, 48])
def test_plan_stages_equal_jax(n_layers):
    for n_stages in range(0, n_layers + 2):
        try:
            want = JS.plan_stages(n_layers, n_stages)
        except ValueError:
            with pytest.raises(ValueError):
                PS.plan_stages(n_layers, n_stages)
            continue
        got = PS.plan_stages(n_layers, n_stages)
        assert got == want, (n_layers, n_stages)
        assert got[0][0] == 0 and got[-1][1] == n_layers
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("n_stages", [0, 1, 2, 3, 4, 8])
def test_mpmd_1f1b_order_equal_jax(n_stages):
    for n_mb in range(0, 9):
        try:
            want = JS.mpmd_1f1b_order(n_stages, n_mb)
        except ValueError:
            with pytest.raises(ValueError):
                PS.mpmd_1f1b_order(n_stages, n_mb)
            continue
        got = PS.mpmd_1f1b_order(n_stages, n_mb)
        assert got == want, (n_stages, n_mb)
        # fill-drain trapezoid makespan
        assert max(t for t, _, _ in got) == n_mb + n_stages - 2


def test_paper_split_of_tinyllama():
    """The source paper's Worker1 / Worker2 split of TinyLlama's 22
    layers."""
    assert PS.plan_stages(get_model_config("tinyllama-1.1b").n_layers, 2) == [
        (0, 11), (11, 22)]


# -- in-process chains on the same weights ------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, the JAX params carried into the port)."""
    jcfg, cfg = jax_cfg(MODEL), get_model_config(MODEL)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, params_from_numpy(cfg, tree, "cpu")


def _chain_step(workers, rid, window, pos):
    """One window through a chain of workers: (the hidden states handed
    between stages, the last stage's greedy token)."""
    out = workers[0].step(rid, pos, tokens=np.asarray([window], np.int32))
    hs = []
    for w in workers[1:]:
        hs.append(np.asarray(out["h"]))
        out = w.step(rid, pos, h=out["h"])
    return hs, out["token"]


def _shadow(restore_dir, stage, rid) -> dict:
    path = Path(restore_dir) / f"stage{stage}" / SR._shadow_name(rid)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("n_stages", [2, 3])
def test_inprocess_chain_matches_jax_stage_workers(weights, tmp_path, n_stages):
    jcfg, cfg, params = weights
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jw = [JSR.StageWorker(jcfg, s, n_stages, seed=0, block_size=BLOCK,
                          restore_dir=str(jdir)) for s in range(n_stages)]
    pw = [SR.StageWorker(cfg, s, n_stages, block_size=BLOCK, restore_dir=str(pdir),
                         device="cpu", params=params) for s in range(n_stages)]
    for j, p in zip(jw, pw):
        assert (p.lo, p.hi) == (j.lo, j.hi)
        assert sorted(p.layers) == sorted(j.layers) and sorted(p.head) == sorted(j.head)
    rid = "req-chain"
    toks = ByteTokenizer().encode(PROMPT)
    window, pos = toks, 0
    for _ in range(N_NEW):
        jh, jt = _chain_step(jw, rid, window, pos)
        ph, pt = _chain_step(pw, rid, window, pos)
        for s, (a, b) in enumerate(zip(jh, ph)):
            assert b.dtype == np.float32 and b.shape == a.shape
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=0,
                                       err_msg=f"stage {s} h at pos {pos}")
        assert pt == jt, (pos, pt, jt)
        pos += len(window)
        window = [pt]
    # the shadows: the same block-aligned positions, K/V within 1e-5
    fed = len(toks) + N_NEW - 1
    for s in range(n_stages):
        js, ps = _shadow(jdir, s, rid), _shadow(pdir, s, rid)
        assert int(ps["pos"]) == int(js["pos"]) == (fed // BLOCK) * BLOCK
        assert str(ps["request_id"]) == rid
        for k in ("k", "v"):
            assert ps[k].shape == js[k].shape
            np.testing.assert_allclose(ps[k], js[k], atol=ATOL, rtol=0)
        assert pw[s].snapshot()["positions"] == jw[s].snapshot()["positions"] == {rid: fed}

    # a respawn at the exact position (after the drain's flush) takes the
    # next step bit-exactly as the uninterrupted chain
    for w in pw:
        w.flush()
    fresh = [SR.StageWorker(cfg, s, n_stages, block_size=BLOCK, restore_dir=str(pdir),
                            device="cpu", params=params) for s in range(n_stages)]
    assert all(w.snapshot()["restored"] == {rid: fed} for w in fresh)
    h_a, t_a = _chain_step(pw, rid, window, pos)
    h_b, t_b = _chain_step(fresh, rid, window, pos)
    assert t_a == t_b
    for a, b in zip(h_a, h_b):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pw, fresh):
        for k in ("k", "v"):
            assert torch.equal(a._requests[rid].cache[k], b._requests[rid].cache[k])


def test_warm_respawn_replays_the_gap(weights, tmp_path):
    """kill -9 between flushes: the respawned stage restores its last
    block boundary; replaying [boundary, fed) through the chain and
    stepping on gives the uninterrupted chain's token, and the JAX
    chain's."""
    jcfg, cfg, params = weights
    n = 2
    pw = [SR.StageWorker(cfg, s, n, block_size=BLOCK, restore_dir=str(tmp_path),
                         device="cpu", params=params) for s in range(n)]
    jw = [JSR.StageWorker(jcfg, s, n, seed=0, block_size=BLOCK) for s in range(n)]
    rid = "req-gap"
    toks = ByteTokenizer().encode(PROMPT)
    window, pos, stream = toks, 0, list(toks)
    for _ in range(KILL_AFTER + 1):
        _, t = _chain_step(pw, rid, window, pos)
        _, tj = _chain_step(jw, rid, window, pos)
        assert t == tj
        pos += len(window)
        window = [t]
        stream.append(t)
    restored = SR.StageWorker(cfg, 1, n, block_size=BLOCK, restore_dir=str(tmp_path),
                              device="cpu", params=params)
    p_r = restored.snapshot()["restored"][rid]
    assert p_r == (pos // BLOCK) * BLOCK and 0 < pos - p_r < BLOCK
    chain = [pw[0], restored]
    _chain_step(chain, rid, stream[p_r:pos], p_r)
    _, t_replayed = _chain_step(chain, rid, window, pos)
    _, t_jax = _chain_step(jw, rid, window, pos)
    assert t_replayed == t_jax


def test_bf16_shadow_restores_exact_bits(tmp_path):
    """bf16 K/V (numpy has no bf16) go to disk through a uint16 carrier
    and come back bit-exact."""
    cfg = get_model_config(MODEL).replace(dtype="bfloat16")
    w = SR.StageWorker(cfg, 0, 2, block_size=BLOCK, restore_dir=str(tmp_path),
                       device="cpu", seed=3)
    toks = ByteTokenizer().encode(PROMPT)
    out = w.step("r", 0, tokens=np.asarray([toks], np.int32))
    assert out["h"].dtype == np.float32
    # the wire's fp32 is a lossless widening of the stage's bf16
    assert torch.equal(torch.from_numpy(out["h"]).to(torch.bfloat16).float(),
                       torch.from_numpy(out["h"]))
    w.flush()
    assert _shadow(tmp_path, 0, "r")["k"].dtype == np.uint16
    again = SR.StageWorker(cfg, 0, 2, block_size=BLOCK, restore_dir=str(tmp_path),
                           device="cpu", seed=3)
    for k in ("k", "v"):
        a, b = w._requests["r"].cache[k], again._requests["r"].cache[k]
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # the same seed draws the same weights in every stage process
    assert all(torch.equal(w.layers[k], again.layers[k]) for k in w.layers)


def test_stage_slices_own_their_storage(weights):
    """A stage keeps copies of its layers, never views of the full stacked
    leaves (which would keep the whole model alive in every stage)."""
    _, cfg, params = weights
    w = SR.StageWorker(cfg, 1, 2, device="cpu", params=params)
    for name, leaf in w.layers.items():
        full = params["layers"][name]
        assert leaf.untyped_storage().data_ptr() != full.untyped_storage().data_ptr()
        assert leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size()
        assert torch.equal(leaf, full[w.lo:w.hi])
    assert "embed" not in w.head and {"final_norm", "lm_head"} <= set(w.head)


def test_slots_full_and_window_past_max_seq(weights):
    _, cfg, params = weights
    w = SR.StageWorker(cfg, 0, 2, device="cpu", params=params, max_requests=1, max_seq=16)
    w.step("a", 0, tokens=np.asarray([[1, 5, 6]], np.int32))
    with pytest.raises(SR.SlotsFull):
        w.step("b", 0, tokens=np.asarray([[1]], np.int32))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        w.step("a", 3, tokens=np.asarray([list(range(14))], np.int32))
    w.close("a")
    assert w.snapshot()["kv_slots"] == {"total": 1, "free": 1}


# -- both stage HTTP planes in process ----------------------------------------

class _Plane:
    """The stage servers of one package, in threads of this process."""

    def __init__(self, mod, workers):
        self.ports = [SR.free_port() for _ in workers]
        self.srvs = [mod.serve_stage(w, p) for w, p in zip(workers, self.ports)]
        for srv in self.srvs:
            threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                             daemon=True).start()

    def addr(self, s):
        return f"127.0.0.1:{self.ports[s]}"

    def close(self):
        for srv in self.srvs:
            srv.shutdown()
            srv.server_close()


def _raw(addr, path, body=None, headers=None):
    req = urllib.request.Request(f"http://{addr}{path}", data=body, headers=headers or {},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture(scope="module")
def planes(weights):
    jcfg, cfg, params = weights
    jax_plane = _Plane(JSR, [JSR.StageWorker(jcfg, s, 2, seed=0, max_requests=2)
                             for s in range(2)])
    port_plane = _Plane(SR, [SR.StageWorker(cfg, s, 2, device="cpu", params=params,
                                            max_requests=2) for s in range(2)])
    yield jax_plane, port_plane
    jax_plane.close()
    port_plane.close()


def _drive(transport, plane, rid, n_new):
    """Greedy ids of PROMPT through a 2-stage plane by one transport."""
    toks = ByteTokenizer().encode(PROMPT)
    window, pos, ids = toks, 0, []
    for _ in range(n_new):
        out = transport.step(plane.addr(0), 0, rid, pos,
                             tokens=np.asarray([window], np.int32))
        out = transport.step(plane.addr(1), 1, rid, pos, h=out["h"])
        ids.append(out["token"])
        pos += len(window)
        window = [out["token"]]
    for s in range(2):
        transport.post_json(plane.addr(s), "/stage/close", {"request_id": rid})
    return ids


@pytest.mark.parametrize("wire_quant", [None, "int8"])
def test_transports_drive_the_other_package_stages(planes, wire_quant):
    """The JAX transport drives the port's stages and the port's transport
    the JAX stages: the same greedy ids as each package alone, and the
    same bytes on dli_pp_wire_bytes_total{path="stage"}."""
    jax_plane, port_plane = planes
    runs = {}
    for t_name, transport_cls in (("jax", JSR.HttpStageTransport),
                                  ("port", SR.HttpStageTransport)):
        for p_name, plane in (("jax", jax_plane), ("port", port_plane)):
            tr = transport_cls(wire_quant=wire_quant)
            ids = _drive(tr, plane, f"x-{t_name}-{p_name}", 5)
            nbytes = tr.registry.get("dli_pp_wire_bytes_total").labels(path="stage").value
            runs[(t_name, p_name)] = (ids, nbytes)
    ids = {k: v[0] for k, v in runs.items()}
    nbytes = {k: v[1] for k, v in runs.items()}
    assert len(set(map(tuple, ids.values()))) == 1, ids
    assert len(set(nbytes.values())) == 1, nbytes


def test_stage_routes_status_and_headers_equal_jax(planes):
    """Every route of the stage plane answers with the JAX plane's status,
    content type and JSON keys; the step body is an npz of the same keys,
    shapes and dtypes (h within 1e-5), raw and int8."""
    jax_plane, port_plane = planes
    toks = np.asarray([ByteTokenizer().encode(PROMPT)], np.int32)
    calls = [
        ("GET", "/stage/heartbeat", None, {}),
        ("GET", "/ready", None, {}),
        ("GET", "/metrics", None, {}),
        ("GET", "/debug/traces", None, {}),
        ("GET", "/nope", None, {}),
        ("POST", "/nope", b"{}", {}),
        ("POST", "/stage/step", SR._npz_bytes({"tokens": toks}),
         {"X-Stage-Request-Id": "hdr", "X-Stage-Pos": "0",
          "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"}),
        ("POST", "/stage/step", SR._npz_bytes({"tokens": toks[:, :1]}),
         {"X-Stage-Request-Id": "hdr8", "X-Stage-Pos": "0", "X-Stage-Quant": "int8"}),
        ("GET", "/health", None, {}),
        ("POST", "/stage/step", SR._npz_bytes({"tokens": toks[:, :1]}),
         {"X-Stage-Request-Id": "third", "X-Stage-Pos": "0"}),  # 2 slots: 429
        ("POST", "/stage/flush", b"{}", {}),
        ("POST", "/stage/close", json.dumps({"request_id": "hdr"}).encode(), {}),
        ("POST", "/stage/close", json.dumps({"request_id": "hdr8"}).encode(), {}),
    ]
    for method, path, body, headers in calls:
        a = _raw(jax_plane.addr(0), path, body, headers)
        b = _raw(port_plane.addr(0), path, body, headers)
        assert b[0] == a[0], (path, b[0], a[0])
        assert b[1].get("Content-Type") == a[1].get("Content-Type"), path
        assert b[1].get("Retry-After") == a[1].get("Retry-After"), path
        if a[1].get("Content-Type") == "application/json" and path != "/debug/traces":
            ja, jb = json.loads(a[2]), json.loads(b[2])
            assert set(ja) <= set(jb), (path, ja, jb)
            if path == "/health":
                for key in ("stage", "n_stages", "layers", "active", "kv_slots",
                            "positions", "draining"):
                    assert jb[key] == ja[key], key
        elif path == "/stage/step" and a[0] == 200:
            za, zb = SR._npz_load(a[2]), SR._npz_load(b[2])
            assert sorted(za) == sorted(zb)
            for k in za:
                assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
            if "h" in za:
                np.testing.assert_allclose(zb["h"], za["h"], atol=ATOL, rtol=0)
            else:
                assert np.abs(zb["q"].astype(int) - za["q"].astype(int)).max() <= 1
                np.testing.assert_allclose(zb["s"], za["s"], rtol=1e-5)
    # the traceparent reached the port stage's span store
    traces = json.loads(_raw(port_plane.addr(0), "/debug/traces")[2])
    assert [sp["name"] for sp in traces["a" * 32]] == ["stage.step"]
    # draining: /ready and /stage/step answer 503 with Retry-After
    for plane in (jax_plane, port_plane):
        assert _raw(plane.addr(1), "/admin/drain", b"{}")[0] == 200
        code, hdrs, _ = _raw(plane.addr(1), "/stage/step", SR._npz_bytes({"h": np.zeros(
            (1, 1, 64), np.float32)}), {"X-Stage-Request-Id": "d", "X-Stage-Pos": "0"})
        assert code == 503 and hdrs.get("Retry-After") == str(SR.RETRY_AFTER_S)
        assert _raw(plane.addr(1), "/ready")[0] == 503


# -- DeviceStageTransport and the card-less host --------------------------------

def test_device_transport_refuses_on_one_process():
    with pytest.raises(RuntimeError, match="HttpStageTransport"):
        SR.DeviceStageTransport()


_GLOO = """
import sys, torch.distributed as dist
from distributed_llm_inference_tpu_torch.serving.stage_runtime import DeviceStageTransport
dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2, rank=int(sys.argv[2]))
try:
    DeviceStageTransport()
except NotImplementedError as e:
    print("NotImplementedError", e)
dist.barrier()
dist.destroy_process_group()
"""


def test_device_transport_not_implemented_on_a_group():
    """On a 2-process gloo group the transport raises NotImplementedError:
    no device-to-device stage transfer exists (nor in the JAX package)."""
    url = f"tcp://127.0.0.1:{SR.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, url, str(r)], cwd=ROOT,
                              env=_stage_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "NotImplementedError device-to-device" in out, out


def test_stage_worker_defaults_to_the_card():
    """A StageWorker built without `device` runs on the card: on a host
    with none it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_model_config(MODEL, dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        SR.StageWorker(cfg, 0, 2)


@pytest.mark.parametrize("mode", ["stage", "frontend"])
def test_cuda_device_without_a_card_exits_nonzero(mode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.stage_runtime",
            "--stages", "2", "--model", MODEL, "--port", str(SR.free_port())]
    if mode == "frontend":
        argv.append("--frontend")
    r = subprocess.run(argv, cwd=ROOT, env=_stage_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


# -- the subprocess fleet -------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The port's fault-free single-process greedy transcripts, by
    (prompt, n), on the seed every stage draws its weights from."""
    cfg = get_model_config(MODEL)
    tok = ByteTokenizer()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    memo = {}

    @torch.no_grad()
    def run(prompt: str, max_new: int):
        key = (prompt, max_new)
        if key in memo:
            return memo[key]
        ids = tok.encode(prompt)
        cache = M.init_kv_cache(cfg, 1, cfg.max_seq_len, cfg.n_layers)
        logits, cache = M.forward(cfg, params, torch.tensor([ids]), cache, 0)
        t = int(torch.argmax(logits[0, -1]))
        out, pos = [t], len(ids)
        for _ in range(max_new - 1):
            if t == tok.eos_token_id:
                break
            logits, cache = M.forward(cfg, params, torch.tensor([[t]]), cache, pos)
            t = int(torch.argmax(logits[0, -1]))
            out.append(t)
            pos += 1
        if out and out[-1] == tok.eos_token_id:
            out = out[:-1]
        memo[key] = out
        return out

    return run


class Fleet:
    def __init__(self, n_stages: int, restore_dir: str, *,
                 wire_quant=None, env_extra=None, **pipe_kw):
        self.restore_dir = restore_dir
        ports = [SR.free_port() for _ in range(n_stages)]
        self.sup = SR.StageSupervisor(
            MODEL, n_stages, ports, seed=0, block_size=BLOCK,
            restore_dir=restore_dir, wire_quant=wire_quant,
            restart_budget=100, env=_stage_env(env_extra), device="cpu",
        )
        self.pipe = SR.MPMDPipeline(
            self.sup,
            transport=SR.HttpStageTransport(wire_quant=wire_quant),
            **pipe_kw,
        )

    def start(self):
        self.pipe.start_fleet(ready_timeout_s=120)
        return self

    def stage_slots(self, s: int) -> dict:
        return self.pipe.transport.get_json(self.sup.addr(s), "/health")["kv_slots"]

    def shutdown(self):
        self.pipe.shutdown()


@pytest.fixture(scope="module")
def fleet3(tmp_path_factory):
    f = Fleet(3, str(tmp_path_factory.mktemp("restore3"))).start()
    yield f
    f.shutdown()


def _cells():
    out = []
    for victim in (0, 1, 2):
        for boundary in ("prefill", "decode"):
            for restore in ("warm", "cold"):
                fast = boundary == "decode" and restore == "warm"
                out.append(pytest.param(
                    victim, boundary, restore,
                    marks=() if fast else (pytest.mark.slow,),
                    id=f"victim{victim}-{boundary}-{restore}",
                ))
    return out


@pytest.mark.parametrize("victim,boundary,restore", _cells())
def test_chaos_matrix_bit_identical(fleet3, reference, victim, boundary, restore):
    """SIGKILL stage `victim` at `boundary` under `restore`; greedy output
    must equal the fault-free single-process run, the pool must drain back
    to free == total, and a warm restore must recompute fewer than
    block_size tokens."""
    pipe, sup = fleet3.pipe, fleet3.sup
    ref = reference(PROMPT, N_NEW)
    assert len(ref) == N_NEW  # the drill needs a full-length transcript

    rid = pipe.start(PROMPT)
    got = 1  # start() accepted the first token
    if boundary == "decode":
        for _ in range(KILL_AFTER):
            assert pipe.step_once(rid) is not None
            got += 1
    sup.proc(victim).kill()  # SIGKILL: no drain, no flush, no goodbye
    sup.proc(victim).wait(timeout=10)
    if restore == "cold":
        shutil.rmtree(os.path.join(fleet3.restore_dir, f"stage{victim}"),
                      ignore_errors=True)
    while got < N_NEW:
        if pipe.step_once(rid) is None:
            break
        got += 1
    out = pipe.finish(rid)
    assert out["tokens"] == ref, (victim, boundary, restore)

    salvage = pipe.last_salvage()
    assert salvage["stage"] == victim
    recomputed = salvage["tokens_recomputed"][rid]
    fed_at_kill = len(ByteTokenizer().encode(PROMPT)) + (
        KILL_AFTER if boundary == "decode" else 0
    )
    if restore == "warm":
        assert 0 < recomputed < BLOCK, recomputed
    else:
        assert recomputed == fed_at_kill, recomputed
    for s in range(3):
        slots = fleet3.stage_slots(s)
        assert slots["free"] == slots["total"], (s, slots)


def test_transport_fault_points_retry_transparently(fleet3, reference):
    """Armed stage_send drops are absorbed by the controller's retry loop:
    output stays equal and the rules actually fired."""
    plan = faults.arm("stage_send:transient:on=2,every=3,times=3")
    try:
        out = fleet3.pipe.generate(PROMPT, N_NEW)
        assert out["tokens"] == reference(PROMPT, N_NEW)
        assert plan.fired("stage_send") == 3
    finally:
        faults.disarm()


def test_trace_propagation_reaches_every_stage(fleet3):
    """traceparent flows controller -> every stage: the same trace id
    shows up in each stage's span store with stage.step spans."""
    fleet3.pipe.generate(PROMPT, 4)
    ids_per_stage = []
    for s in range(3):
        traces = fleet3.pipe.transport.get_json(fleet3.sup.addr(s), "/debug/traces")
        spans = [sp for tid in traces for sp in traces[tid]]
        assert any(sp["name"] == "stage.step" for sp in spans)
        ids_per_stage.append(set(traces))
    assert set.intersection(*ids_per_stage), ids_per_stage


@pytest.mark.slow
def test_heartbeat_timeout_unready_then_readmitted(tmp_path):
    """A wedged stage (its heartbeat handler stalls past the timeout,
    armed via DLI_FAULTS in the STAGE process) flips the pipeline unready;
    when the wedge clears, heartbeats resume and it is readmitted."""
    fleet = Fleet(
        2, str(tmp_path / "restore"),
        env_extra={"DLI_FAULTS": "stage_recv:transient:match=heartbeat:stage1,"
                                 "on=1,every=1,times=4,wedge=1.5"},
        hb_interval_s=0.15, hb_timeout_s=0.5,
    ).start()
    seen = {}

    def unready(pipe=fleet.pipe):
        if pipe.ready():
            return False
        seen["liveness"] = pipe.liveness()
        return True

    try:
        assert wait_until(unready, timeout_s=15)
        assert seen["liveness"].get(1) in ("wedged", "dead")
        kinds = [e["kind"] for e in fleet.pipe.flight.events()]
        assert "heartbeat_lost" in kinds
        # the rule exhausts after 4 firings: heartbeats succeed again
        assert wait_until(fleet.pipe.ready, timeout_s=30)
    finally:
        fleet.shutdown()


@pytest.mark.slow
def test_rolling_restart_zero_drops_under_live_load(tmp_path, reference):
    """Cycle every stage through drain -> respawn -> /ready while two
    client threads generate continuously: zero failed requests, every
    transcript equal to its fault-free reference."""
    fleet = Fleet(2, str(tmp_path / "restore")).start()
    prompts = ["rolling load A", "rolling load B"]
    results = {p: [] for p in prompts}
    errors = []
    stop = threading.Event()

    def client(prompt):
        while not stop.is_set():
            try:
                results[prompt].append(fleet.pipe.generate(prompt, 8)["tokens"])
            except Exception as e:  # any drop is a failure
                errors.append((prompt, repr(e)))
                return

    threads = [threading.Thread(target=client, args=(p,), daemon=True) for p in prompts]
    try:
        for t in threads:
            t.start()
        assert wait_until(lambda: all(results[p] for p in prompts), timeout_s=60)
        report = fleet.pipe.rolling_restart()
        assert [r["stage"] for r in report["stages"]] == [0, 1]
        assert wait_until(lambda: all(len(results[p]) >= 3 for p in prompts),
                          timeout_s=60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        fleet.shutdown()
    assert not errors, errors
    for p in prompts:
        assert results[p], p
        for transcript in results[p]:
            assert transcript == reference(p, 8), p
    kinds = [e["kind"] for e in fleet.pipe.flight.events()]
    assert kinds.count("rolling_stage_done") == 2


@pytest.mark.slow
def test_int8_wire_quant_applies_to_cross_process_hops(tmp_path):
    """--wire-quant int8 on the stage transport: bodies ship int8 +
    scales, the pipeline still generates, and the bytes land on
    dli_pp_wire_bytes_total{path="stage"} under the raw run's."""
    fleet = Fleet(2, str(tmp_path / "restore"), wire_quant="int8").start()
    try:
        out = fleet.pipe.generate(PROMPT, 6)
        assert len(out["tokens"]) == 6
        fam = fleet.pipe.transport.registry.get("dli_pp_wire_bytes_total")
        quant_bytes = fam.labels(path="stage").value
        assert quant_bytes > 0
    finally:
        fleet.shutdown()
    fleet = Fleet(2, str(tmp_path / "restore_fp")).start()
    try:
        fleet.pipe.generate(PROMPT, 6)
        fam = fleet.pipe.transport.registry.get("dli_pp_wire_bytes_total")
        raw_bytes = fam.labels(path="stage").value
        assert raw_bytes > quant_bytes
    finally:
        fleet.shutdown()


@pytest.mark.slow
def test_frontend_http_surface_behind_the_router(tmp_path, reference):
    """The --frontend CLI spawns its stage fleet (`--device cpu` passed on
    to the stages), serves /generate behind the port's router, /ready,
    /health, /debug/flight and /admin/rolling-restart, and reaps the
    stages on SIGTERM."""
    port = SR.free_port()
    stage_ports = [SR.free_port() for _ in range(2)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.stage_runtime",
         "--frontend", "--stages", "2", "--model", MODEL, "--port", str(port),
         "--stage-ports", ",".join(map(str, stage_ports)), "--block-size", str(BLOCK),
         "--restore-dir", str(tmp_path / "restore"), "--device", "cpu"],
        cwd=ROOT, env=_stage_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    base = f"http://127.0.0.1:{port}"

    def ready(url=base):
        try:
            with urllib.request.urlopen(f"{url}/ready", timeout=2) as r:
                return r.status == 200
        except Exception:
            return False

    router = PR.Router([PR.Replica("mpmd", base)], probe_interval_s=0.25)
    server = PR.RouterServer(router, host="127.0.0.1", port=0)
    try:
        assert wait_until(ready, timeout_s=120, interval_s=0.25)
        server.start()
        rbase = f"http://127.0.0.1:{server.port}"
        assert wait_until(lambda: ready(rbase), timeout_s=30)
        body = json.dumps({"prompt": PROMPT, "max_new_tokens": 8}).encode()
        req = urllib.request.Request(f"{rbase}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["tokens"] == reference(PROMPT, 8)
        assert out["replica"] == "mpmd"
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ready"] and health["n_stages"] == 2
        assert [s["device"] for s in health["stages"]] == ["cpu", "cpu"]
        rr = urllib.request.Request(f"{base}/admin/rolling-restart", data=b"{}",
                                    headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(rr, timeout=120) as r:
            report = json.loads(r.read())
        assert [x["stage"] for x in report["stages"]] == [0, 1]
        with urllib.request.urlopen(f"{base}/debug/flight", timeout=10) as r:
            flight = json.loads(r.read())
        assert "rolling_restart_done" in [e["kind"] for e in flight["events"]]
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert "dli_pp_wire_bytes_total" in r.read().decode()
    finally:
        server.shutdown()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    # the frontend reaped its stages
    assert wait_until(lambda: not any(ready(f"http://127.0.0.1:{p}") for p in stage_ports),
                      timeout_s=15)
