"""Multi-process MPMD pipeline: one stage of layers per host process (the
JAX package's serving/stage_runtime.py in PyTorch).

This is the deployment shape the source paper actually ran — an
orchestrator driving Worker1/Worker2 over HTTP, each worker holding a
contiguous slice of the model — grown into a supervised runtime. Every
stage is its OWN PROCESS with its own params slice and KV cache, and the
1F1B wavefront (parallel/schedule.mpmd_1f1b_order) spans processes over
a pluggable stage transport:

  * `HttpStageTransport` — the loopback and cross-machine plane: npz
    activation windows over `POST /stage/step`, with the shared retry
    discipline (utils/retry.py), per-call deadlines, W3C `traceparent`
    propagation into each stage's span store, and deterministic fault
    points (`stage_send`/`stage_recv` in utils/faults.py) on both ends of
    every hop. With `wire_quant="int8"` the hidden-state bodies ship int8
    rows + fp32 per-row scales (ops/wire_quant.quantize_rows), and every
    crossing lands on `dli_pp_wire_bytes_total{path="stage"}` through the
    accounted links `stage-activation-dcn` / `stage-result-dcn`.
  * `DeviceStageTransport` — device-to-device transfers between stage
    processes. Not built, as in the JAX package: off a multi-process
    torch.distributed group it raises with the HTTP transport as the
    guidance, on one it raises NotImplementedError.

Fault containment is per STAGE:

  * each stage serves `GET /stage/heartbeat` (a monotonic sequence
    number, never behind the worker lock); the controller's monitor
    thread polls it and classifies a peer as live / wedged (HTTP
    unresponsive past the timeout while the process is alive) / dead
    (process exited or connection refused). Liveness feeds the
    frontend's `/ready` + `/health` (so the router's prober ejects and
    readmits the whole pipeline exactly like a replica) and the flight
    recorder.
  * a stage crash (kill -9 mid-decode) triggers fleet-wide salvage:
    survivors flush their shadow, the supervisor respawns the dead stage
    (restart budget bounds crash loops), the new process warm-restores
    per-request KV from `--restore-dir` (block-aligned boundary captures,
    stored bit-exact: bf16 through a uint16 carrier), and the controller
    replays each in-flight request's token window [restored_pos, fed)
    through the WHOLE chain — survivors overwrite their KV, the restored
    stage fills its gap — so a warm restore recomputes < block_size
    tokens per request.
  * `POST /admin/rolling-restart` (frontend) cycles one stage at a time
    through drain -> respawn -> `/ready` with dispatch paused only during
    each swap window: zero dropped requests under live load.

Stages run the plain PyTorch path (`attn_impl="plain"`, as the JAX stage
worker keeps the XLA path): no stage loads a kernel library. `--device`
(default cuda) names the torch device; a CUDA device that is not there
raises. On a CUDA device a stage runs the model in bfloat16 (CARD_DTYPE),
on the CPU in the registry's dtype, which is the JAX stage runtime's.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import api as M
from ..models.registry import get_model_config
from ..utils import faults
from ..utils.logging import get_logger
from ..utils.metrics import MetricsRegistry
from ..utils.retry import RETRY_STATUSES, retry_delay
from ..utils.tokenizer import ByteTokenizer
from ..utils.tracing import (
    FlightRecorder, SpanContext, new_request_id, parse_traceparent,
)
from .trace_store import TraceStore

log = get_logger("stage_runtime")

RETRY_AFTER_S = 2
DEFAULT_BLOCK = 16
DEFAULT_MAX_REQUESTS = 8
DEFAULT_HB_INTERVAL_S = 0.25
DEFAULT_HB_TIMEOUT_S = 2.0
DEFAULT_STEP_DEADLINE_S = 30.0
DEFAULT_SALVAGE_TIMEOUT_S = 60.0
# the model dtype of a stage on a CUDA device (the stage CLI has no
# --dtype: the JAX one has none either)
CARD_DTYPE = "bfloat16"


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def _shadow_name(request_id: str) -> str:
    return hashlib.sha1(request_id.encode()).hexdigest()[:16] + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A KV plane on the host, bit-exact: bf16 (which numpy lacks) through
    a uint16 carrier, as models/checkpoint.py stores it."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- stage worker: one process's slice of the model ---------------------------

class _ReqState:
    """One request's per-stage state. Mutated only by the stage worker
    under its lock."""

    __slots__ = ("cache", "pos", "flushed", "restored_from")

    def __init__(self, cache, pos: int = 0, flushed: int = 0,
                 restored_from: int = -1):
        self.cache = cache
        self.pos = pos
        self.flushed = flushed
        self.restored_from = restored_from


class SlotsFull(RuntimeError):
    """The stage's request-slot pool is exhausted (429 to the wire)."""


class StageWorker:
    """The model half of one stage process: a contiguous [lo, hi) layer
    slice, per-request KV caches, and block-aligned shadow capture.

    Every stage inits the FULL parameter tree from the shared seed (a
    torch.Generator on the stage's device) and keeps only its slice (plus
    embed on stage 0 and the norm/head on the last stage) — so any
    respawn of any stage reconstructs bit-identical weights with no
    checkpoint plumbing, which is what makes the salvage replay
    deterministic. `params` (a full tree, e.g. the JAX package's carried
    over by models/bridge.py) replaces the init."""

    def __init__(self, cfg: ModelConfig, stage: int, n_stages: int, *,
                 seed: int = 0, max_seq: Optional[int] = None,
                 max_requests: int = DEFAULT_MAX_REQUESTS,
                 block_size: int = DEFAULT_BLOCK,
                 restore_dir: Optional[str] = None,
                 device="cpu", params: Optional[dict] = None):
        from ..parallel.schedule import plan_stages

        self.cfg = cfg
        self.device = torch.device(device)
        self.stage = int(stage)
        self.n_stages = int(n_stages)
        ranges = plan_stages(cfg.n_layers, n_stages)
        self.lo, self.hi = ranges[self.stage]
        self.is_first = self.stage == 0
        self.is_last = self.stage == n_stages - 1
        self.max_seq = int(max_seq or cfg.max_seq_len)
        self.max_requests = int(max_requests)
        self.block_size = int(block_size)
        self.restore_dir = restore_dir
        self._shadow_base = (
            os.path.join(restore_dir, f"stage{self.stage}")
            if restore_dir else None
        )

        full = params if params is not None else M.init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed)
        )
        head_names = []
        if self.is_first or (self.is_last and cfg.tie_embeddings):
            head_names.append("embed")
        if self.is_last:
            head_names.append("final_norm")
            if not cfg.tie_embeddings:
                head_names.append("lm_head")
        # host copies of what this stage keeps (a slice of a stacked leaf
        # is a view, which would keep the whole leaf alive), the full tree
        # dropped, then the copies uploaded: on the card the init's cached
        # segments are all free by then and are released to the device, so the
        # stage holds its slice and no more
        layers = {name: w[self.lo:self.hi].to("cpu", copy=True)
                  for name, w in full["layers"].items()}
        head = {name: full[name].to("cpu", copy=True) for name in head_names}
        del full
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.layers = {name: w.to(self.device) for name, w in layers.items()}
        self.head = {name: w.to(self.device) for name, w in head.items()}

        self._lock = threading.RLock()
        self._requests: dict = {}  # guarded-by: _lock
        self._restored: dict = {}  # guarded-by: _lock
        if self._shadow_base:
            os.makedirs(self._shadow_base, exist_ok=True)
            self._restore_all()

    def _new_cache(self):
        return M.init_kv_cache(self.cfg, 1, self.max_seq,
                               n_layers=self.hi - self.lo, device=self.device)

    # -- restore / shadow ----------------------------------------------------

    @torch.no_grad()
    def _restore_all(self):
        """Reload every per-request shadow found in this stage's restore
        dir: the warm-recovery half of a respawn. Called from __init__
        only (no concurrent readers yet)."""
        for fname in sorted(os.listdir(self._shadow_base)):
            if not fname.endswith(".npz"):
                continue
            path = os.path.join(self._shadow_base, fname)
            try:
                with open(path, "rb") as f:
                    z = _npz_load(f.read())
                rid = str(z["request_id"])
                pos = int(z["pos"])
            except Exception as e:  # corrupt shadow: cold-start that rid
                log.warning("shadow_unreadable", stage=self.stage,
                            file=fname, err=str(e))
                continue
            cache = self._new_cache()
            if pos > 0:
                dt = self.cfg.torch_dtype
                cache["k"][:, :, :, :pos, :] = _from_numpy(z["k"], dt, self.device)
                cache["v"][:, :, :, :pos, :] = _from_numpy(z["v"], dt, self.device)
            with self._lock:
                self._requests[rid] = _ReqState(
                    cache, pos=pos, flushed=pos, restored_from=pos
                )
                self._restored[rid] = pos

    def _shadow_write(self, request_id: str, st: _ReqState, upto: int):
        """Persist [0, upto) of this request's K/V planes atomically.
        Caller holds the lock (writes are ordered per request)."""
        if not self._shadow_base or upto <= 0:
            return
        k = _to_numpy(st.cache["k"][:, :, :, :upto, :])
        v = _to_numpy(st.cache["v"][:, :, :, :upto, :])
        path = os.path.join(self._shadow_base, _shadow_name(request_id))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_npz_bytes({
                "request_id": np.str_(request_id),
                "pos": np.int64(upto), "k": k, "v": v,
            }))
        os.replace(tmp, path)
        st.flushed = upto

    def flush(self):
        """Persist every active request at its EXACT position (drain /
        salvage flush — graceful, so the replay window is empty)."""
        with self._lock:
            items = list(self._requests.items())
            for rid, st in items:
                if st.pos > st.flushed:
                    self._shadow_write(rid, st, st.pos)

    # -- compute -------------------------------------------------------------

    @torch.no_grad()
    def step(self, request_id: str, pos: int, tokens=None, h=None) -> dict:
        """Run this stage's layer slice over one activation window.

        `pos` is CALLER-OWNED: the controller names the absolute write
        position of the window's first token, which is what makes
        salvage replay and post-restore overwrite idempotent (same
        (request_id, pos, window) in -> same cache out).
        Returns {"h": np.ndarray} (fp32: the wire's dtype, a lossless
        widening of bf16) for a non-last stage, {"token": int} (greedy
        argmax at the window's final position) for the last."""
        with self._lock:
            st = self._requests.get(request_id)
            if st is None:
                if len(self._requests) >= self.max_requests:
                    raise SlotsFull(
                        f"stage {self.stage}: all {self.max_requests} "
                        f"request slots busy"
                    )
                st = _ReqState(self._new_cache())
                self._requests[request_id] = st
            if self.is_first:
                ids = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                      device=self.device)
                x = M.embed(self.cfg, self.head, ids, pos)
            else:
                x = torch.as_tensor(np.asarray(h)).to(
                    device=self.device, dtype=self.cfg.torch_dtype)
            T = int(x.shape[1])
            if pos + T > self.max_seq:
                raise ValueError(
                    f"stage {self.stage}: window [{pos}, {pos + T}) "
                    f"exceeds max_seq {self.max_seq}"
                )
            out, st.cache = M.forward_layers(
                self.cfg, self.layers, x, st.cache, pos
            )
            st.pos = pos + T
            boundary = (st.pos // self.block_size) * self.block_size
            if boundary > st.flushed:
                self._shadow_write(request_id, st, boundary)
            if self.is_last:
                logits = M.unembed(self.cfg, self.head, out[:, -1:, :])
                return {"token": int(torch.argmax(logits[0, -1]))}
            return {"h": out.float().cpu().numpy()}

    def close(self, request_id: str):
        """Free the request's slot and delete its shadow (a completed
        request must not resurrect on the next respawn)."""
        with self._lock:
            self._requests.pop(request_id, None)
            self._restored.pop(request_id, None)
        if self._shadow_base:
            try:
                os.remove(os.path.join(
                    self._shadow_base, _shadow_name(request_id)
                ))
            except FileNotFoundError:
                pass

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "stage": self.stage,
                "n_stages": self.n_stages,
                "layers": [self.lo, self.hi],
                "active": len(self._requests),
                "kv_slots": {
                    "total": self.max_requests,
                    "free": self.max_requests - len(self._requests),
                },
                "positions": {r: s.pos for r, s in self._requests.items()},
                "restored": dict(self._restored),
                "device": str(self.device),
            }
        if self.device.type == "cuda":
            snap["device_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(self.device),
                "reserved_bytes": torch.cuda.memory_reserved(self.device),
            }
        return snap


# -- stage HTTP server --------------------------------------------------------

def serve_stage(worker: StageWorker, port: int, *,
                wire_quant: Optional[str] = None) -> ThreadingHTTPServer:
    """Build (not start) the stage process's HTTP plane. A reply is int8
    when its request came with `X-Stage-Quant: int8`, whatever
    `wire_quant` says (kept for the JAX signature)."""
    registry = MetricsRegistry()
    http_requests = registry.counter(
        "dli_http_requests_total", "stage-plane responses by route/status",
        ("route", "status"),
    )
    traces = TraceStore(service=f"stage{worker.stage}")
    state = {
        "draining": False,  # guarded-by: _state_lock
        "hb_seq": 0,        # guarded-by: _state_lock
    }
    state_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # stage stderr stays machine-readable
            pass

        def _count(self, code: int):
            http_requests.labels(
                route=self.path.split("?")[0], status=str(code)
            ).inc()

        def _send(self, code: int, payload, content_type="application/json",
                  headers=None):
            body = (
                payload if isinstance(payload, bytes)
                else json.dumps(payload).encode()
            )
            self._count(code)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(n) if n else b""

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/stage/heartbeat":
                # the wedge drill's injection point: a stage_recv rule
                # matching "heartbeat:" stalls/fails liveness itself
                try:
                    faults.check(
                        "stage_recv", tag=f"heartbeat:stage{worker.stage}"
                    )
                except faults.FaultError as e:
                    self._send(503, {"error": str(e)},
                               headers={"Retry-After": str(RETRY_AFTER_S)})
                    return
                with state_lock:
                    state["hb_seq"] += 1
                    seq = state["hb_seq"]
                self._send(200, {"stage": worker.stage, "seq": seq})
            elif path == "/ready":
                with state_lock:
                    draining = state["draining"]
                if draining:
                    self._send(503, {"ready": False, "draining": True},
                               headers={"Retry-After": str(RETRY_AFTER_S)})
                else:
                    self._send(200, {"ready": True, "stage": worker.stage})
            elif path == "/health":
                snap = worker.snapshot()
                with state_lock:
                    snap["draining"] = state["draining"]
                    snap["heartbeat_seq"] = state["hb_seq"]
                self._send(200, snap)
            elif path == "/metrics":
                self._send(200, registry.render().encode(),
                           content_type="text/plain; version=0.0.4")
            elif path == "/debug/traces":
                self._send(200, {
                    tid: traces.get(tid) for tid in traces.trace_ids()
                })
            else:
                self._send(404, {"error": f"unknown route {path}"})

        def do_POST(self):
            path = self.path.split("?")[0]
            if path == "/stage/step":
                self._step()
            elif path == "/stage/flush":
                worker.flush()
                self._send(200, {"flushed": True})
            elif path == "/stage/close":
                req = json.loads(self._body() or b"{}")
                worker.close(str(req.get("request_id", "")))
                self._send(200, {"closed": True})
            elif path == "/admin/drain":
                with state_lock:
                    state["draining"] = True
                worker.flush()
                self._send(200, {"draining": True})
            else:
                self._send(404, {"error": f"unknown route {path}"})

        def _step(self):
            rid = self.headers.get("X-Stage-Request-Id", "")
            pos = int(self.headers.get("X-Stage-Pos", "0"))
            quant = self.headers.get("X-Stage-Quant", "")
            body = self._body()
            with state_lock:
                draining = state["draining"]
            if draining:
                self._send(503, {"error_type": "draining"},
                           headers={"Retry-After": str(RETRY_AFTER_S)})
                return
            # receive-side fault point BEFORE any compute or state touch
            try:
                faults.check(
                    "stage_recv", tag=f"{rid}:step:stage{worker.stage}"
                )
            except faults.TransientFault as e:
                self._send(503, {"error": str(e)},
                           headers={"Retry-After": str(RETRY_AFTER_S)})
                return
            except faults.FatalFault as e:
                self._send(500, {"error": str(e)})
                return
            ctx = parse_traceparent(self.headers.get("traceparent"))
            ctx = ctx or SpanContext.new_root()
            try:
                with traces.span("stage.step", ctx,
                                 {"stage": worker.stage, "pos": pos}):
                    arrays = _npz_load(body)
                    if "tokens" in arrays:
                        out = worker.step(rid, pos, tokens=arrays["tokens"])
                    else:
                        if quant == "int8":
                            h = (arrays["q"].astype(np.float32)
                                 * arrays["s"][..., None])
                        else:
                            h = arrays["h"]
                        out = worker.step(rid, pos, h=h)
            except SlotsFull as e:
                self._send(429, {"error_type": "overloaded",
                                 "error": str(e)},
                           headers={"Retry-After": str(RETRY_AFTER_S)})
                return
            except Exception as e:  # surface, don't kill the handler thread
                self._send(500, {"error_type": "internal",
                                 "error": f"{type(e).__name__}: {e}"})
                return
            if "token" in out:
                self._send(200, {"token": out["token"]})
                return
            if quant == "int8":
                from ..ops.wire_quant import quantize_rows

                q, s = quantize_rows(torch.from_numpy(out["h"]))
                payload = _npz_bytes({"q": q.numpy(), "s": s.numpy()})
            else:
                payload = _npz_bytes({"h": out["h"]})
            self._send(200, payload,
                       content_type="application/octet-stream")

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.daemon_threads = True
    return srv


def _watch_parent(srv: ThreadingHTTPServer, ppid: int):
    """A stage must not outlive its supervisor. A SIGKILLed controller
    never gets to reap its fleet, so every stage watches its parent pid:
    reparenting (getppid() changes) means the supervisor is gone, and the
    stage shuts its plane down instead of serving as an orphan forever."""
    while True:
        time.sleep(2.0)
        if os.getppid() != ppid:
            log.info("stage_orphaned", was_ppid=ppid)
            srv.shutdown()
            return


def stage_main(args) -> int:
    """CLI entry for one stage process (see main() for the flags)."""
    from ..runtime import resolve_device

    faults.arm_from_env()
    device = resolve_device(args.device)
    cfg = get_model_config(args.model)
    if device.type == "cuda":
        cfg = cfg.replace(dtype=CARD_DTYPE)
    worker = StageWorker(
        cfg, args.stage, args.stages, seed=args.seed,
        max_seq=args.max_seq or None, max_requests=args.max_requests,
        block_size=args.block_size, restore_dir=args.restore_dir,
        device=device,
    )
    srv = serve_stage(worker, args.port, wire_quant=args.wire_quant)
    log.info("stage_serving", stage=args.stage, stages=args.stages,
             lo=worker.lo, hi=worker.hi, port=args.port, device=str(device))
    threading.Thread(
        target=_watch_parent, args=(srv, os.getppid()), daemon=True,
    ).start()
    try:
        srv.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


# -- stage transport ----------------------------------------------------------

class StageStepError(RuntimeError):
    """A chain hop failed (after transport-level retries). `.stage` names
    the hop so the controller can classify/salvage."""

    def __init__(self, stage: int, msg: str):
        super().__init__(msg)
        self.stage = stage


class HttpStageTransport:
    """The stage plane over HTTP: npz windows over POST /stage/step with
    the shared retry/backoff discipline, deadlines, traceparent
    propagation, deterministic fault points, optional int8 wire
    quantization, and accounted wire bytes."""

    def __init__(self, *, wire_quant: Optional[str] = None,
                 deadline_s: float = DEFAULT_STEP_DEADLINE_S,
                 registry: Optional[MetricsRegistry] = None):
        if wire_quant not in (None, "int8"):
            raise ValueError(f"wire_quant must be None or 'int8', "
                             f"got {wire_quant!r}")
        self.wire_quant = wire_quant
        self.deadline_s = float(deadline_s)
        self.registry = registry or MetricsRegistry()
        self._wire_bytes = self.registry.counter(
            "dli_pp_wire_bytes_total",
            "inter-stage activation bytes shipped on the pp/sp wire, by "
            "transfer family", ("path",),
        )

    def _account_link(self, name: str, nbytes: int):
        """Runtime byte accounting for one wire link; the literal first
        argument at each call site names the link (the JAX package's
        comms table checks those literals)."""
        del name
        self._wire_bytes.labels(path="stage").inc(nbytes)

    def _request(self, url: str, data: Optional[bytes], headers: dict,
                 timeout_s: float, method: str = "POST"):
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        return urllib.request.urlopen(req, timeout=timeout_s)

    def get_json(self, addr: str, path: str, timeout_s: float = 5.0) -> dict:
        with self._request(f"http://{addr}{path}", None, {}, timeout_s,
                           method="GET") as resp:
            return json.loads(resp.read().decode())

    def post_json(self, addr: str, path: str, obj: dict,
                  timeout_s: float = 10.0) -> dict:
        body = json.dumps(obj).encode()
        with self._request(
            f"http://{addr}{path}", body,
            {"Content-Type": "application/json"}, timeout_s,
        ) as resp:
            return json.loads(resp.read().decode())

    def step(self, addr: str, stage: int, request_id: str, pos: int, *,
             tokens=None, h=None, ctx: Optional[SpanContext] = None,
             deadline_s: Optional[float] = None) -> dict:
        """One hop: ship the window to `stage`, return {"h": ...} or
        {"token": int}. Retries 429/503 with the shared backoff until
        the deadline; any other failure raises StageStepError."""
        faults.check("stage_send", tag=f"{request_id}:step:stage{stage}")
        if tokens is not None:
            body = _npz_bytes({"tokens": np.asarray(tokens, np.int32)})
            quant = ""
        elif self.wire_quant == "int8":
            from ..ops.wire_quant import quantize_rows

            q, s = quantize_rows(torch.from_numpy(np.asarray(h, np.float32)))
            body = _npz_bytes({"q": q.numpy(), "s": s.numpy()})
            quant = "int8"
        else:
            body = _npz_bytes({"h": np.asarray(h, np.float32)})
            quant = ""
        if h is not None:
            self._account_link("stage-activation-dcn", len(body))
        headers = {
            "Content-Type": "application/octet-stream",
            "X-Stage-Request-Id": request_id,
            "X-Stage-Pos": str(pos),
        }
        if quant:
            headers["X-Stage-Quant"] = quant
        if ctx is not None:
            headers["traceparent"] = ctx.header()
        deadline = time.monotonic() + (
            self.deadline_s if deadline_s is None else deadline_s
        )
        attempt = 0
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise StageStepError(
                    stage, f"stage {stage} step deadline exceeded"
                )
            try:
                with self._request(f"http://{addr}/stage/step", body,
                                   headers, budget) as resp:
                    raw = resp.read()
                    ctype = resp.headers.get("Content-Type", "")
                break
            except urllib.error.HTTPError as e:
                retry_after = e.headers.get("Retry-After") \
                    if e.headers else None
                e.close()
                if e.code not in RETRY_STATUSES:
                    raise StageStepError(
                        stage, f"stage {stage} step failed: HTTP {e.code}"
                    )
                delay = min(
                    retry_delay(attempt, retry_after),
                    max(0.0, deadline - time.monotonic()),
                )
                time.sleep(delay)
                attempt += 1
            except (urllib.error.URLError, socket.timeout,
                    ConnectionError, OSError) as e:
                raise StageStepError(
                    stage, f"stage {stage} unreachable: {e}"
                )
        faults.check("stage_recv", tag=f"{request_id}:reply:stage{stage}")
        if ctype.startswith("application/json"):
            out = json.loads(raw.decode())
            if "token" in out:
                self._account_link("stage-result-dcn", len(raw))
            return out
        self._account_link("stage-activation-dcn", len(raw))
        arrays = _npz_load(raw)
        if "q" in arrays:
            h = arrays["q"].astype(np.float32) * arrays["s"][..., None]
            return {"h": h}
        return {"h": arrays["h"]}


class DeviceStageTransport:
    """Device-to-device transfers between stage processes (no host round
    trip, no npz). Not built, as in the JAX package: off a multi-process
    torch.distributed group constructing it raises with the HTTP
    transport as the guidance; on one it raises NotImplementedError."""

    def __init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise RuntimeError(
                "DeviceStageTransport needs an initialized multi-process "
                "torch.distributed group (world size > 1); on a single "
                "process use HttpStageTransport — the loopback with the "
                "same contract"
            )
        raise NotImplementedError(
            "device-to-device stage transfers are not built (the JAX "
            "package has none either); HttpStageTransport carries the "
            "full contract (deadlines, retry, salvage)"
        )


# -- supervisor: spawn/respawn stage processes --------------------------------

class StageSupervisor:
    """Owns the stage subprocesses: spawn from a recorded argv recipe,
    reap, respawn (the router's replica-respawn discipline at stage
    granularity), with a restart budget bounding crash loops."""

    def __init__(self, model: str, n_stages: int, ports, *,
                 seed: int = 0, max_seq: int = 0,
                 max_requests: int = DEFAULT_MAX_REQUESTS,
                 block_size: int = DEFAULT_BLOCK,
                 restore_dir: Optional[str] = None,
                 wire_quant: Optional[str] = None,
                 restart_budget: int = 3, env: Optional[dict] = None,
                 device: str = "cuda"):
        self.model = model
        self.n_stages = int(n_stages)
        self.ports = list(ports)
        if len(self.ports) != self.n_stages:
            raise ValueError("need one port per stage")
        self.restart_budget = int(restart_budget)
        self.env = dict(env) if env else None
        self._argv_extra = []
        if max_seq:
            self._argv_extra += ["--max-seq", str(max_seq)]
        if restore_dir:
            self._argv_extra += ["--restore-dir", restore_dir]
        if wire_quant:
            self._argv_extra += ["--wire-quant", wire_quant]
        self._argv_extra += [
            "--seed", str(seed), "--max-requests", str(max_requests),
            "--block-size", str(block_size), "--device", str(device),
        ]
        self._lock = threading.Lock()
        self._procs: dict = {}     # guarded-by: _lock
        self._restarts: dict = {}  # guarded-by: _lock

    def addr(self, stage: int) -> str:
        return f"127.0.0.1:{self.ports[stage]}"

    def spawn_argv(self, stage: int) -> list:
        return [
            sys.executable, "-m",
            "distributed_llm_inference_tpu_torch.serving.stage_runtime",
            "--stage", str(stage), "--stages", str(self.n_stages),
            "--model", self.model, "--port", str(self.ports[stage]),
        ] + self._argv_extra

    def spawn(self, stage: int) -> subprocess.Popen:
        proc = subprocess.Popen(
            self.spawn_argv(stage), env=self.env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        with self._lock:
            self._procs[stage] = proc
        return proc

    def spawn_all(self):
        for s in range(self.n_stages):
            self.spawn(s)

    def proc(self, stage: int) -> Optional[subprocess.Popen]:
        with self._lock:
            return self._procs.get(stage)

    def proc_alive(self, stage: int) -> bool:
        p = self.proc(stage)
        return p is not None and p.poll() is None

    def stop(self, stage: int, *, kill: bool = False,
             timeout_s: float = 10.0):
        p = self.proc(stage)
        if p is None:
            return
        if p.poll() is None:
            if kill:
                p.kill()
            else:
                p.terminate()
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=timeout_s)

    def respawn(self, stage: int) -> subprocess.Popen:
        """Reap whatever is left of the stage and start a fresh process
        from the recorded recipe. Raises once the restart budget for
        this stage is exhausted (a stage that dies on every respawn is a
        poisoned deployment, not a transient)."""
        with self._lock:
            used = self._restarts.get(stage, 0)
            if used >= self.restart_budget:
                raise RuntimeError(
                    f"stage {stage} restart budget exhausted "
                    f"({used}/{self.restart_budget})"
                )
            self._restarts[stage] = used + 1
        self.stop(stage, kill=True)
        return self.spawn(stage)

    def shutdown(self):
        for s in range(self.n_stages):
            self.stop(s, kill=True, timeout_s=5.0)


# -- controller ---------------------------------------------------------------

class _CtrlReq:
    """Controller-side request state: the authoritative token stream
    (prompt + accepted generations) and how much of it every stage has
    ingested — exactly the info salvage replay needs."""

    __slots__ = ("toks", "fed", "prompt_len", "ctx", "done")

    def __init__(self, toks, prompt_len: int, ctx: SpanContext):
        self.toks = list(toks)
        self.fed = 0
        self.prompt_len = prompt_len
        self.ctx = ctx
        self.done = False


class MPMDPipeline:
    """The orchestrator: drives token windows through the stage chain,
    monitors heartbeats, and runs salvage / rolling restarts.

    Callers (one per in-flight request, e.g. frontend handler threads)
    call start()/step_once()/finish(); overlap across requests IS the
    1F1B wavefront — each stage serializes its own compute, so request B
    occupies stage 0 while request A is on stage 1
    (parallel/schedule.mpmd_1f1b_order is the closed form of this
    ordering). Maintenance (salvage, rolling restart) takes a
    leadership flag, clears the dispatch gate, does its HTTP work with
    NO lock held, and reopens the gate — callers just wait on the gate
    and retry, which is what makes a stage swap invisible to callers."""

    def __init__(self, supervisor: StageSupervisor, *,
                 transport: Optional[HttpStageTransport] = None,
                 tokenizer=None, eos_id: Optional[int] = None,
                 hb_interval_s: float = DEFAULT_HB_INTERVAL_S,
                 hb_timeout_s: float = DEFAULT_HB_TIMEOUT_S,
                 salvage_timeout_s: float = DEFAULT_SALVAGE_TIMEOUT_S,
                 auto_salvage: bool = False,
                 flight: Optional[FlightRecorder] = None):
        self.sup = supervisor
        self.n_stages = supervisor.n_stages
        self.transport = transport or HttpStageTransport()
        self.tokenizer = tokenizer or ByteTokenizer()
        self.eos_id = (self.tokenizer.eos_token_id
                       if eos_id is None else int(eos_id))
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.salvage_timeout_s = float(salvage_timeout_s)
        self.auto_salvage = bool(auto_salvage)
        self.flight = flight or FlightRecorder()

        self._state_lock = threading.Lock()
        self._requests: dict = {}   # guarded-by: _state_lock
        self._liveness: dict = {}   # guarded-by: _state_lock
        self._maint = False         # guarded-by: _state_lock
        self._inflight = 0          # guarded-by: _state_lock
        self._last_salvage: dict = {}  # guarded-by: _state_lock
        self._running = threading.Event()
        self._running.set()
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start_fleet(self, *, ready_timeout_s: float = 60.0):
        """Spawn every stage and wait for /ready; then start the
        heartbeat monitor."""
        self.sup.spawn_all()
        for s in range(self.n_stages):
            self._wait_ready(s, ready_timeout_s)
        self.start_monitor()

    def start_monitor(self):
        t = threading.Thread(target=self._monitor, daemon=True,
                             name="stage-heartbeat-monitor")
        self._monitor_thread = t
        t.start()

    def shutdown(self):
        self._stop.set()
        t = self._monitor_thread
        if t is not None:
            t.join(timeout=5.0)
        self.sup.shutdown()

    def _wait_ready(self, stage: int, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        addr = self.sup.addr(stage)
        while time.monotonic() < deadline:
            try:
                out = self.transport.get_json(addr, "/ready", timeout_s=2.0)
                if out.get("ready"):
                    return
            except Exception:
                pass
            if not self.sup.proc_alive(stage):
                raise RuntimeError(
                    f"stage {stage} exited before becoming ready"
                )
            time.sleep(0.1)
        raise TimeoutError(f"stage {stage} not ready in {timeout_s}s")

    # -- liveness ------------------------------------------------------------

    def probe(self, stage: int) -> str:
        """One heartbeat probe -> 'live' | 'wedged' | 'dead'."""
        if not self.sup.proc_alive(stage):
            return "dead"
        try:
            self.transport.get_json(self.sup.addr(stage),
                                    "/stage/heartbeat",
                                    timeout_s=self.hb_timeout_s)
            return "live"
        except Exception:
            # unreachable: the process died under us, or it is alive but
            # not answering within the timeout (wedged)
            return "dead" if not self.sup.proc_alive(stage) else "wedged"

    def _monitor(self):
        while not self._stop.wait(self.hb_interval_s):
            for s in range(self.n_stages):
                status = self.probe(s)
                with self._state_lock:
                    prev = self._liveness.get(s, "live")
                    self._liveness[s] = status
                    maint = self._maint
                if status != prev:
                    self.flight.record("stage_liveness", stage=s,
                                       status=status, prev=prev)
                if status != "live" and prev == "live":
                    self.flight.record("heartbeat_lost", stage=s,
                                       status=status)
                if status == "dead" and self.auto_salvage and not maint:
                    self._ensure_salvaged(s)

    def liveness(self) -> dict:
        with self._state_lock:
            return dict(self._liveness)

    def ready(self) -> bool:
        """Pipeline readiness: every stage live, no maintenance window
        open. This is what the frontend's /ready serves — the router's
        prober ejects/readmits the pipeline through it."""
        with self._state_lock:
            if self._maint:
                return False
            states = [self._liveness.get(s, "live")
                      for s in range(self.n_stages)]
        return all(st == "live" for st in states)

    # -- request surface -----------------------------------------------------

    def start(self, prompt: str, *, request_id: Optional[str] = None) -> str:
        """Admit one request: prefill the prompt through the chain and
        accept the first greedy token. Returns the request id."""
        rid = request_id or new_request_id()
        toks = self.tokenizer.encode(prompt)
        ctx = SpanContext.new_root()
        req = _CtrlReq(toks, len(toks), ctx)
        with self._state_lock:
            self._requests[rid] = req
        first = self._chain_step(rid, req.toks, 0)
        with self._state_lock:
            req.fed = req.prompt_len
            req.toks.append(first)
            req.done = first == self.eos_id
        return rid

    def step_once(self, rid: str) -> Optional[int]:
        """One greedy decode step; None once the request is finished."""
        with self._state_lock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request {rid!r}")
        if req.done:
            return None
        pos = req.fed
        tok = self._chain_step(rid, req.toks[pos:pos + 1], pos)
        with self._state_lock:
            req.fed = pos + 1
            req.toks.append(tok)
            req.done = tok == self.eos_id
        return tok

    def finish(self, rid: str) -> dict:
        """Release the request's slots on every stage and return its
        transcript."""
        with self._state_lock:
            req = self._requests.pop(rid, None)
        if req is None:
            raise KeyError(f"unknown request {rid!r}")
        for s in range(self.n_stages):
            try:
                self.transport.post_json(self.sup.addr(s), "/stage/close",
                                         {"request_id": rid})
            except Exception as e:
                log.warning("close_failed", rid=rid, stage=s, err=str(e))
        gen = req.toks[req.prompt_len:]
        if gen and gen[-1] == self.eos_id:
            gen = gen[:-1]
        return {
            "request_id": rid,
            "tokens": gen,
            "text": self.tokenizer.decode(gen),
        }

    def generate(self, prompt: str, max_new_tokens: int,
                 *, request_id: Optional[str] = None) -> dict:
        """Greedy end-to-end generation (the frontend's /generate)."""
        rid = self.start(prompt, request_id=request_id)
        for _ in range(max_new_tokens - 1):
            if self.step_once(rid) is None:
                break
        return self.finish(rid)

    # -- the chain -----------------------------------------------------------

    def _chain_once(self, rid: str, window, pos: int,
                    ctx: Optional[SpanContext]):
        """Drive one window through every stage, no retries. Returns the
        last stage's greedy token."""
        payload: dict = {"tokens": np.asarray([window], np.int32)}
        for s in range(self.n_stages):
            out = self.transport.step(
                self.sup.addr(s), s, rid, pos,
                tokens=payload.get("tokens"), h=payload.get("h"), ctx=ctx,
            )
            payload = out
        return payload["token"]

    def _chain_step(self, rid: str, window, pos: int) -> int:
        """One scheduled window: waits out maintenance windows, runs the
        chain, and on failure classifies the fleet (dead stage ->
        salvage; transient -> backoff) and retries. This loop is why a
        kill -9 or a dropped hop never surfaces to the caller."""
        with self._state_lock:
            req = self._requests.get(rid)
        ctx = req.ctx if req is not None else None
        deadline = time.monotonic() + self.salvage_timeout_s
        attempt = 0
        while True:
            self._running.wait(timeout=self.salvage_timeout_s)
            try:
                with self._state_lock:
                    self._inflight += 1
                try:
                    return self._chain_once(rid, window, pos, ctx)
                finally:
                    with self._state_lock:
                        self._inflight -= 1
            except (StageStepError, faults.FaultError) as e:
                stage = getattr(e, "stage", None)
                self.flight.record("step_failed", rid=rid,
                                   stage=-1 if stage is None else stage,
                                   err=str(e)[:160])
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"request {rid}: step at pos {pos} failed past "
                        f"the salvage deadline: {e}"
                    )
                dead = self._find_dead_stage()
                if dead is not None:
                    self._ensure_salvaged(dead)
                else:
                    time.sleep(retry_delay(attempt, None, base_s=0.05,
                                           cap_s=1.0))
                attempt += 1

    def _find_dead_stage(self) -> Optional[int]:
        for s in range(self.n_stages):
            if self.probe(s) == "dead":
                return s
        return None

    # -- maintenance: salvage + rolling restart ------------------------------

    def _take_maintenance(self) -> bool:
        with self._state_lock:
            if self._maint:
                return False
            self._maint = True
        self._running.clear()
        return True

    def _release_maintenance(self):
        with self._state_lock:
            self._maint = False
        self._running.set()

    def _wait_inflight_drained(self, timeout_s: float = 10.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._state_lock:
                n = self._inflight
            if n == 0:
                return
            time.sleep(0.01)

    def _replay_restored(self, stage: int) -> dict:
        """After `stage` came back: close the requests it resurrected that
        are no longer in flight, and replay each in-flight request's
        missing window [restored_pos, fed) through the WHOLE chain
        (survivors overwrite their KV, the restored stage fills its gap).
        Returns the tokens recomputed per request."""
        health = self.transport.get_json(self.sup.addr(stage), "/health")
        restored = {str(k): int(v)
                    for k, v in (health.get("restored") or {}).items()}
        with self._state_lock:
            active = dict(self._requests)
        for rid in restored:
            if rid not in active:
                try:
                    self.transport.post_json(
                        self.sup.addr(stage), "/stage/close",
                        {"request_id": rid},
                    )
                except Exception:
                    pass
        recomputed = {}
        for rid, req in active.items():
            p_r = min(restored.get(rid, 0), req.fed)
            if p_r < req.fed:
                self._chain_once(rid, req.toks[p_r:req.fed], p_r, req.ctx)
            recomputed[rid] = req.fed - p_r
        with self._state_lock:
            self._liveness[stage] = "live"
        return recomputed

    def _ensure_salvaged(self, stage: int):
        """Fleet-wide salvage of a dead stage. Leader does the work;
        concurrent callers just wait for the dispatch gate to reopen
        (their step retry loop re-runs the failed window afterwards)."""
        if not self._take_maintenance():
            self._running.wait(timeout=self.salvage_timeout_s)
            return
        t0 = time.monotonic()
        self.flight.record("salvage_start", stage=stage)
        try:
            self._wait_inflight_drained()
            # 1. survivors flush their shadow (bounds THEIR replay
            #    window if the fault cascades)
            for s in range(self.n_stages):
                if s == stage:
                    continue
                try:
                    self.transport.post_json(self.sup.addr(s),
                                             "/stage/flush", {})
                except Exception as e:
                    log.warning("salvage_flush_failed", stage=s, err=str(e))
            # 2. respawn the dead stage (warm-restores from restore_dir)
            self.sup.respawn(stage)
            self.flight.record("stage_respawn", stage=stage)
            self._wait_ready(stage, self.salvage_timeout_s)
            # 3-4. close what it resurrected needlessly, replay the rest
            recomputed = self._replay_restored(stage)
            secs = round(time.monotonic() - t0, 3)
            with self._state_lock:
                self._last_salvage = {
                    "stage": stage,
                    "secs": secs,
                    "tokens_recomputed": recomputed,
                }
            self.flight.record("salvage_done", stage=stage, secs=secs,
                               recomputed=sum(recomputed.values()))
        finally:
            self._release_maintenance()

    def last_salvage(self) -> dict:
        with self._state_lock:
            return dict(self._last_salvage)

    def rolling_restart(self) -> dict:
        """Cycle every stage through drain -> respawn -> /ready, one at
        a time, pausing dispatch only during each swap window. In-flight
        requests stall briefly at the gate and resume — zero drops."""
        report = []
        for s in range(self.n_stages):
            while not self._take_maintenance():
                self._running.wait(timeout=self.salvage_timeout_s)
            t0 = time.monotonic()
            try:
                self._wait_inflight_drained()
                try:
                    self.transport.post_json(self.sup.addr(s),
                                             "/admin/drain", {})
                except Exception as e:
                    log.warning("rolling_drain_failed", stage=s, err=str(e))
                self.sup.stop(s)
                self.sup.spawn(s)
                self._wait_ready(s, self.salvage_timeout_s)
                recomputed = sum(self._replay_restored(s).values())
                secs = round(time.monotonic() - t0, 3)
                self.flight.record("rolling_stage_done", stage=s,
                                   secs=secs, recomputed=recomputed)
                report.append({"stage": s, "secs": secs,
                               "tokens_recomputed": recomputed})
            finally:
                self._release_maintenance()
        self.flight.record("rolling_restart_done",
                           stages=len(report))
        return {"stages": report}

    def health(self) -> dict:
        per_stage = []
        for s in range(self.n_stages):
            entry: dict = {"stage": s,
                           "status": self.liveness().get(s, "unknown")}
            try:
                entry.update(self.transport.get_json(
                    self.sup.addr(s), "/health", timeout_s=2.0,
                ))
            except Exception as e:
                entry["error"] = str(e)
            per_stage.append(entry)
        with self._state_lock:
            active = len(self._requests)
            maint = self._maint
        return {
            "n_stages": self.n_stages,
            "ready": self.ready(),
            "maintenance": maint,
            "active_requests": active,
            "last_salvage": self.last_salvage(),
            "stages": per_stage,
        }


# -- frontend: the pipeline's public HTTP face --------------------------------

def serve_frontend(pipe: MPMDPipeline, port: int) -> ThreadingHTTPServer:
    """Thin HTTP front for the controller: /generate, /ready, /health,
    /metrics, /debug/flight, /admin/rolling-restart. It speaks the same
    readiness protocol as serving/server.py, so the router tier probes,
    ejects, and readmits an MPMD pipeline like any replica."""
    registry = pipe.transport.registry
    http_requests = registry.counter(
        "dli_frontend_requests_total",
        "frontend responses by route/status", ("route", "status"),
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _count(self, code: int):
            http_requests.labels(
                route=self.path.split("?")[0], status=str(code)
            ).inc()

        def _send(self, code: int, payload,
                  content_type="application/json", headers=None):
            body = (
                payload if isinstance(payload, bytes)
                else json.dumps(payload).encode()
            )
            self._count(code)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/ready":
                if pipe.ready():
                    self._send(200, {"ready": True})
                else:
                    self._send(503, {"ready": False,
                                     "liveness": pipe.liveness()},
                               headers={"Retry-After": str(RETRY_AFTER_S)})
            elif path == "/health":
                self._send(200, pipe.health())
            elif path == "/metrics":
                self._send(200, registry.render().encode(),
                           content_type="text/plain; version=0.0.4")
            elif path == "/debug/flight":
                self._send(200, pipe.flight.dump())
            else:
                self._send(404, {"error": f"unknown route {path}"})

        def do_POST(self):
            path = self.path.split("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b"{}"
            if path == "/generate":
                try:
                    req = json.loads(body or b"{}")
                    # "max_tokens" is the key the main server's /generate
                    # takes; honor it here too so clients can't silently
                    # fall through to the default
                    out = pipe.generate(
                        str(req.get("prompt", "")),
                        int(req.get("max_new_tokens",
                                    req.get("max_tokens", 16))),
                    )
                    self._send(200, out)
                except Exception as e:
                    self._send(500, {"error_type": "internal",
                                     "error": f"{type(e).__name__}: {e}"})
            elif path == "/admin/rolling-restart":
                try:
                    self._send(200, pipe.rolling_restart())
                except Exception as e:
                    self._send(500, {"error_type": "internal",
                                     "error": f"{type(e).__name__}: {e}"})
            else:
                self._send(404, {"error": f"unknown route {path}"})

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.daemon_threads = True
    return srv


def frontend_main(args) -> int:
    import signal

    from ..runtime import resolve_device

    faults.arm_from_env()
    # a frontend on a card-less host fails here, not in its stages
    resolve_device(args.device)
    # the frontend OWNS the stage subprocesses: a SIGTERM must unwind
    # through the finally below so pipe.shutdown() reaps them (otherwise
    # `kill <frontend>` orphans one process per stage)
    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_sigterm)
    ports = ([int(p) for p in args.stage_ports.split(",")]
             if args.stage_ports
             else [free_port() for _ in range(args.stages)])
    sup = StageSupervisor(
        args.model, args.stages, ports, seed=args.seed,
        max_seq=args.max_seq, max_requests=args.max_requests,
        block_size=args.block_size, restore_dir=args.restore_dir,
        wire_quant=args.wire_quant, device=args.device,
    )
    pipe = MPMDPipeline(
        sup,
        transport=HttpStageTransport(wire_quant=args.wire_quant),
        auto_salvage=True,
    )
    try:
        pipe.start_fleet()
        srv = serve_frontend(pipe, args.port)
        log.info("frontend_serving", port=args.port, stages=args.stages,
                 stage_ports=ports)
        try:
            srv.serve_forever(poll_interval=0.1)
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    finally:
        pipe.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="stage_runtime",
        description="MPMD pipeline: stage process or 2+-stage frontend",
    )
    ap.add_argument("--frontend", action="store_true",
                    help="run the controller + HTTP frontend "
                         "(spawns the stage fleet)")
    ap.add_argument("--stage", type=int, default=0,
                    help="this process's stage index (stage mode)")
    ap.add_argument("--stages", type=int, required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--stage-ports", default="",
                    help="comma-separated stage ports (frontend mode; "
                         "default: ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--max-requests", type=int,
                    default=DEFAULT_MAX_REQUESTS)
    ap.add_argument("--block-size", type=int, default=DEFAULT_BLOCK)
    ap.add_argument("--restore-dir", default=None)
    ap.add_argument("--wire-quant", choices=["int8"], default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stages (default cuda, where "
                         "they run in bfloat16; 'cpu' runs them in the "
                         "model's registry dtype); the frontend passes it "
                         "on to its stages")
    args = ap.parse_args(argv)
    if args.frontend:
        return frontend_main(args)
    return stage_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
