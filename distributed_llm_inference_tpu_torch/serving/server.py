"""HTTP serving surface of the PyTorch port (the solo path of the JAX
package's serving/server.py).

Routes: `POST /generate` (one "prompt", or a "prompts" list served as one
left-padded batch), `GET /health`, `GET /ready`, `GET /workers` (the
device sweep), `GET /` (the HTML status page), `GET /stats`,
`GET /metrics`, `GET /debug/flight` (the flight recorder) and
`POST /profiler/start|stop` (torch.profiler traces under a base
directory), on the stdlib ThreadingHTTPServer. For the same request
the envelope keys and the error codes (400, 499, 503, 504, ...) are the
JAX server's. With `--continuous N` single-prompt `/generate` requests
go to the continuous fleet (engine/continuous.py): over the block-paged
KV pool with `--kv-pool-blocks M`, else over the dense slot cache; `/stats`
nests its stats under "continuous".
`--faults SPEC` (or the DLI_FAULTS environment variable) arms the
fault-injection harness (utils/faults.py) for chaos drills of the fleet's
supervisor. The queue, the OpenAI routes and the KV fabric arrive with
later slices.

    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --attn-impl auto
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --quant int4 --kv-quant int8 --continuous 8 --kv-pool-blocks 513 \\
        --kv-block-size 16 --continuous-max-seq 1024
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --continuous-max-seq 1024
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

__version__ = "torch_port_v1"

DEFAULT_MAX_TOKENS = 20
DEFAULT_TEMPERATURE = 0.7
DEFAULT_TOP_K = 50
DEFAULT_TOP_P = 0.9
# Retry-After (seconds) sent with every drain/overload rejection
RETRY_AFTER_S = 2
# routes of the JAX server that the port does not serve yet: 501 with the
# ROADMAP.md item that ports them, never a bare 404
_NOT_PORTED_ROUTES = {
    "/v1/models": 'ROADMAP.md "Solo-engine features"',
    "/v1/completions": 'ROADMAP.md "Solo-engine features"',
    "/v1/chat/completions": 'ROADMAP.md "Solo-engine features"',
    "/debug/traces": 'ROADMAP.md "Fleet tier"',
}


def _not_ported_route(path: str) -> Optional[dict]:
    """The 501 body for a JAX-server route the port lacks, else None."""
    key = "/debug/traces" if path.startswith("/debug/traces") else path
    item = _NOT_PORTED_ROUTES.get(key)
    if item is None:
        return None
    return {"error": f"{key} is not ported to the PyTorch server yet ({item})"}
_KNOWN_ROUTES = frozenset((
    "/", "/health", "/ready", "/workers", "/stats", "/metrics", "/generate",
    "/profiler/start", "/profiler/stop", "/debug/flight",
))


def _parse_bool(v, name: str) -> bool:
    """Strict JSON-ish bool (bool("false") is True, which would invert the
    caller's intent): non-bool junk is a 400."""
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
    raise ValueError(f"{name} must be a boolean, got {v!r}")


def _status_html(engine) -> str:
    h = engine.health()
    stages = engine.backend.health()
    rows = "".join(
        f"<tr><td>stage {s['stage']}</td><td>{', '.join(s['devices'])}</td>"
        f"<td>{s.get('layers', '-')}</td><td>{s['status']}</td></tr>"
        for s in stages
    )
    return f"""<html><head><title>distributed_llm_inference_tpu_torch</title></head>
<body style="font-family: monospace; margin: 2em;">
<h1>distributed_llm_inference_tpu_torch — orchestrator</h1>
<p>status: <b>{h['status']}</b> | model: <b>{h['model']}</b> |
backend: <b>{h['backend']}</b> | stages: <b>{h['n_stages']}</b> |
requests served: <b>{h['requests_served']}</b></p>
<table border="1" cellpadding="4">
<tr><th>stage</th><th>devices</th><th>layers</th><th>status</th></tr>
{rows}
</table>
<p>POST /generate {{"prompt": ..., "max_tokens": ..., "temperature": ...}}
| GET /health | GET /workers</p>
</body></html>"""


class _Profiler:
    """torch.profiler trace capture behind HTTP: POST /profiler/start, the
    requests to trace, POST /profiler/stop, which writes a Chrome trace
    (viewable in Perfetto) of the card's kernels and the host.

    A profiler session is entered and left on one thread, so each trace
    runs on a thread of its own from start to stop (the HTTP requests that
    start and stop it land on different handler threads).

    Clients name a subdirectory, not a path: traces always land under
    `base` — otherwise POST /profiler/start would be an arbitrary
    filesystem-write primitive for anyone who can reach the port."""

    def __init__(self, base: Optional[str] = None):
        self._lock = threading.Lock()
        self.base = base or os.path.join(tempfile.gettempdir(), "dli-torch-traces")
        self.dir: Optional[str] = None
        self._session = None  # (thread, stop event, outcome dict)

    def _resolve(self, name: str) -> str:
        name = name or "trace"
        if os.path.isabs(name) or ".." in name.split("/"):
            raise ValueError(f"trace_dir must be a relative subdir name, got {name!r}")
        out = os.path.normpath(os.path.join(self.base, name))
        if not (out + "/").startswith(os.path.normpath(self.base) + "/"):
            raise ValueError(f"trace_dir escapes base: {name!r}")
        return out

    @staticmethod
    def _trace(out: str, started: threading.Event, stop: threading.Event,
               outcome: dict):
        """One profiler session: enter, wait for stop, leave, export."""
        import torch

        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                started.set()
                stop.wait()
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
        except Exception as e:  # noqa: BLE001 - reported to the caller
            outcome["error"] = str(e)
        finally:
            started.set()

    def start(self, trace_dir: str) -> dict:
        with self._lock:
            if self.dir is not None:
                return {"error": f"trace already running to {self.dir}"}
            try:
                resolved = self._resolve(trace_dir)
                os.makedirs(resolved, exist_ok=True)
            except Exception as e:
                return {"error": f"profiler start failed: {e}"}
            started, stop, outcome = threading.Event(), threading.Event(), {}
            t = threading.Thread(target=self._trace, name="profiler", daemon=True,
                                 args=(resolved, started, stop, outcome))
            t.start()
            started.wait()
            if "error" in outcome:
                t.join()
                return {"error": f"profiler start failed: {outcome['error']}"}
            self.dir, self._session = resolved, (t, stop, outcome)
            return {"status": "tracing", "trace_dir": resolved}

    def stop(self) -> dict:
        with self._lock:
            if self.dir is None:
                return {"error": "no trace running"}
            out = self.dir
            t, stop, outcome = self._session
            stop.set()
            t.join(timeout=120)
            if t.is_alive() or "error" in outcome:
                # keep self.dir so the state stays truthful ('trace already
                # running' on a retried /start) and tell the caller
                why = outcome.get("error", "the trace did not finish writing")
                return {
                    "error": f"profiler stop failed: {why}; trace state is "
                    "unknown — retry /profiler/stop or restart the server",
                    "trace_dir": out,
                }
            self.dir = self._session = None
            return {"status": "stopped", "trace_dir": out}


def _status_code(result: dict) -> tuple:
    """(HTTP code, extra headers) for an engine envelope."""
    err_type = result.get("error_type")
    if result.get("status") == "success":
        return 200, None
    if err_type == "invalid_request":
        return 400, None
    if err_type == "deadline_exceeded":
        return 504, None  # the request's own budget: never retried
    if err_type == "cancelled":
        return 499, None
    if err_type in ("timeout", "unavailable", "draining"):
        return 503, (None if err_type == "timeout"
                     else {"Retry-After": str(RETRY_AFTER_S)})
    if err_type == "overloaded":
        return 429, {"Retry-After": str(result.get("retry_after_s", RETRY_AFTER_S))}
    return 500, None


def make_handler(engine, max_tokens_cap: int, state=None,
                 wedge_unready_s: float = 10.0, continuous=None,
                 profiler: Optional[_Profiler] = None):
    from ..utils.logging import request_id_context
    from ..utils.tracing import (
        SpanContext,
        new_request_id,
        parse_traceparent,
        sanitize_request_id,
    )

    if state is None:  # embedding callers without an InferenceServer
        state = _ServerState()
    profiler = profiler or _Profiler()
    slo_classes = {c[0] for c in engine.engine_cfg.slo_classes}
    http_requests = engine.metrics.counter(
        "dli_http_requests_total", "HTTP responses",
        ("route", "method", "status"),
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # serving logs are structured
            pass

        _rid: Optional[str] = None
        _trace_ctx = None

        def _count(self, code: int):
            path = self.path.split("?")[0].rstrip("/") or "/"
            http_requests.labels(
                route=path if path in _KNOWN_ROUTES else "other",
                method=self.command, status=str(code),
            ).inc()

        def _send(self, code: int, payload: Any, content_type="application/json",
                  headers=None):
            body = (
                payload.encode() if isinstance(payload, str)
                else json.dumps(payload).encode()
            )
            self._count(code)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if self._rid:
                self.send_header("X-Request-Id", self._rid)
            if self._trace_ctx is not None:
                self.send_header("X-Trace-Id", self._trace_ctx.trace_id)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _readiness(self) -> tuple:
            """(ready, reason): the load-balancer signal — False while
            draining, while an abandoned deadline-overrun call has been
            wedged past --wedge-unready, and while the continuous
            scheduler is restart-looping or dead. /health stays 200."""
            if state.draining:
                return False, "draining"
            if wedge_unready_s:
                age = engine.max_wedged_age()
                if age is not None and age > wedge_unready_s:
                    return False, "wedged"
            if continuous is not None and not continuous.ready:
                return False, (
                    "scheduler_dead"
                    if continuous.stats()["supervisor"]["dead"]
                    else "scheduler_restarting"
                )
            return True, None

        def do_GET(self):
            self._rid = None
            self._trace_ctx = None
            path = self.path.split("?")[0].rstrip("/") or "/"
            if path == "/":
                self._send(200, _status_html(engine), content_type="text/html")
            elif path == "/health":
                h = engine.health()
                ready, why = self._readiness()
                # liveness stays 200 while draining: readiness is /ready
                self._send(200, {
                    "status": h["status"],
                    "ready": ready,
                    **({"ready_reason": why} if why else {}),
                    "role": "orchestrator",
                    "replica_class": engine.engine_cfg.replica_class,
                    "model": h["model"],
                    "version": __version__,
                    "backend": h["backend"],
                    "n_stages": h["n_stages"],
                    "requests_served": h["requests_served"],
                    "stats": h["stats"],
                })
            elif path == "/ready":
                ready, why = self._readiness()
                if ready:
                    self._send(200, {"ready": True})
                else:
                    self._send(503, {"ready": False, "reason": why},
                               headers={"Retry-After": str(RETRY_AFTER_S)})
            elif path == "/workers":
                # the source system's shape, {"worker_1": "online", ...},
                # from engine.workers(), re-keyed to 1-based names
                stages = list(engine.workers()["workers"].values())
                results = {f"worker_{s['stage'] + 1}": s["status"] for s in stages}
                results["detail"] = stages
                self._send(200, results)
            elif path == "/debug/flight":
                # the ring the fleet's supervisor dumps on a crash
                self._send(200, engine.flight.dump())
            elif path == "/stats":
                s = engine.stats()
                if continuous is not None:
                    s["continuous"] = continuous.stats()
                self._send(200, s)
            elif path == "/metrics":
                self._send(200, engine.metrics.render(),
                           content_type="text/plain; version=0.0.4; charset=utf-8")
            else:
                missing = _not_ported_route(path)
                self._send(501 if missing else 404,
                           missing or {"error": f"no route {path}"})

        def _deadline_ms(self, data: dict):
            """The request's end-to-end budget in ms, or None; the
            X-Request-Deadline-Ms header overrides the body field."""
            hdr = self.headers.get("X-Request-Deadline-Ms")
            if hdr is not None:
                try:
                    return float(hdr)
                except (TypeError, ValueError):
                    pass  # junk header: fall back to the body field
            raw = data.get("deadline_ms")
            if raw is None:
                return None
            dl = float(raw)  # ValueError -> 400
            if dl <= 0:
                raise ValueError("deadline_ms must be > 0")
            return dl

        def _read_json(self):
            """Parse the request body; None (after a 400 reply) on bad JSON."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._send(400, {"error": "invalid JSON body"})
                return None

        def do_POST(self):
            path = self.path.split("?")[0].rstrip("/")
            self._rid = (
                sanitize_request_id(self.headers.get("X-Request-Id"))
                or new_request_id()
            )
            self._trace_ctx = (
                parse_traceparent(self.headers.get("traceparent"))
                or SpanContext.new_root()
            )
            with request_id_context(self._rid, self._trace_ctx.trace_id):
                self._do_POST(path)

        def _do_POST(self, path: str):
            if state.draining and path == "/generate":
                self._send(
                    503,
                    {"error": "Error: server draining", "status": "failed",
                     "error_type": "draining"},
                    headers={"Retry-After": str(RETRY_AFTER_S)},
                )
                return
            if path == "/profiler/start":
                data = self._read_json()
                if data is None:
                    return
                # a subdirectory NAME under the profiler base, not a path
                res = profiler.start(data.get("trace_dir", "trace"))
                self._send(400 if "error" in res else 200, res)
                return
            if path == "/profiler/stop":
                res = profiler.stop()
                self._send(400 if "error" in res else 200, res)
                return
            if path != "/generate":
                missing = _not_ported_route(path)
                self._send(501 if missing else 404,
                           missing or {"error": f"no route {path}"})
                return
            data = self._read_json()
            if data is None:
                return
            prompt = data.get("prompt", "")
            prompts = data.get("prompts")
            if not prompt and not prompts:
                self._send(400, {"error": "No prompt provided"})
                return
            try:
                result = self._generate(data, prompt, prompts)
            except (TypeError, ValueError) as e:
                self._send(400, {"error": f"bad parameter: {e}"})
                return
            if result is None:
                return  # already answered
            code, headers = _status_code(result)
            self._send(code, result, headers=headers)

        def _generate(self, data: dict, prompt, prompts) -> Optional[dict]:
            max_tokens = min(int(data.get("max_tokens", DEFAULT_MAX_TOKENS)),
                             max_tokens_cap)
            seed = data.get("seed")
            kwargs = dict(
                request_id=self._rid,
                max_tokens=max_tokens,
                temperature=float(data.get("temperature", DEFAULT_TEMPERATURE)),
                top_k=int(data.get("top_k", DEFAULT_TOP_K)),
                top_p=float(data.get("top_p", DEFAULT_TOP_P)),
                greedy=_parse_bool(data.get("greedy", False), "greedy"),
                chat=_parse_bool(data.get("chat", True), "chat"),
                seed=int(seed) if seed is not None else None,
                min_p=float(data.get("min_p", 0.0)),
                repetition_penalty=float(data.get("repetition_penalty", 1.0)),
                frequency_penalty=float(data.get("frequency_penalty", 0.0)),
                presence_penalty=float(data.get("presence_penalty", 0.0)),
            )
            raw_dl = self._deadline_ms(data)
            if raw_dl is not None:
                kwargs["deadline_ms"] = raw_dl
            raw_slo = data.get("slo_class")
            if raw_slo is not None:
                if not isinstance(raw_slo, str) or raw_slo not in slo_classes:
                    raise ValueError(
                        f"unknown slo_class {raw_slo!r}; configured: "
                        f"{sorted(slo_classes)}"
                    )
                kwargs["slo_class"] = raw_slo
            raw_tenant = data.get("tenant")
            if raw_tenant is not None:
                if not isinstance(raw_tenant, str) or not raw_tenant:
                    raise ValueError("tenant must be a non-empty string")
                kwargs["tenant"] = raw_tenant
            raw_adapter = data.get("adapter")
            if raw_adapter is not None and raw_adapter != engine.cfg.name:
                if not isinstance(raw_adapter, str):
                    raise ValueError("adapter must be a string")
                raise ValueError(
                    "adapter serving is not configured: start with "
                    "--adapter-slots (and --continuous + --kv-pool-blocks)"
                )
            nbeams = data.get("num_beams")
            if nbeams is not None and int(nbeams) > 1:
                kwargs["num_beams"] = int(nbeams)
                kwargs["length_penalty"] = float(data.get("length_penalty", 1.0))
                kwargs["early_stopping"] = _parse_bool(
                    data.get("early_stopping", False), "early_stopping"
                )
            raw_bias = data.get("logit_bias")
            if raw_bias is not None:
                if not isinstance(raw_bias, dict):
                    raise ValueError("logit_bias must be an object of "
                                     "token_id -> bias")
                kwargs["logit_bias"] = {int(k): float(v) for k, v in raw_bias.items()}
            raw_con = data.get("constraint")
            if raw_con is not None:
                if not isinstance(raw_con, dict):
                    raise ValueError(
                        "constraint must be an object with one of 'regex', "
                        "'choices', 'json_schema', 'json_object'"
                    )
                kwargs["constraint"] = raw_con
            raw_stop = data.get("stop")
            if raw_stop is not None:
                if isinstance(raw_stop, str):
                    raw_stop = [raw_stop]
                if not (isinstance(raw_stop, list)
                        and all(isinstance(s, str) for s in raw_stop)):
                    raise ValueError("stop must be a string or list of strings")
                kwargs["stop"] = raw_stop
            if _parse_bool(data.get("stream", False), "stream"):
                # the solo engine decodes a whole request per call: there
                # is nothing to stream per token; the fleet's stream() is
                # not ported yet
                self._send(400, {
                    "error": "streaming requires --continuous and a single 'prompt'"
                    if continuous is None else
                    "streaming from the continuous fleet is not ported yet "
                    "(ROADMAP.md \"Solo-engine features\")",
                })
                return None
            if prompts is not None:
                # batched form: "prompts": [...] -> one batch, N results
                if not isinstance(prompts, list):
                    raise ValueError("prompts must be a list of strings")
                if kwargs.get("logit_bias"):
                    raise ValueError("logit_bias requires a single 'prompt'")
                if kwargs.get("num_beams", 1) > 1:
                    raise ValueError("num_beams requires a single 'prompt'")
                return engine.generate_batch(prompts, **kwargs)
            kwargs["debug"] = _parse_bool(data.get("debug", False), "debug")
            kwargs["speculative"] = _parse_bool(
                data.get("speculative", False), "speculative"
            )
            kwargs["logprobs"] = _parse_bool(data.get("logprobs", False), "logprobs")
            if continuous is not None:
                return continuous.submit(prompt, **kwargs)
            return engine.generate(prompt, **kwargs)

    return Handler


class _ServerState:
    """Flags shared between the server object and its handler class."""

    __slots__ = ("draining",)

    def __init__(self):
        self.draining = False


class InferenceServer:
    """Owns the HTTP server + engine: start()/shutdown() for embedding
    (tests, chip_smoke.py), serve_forever() for the CLI (which installs
    the SIGTERM -> graceful-drain handler)."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 5000,
                 max_tokens_cap: int = 30, drain_deadline_s: float = 30.0,
                 wedge_unready_s: float = 10.0, continuous=None):
        self.engine = engine
        self.continuous = continuous
        self.drain_deadline_s = float(drain_deadline_s)
        self.state = _ServerState()
        self.httpd = ThreadingHTTPServer(
            (host, port),
            make_handler(engine, max_tokens_cap, state=self.state,
                         wedge_unready_s=wedge_unready_s,
                         continuous=continuous),
        )
        self.port = self.httpd.server_address[1]

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Graceful drain: flip readiness (new requests get 503 +
        Retry-After), let the in-flight generation finish up to the
        deadline, then stop the HTTP server."""
        deadline = self.drain_deadline_s if deadline_s is None else float(deadline_s)
        t0 = time.time()
        self.state.draining = True
        ok = True
        if self.continuous is not None:
            ok = self.continuous.drain(deadline)
        ok = self.engine.drain(max(0.0, deadline - (time.time() - t0))) and ok
        from ..utils.logging import get_logger

        get_logger("server").info("drained", ok=ok, seconds=round(time.time() - t0, 3))
        self.shutdown()
        return ok

    def install_signal_handlers(self):
        """SIGTERM -> graceful drain on a thread (main thread only)."""
        import signal

        def _on_term(signum, frame):
            if self.state.draining:
                return
            self.state.draining = True
            threading.Thread(target=self.drain, name="sigterm-drain",
                             daemon=True).start()

        signal.signal(signal.SIGTERM, _on_term)

    def serve_forever(self):
        from ..utils.logging import configure, get_logger

        configure()
        self.install_signal_handlers()
        get_logger("server").info(
            "serving", port=self.port,
            routes=["/", "/generate", "/health", "/ready", "/workers", "/stats",
                    "/metrics", "/profiler/*", "/debug/flight"],
        )
        print(f"serving on :{self.port} — /generate /health /ready /workers /stats "
              f"/metrics /profiler/* /debug/flight")
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.continuous is not None:
            self.continuous.close()


def main(argv: Optional[list] = None):
    from ..config import EngineConfig
    from ..runtime import create_engine

    ap = argparse.ArgumentParser(
        description="distributed_llm_inference_tpu_torch server (PyTorch port)"
    )
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument(
        "--tokenizer", default=None, metavar="PATH",
        help="local HF tokenizer dir to serve with (loaded strict); "
             "default: the offline byte tokenizer",
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path on the CPU)")
    ap.add_argument("--dtype", default=None, choices=[None, "float32", "bfloat16"])
    ap.add_argument(
        "--attn-impl", default=None, choices=[None, "auto", "plain", "kernel"],
        help="attention for T>1 chunks: 'kernel' = the CUDA flash kernel "
             "(ops/flash_attention.py), 'plain' = einsum + mask, 'auto' = "
             "the kernel on a CUDA device; default keeps the model "
             "config's setting (plain)",
    )
    ap.add_argument(
        "--quant", default=None, choices=[None, "int8", "int4"],
        help="weight-only quantization (ops/quant.py): int8 per-output-"
             "channel scales, or int4 packed nibbles with group-wise scales "
             "(projections of <= 32 rows run the q4_matmul_rows kernel)",
    )
    ap.add_argument(
        "--kv-quant", default=None, choices=[None, "int8"],
        help="int8 KV cache with per-(token, head) scales (ops/kv_quant.py), "
             "solo and in the --continuous block pool; the attention "
             "kernels dequantize in their prologues",
    )
    ap.add_argument("--max-tokens-cap", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--deadline", type=float, default=None, metavar="SECONDS",
        help="per-request wall-clock deadline; overruns return a 503 "
             "timeout envelope",
    )
    ap.add_argument(
        "--drain-deadline", type=float, default=30.0, metavar="SECONDS",
        help="graceful-drain budget on SIGTERM",
    )
    ap.add_argument(
        "--wedge-unready", type=float, default=10.0, metavar="SECONDS",
        help="flip GET /ready to 503 while an abandoned deadline-overrun "
             "call has been stuck this long (0 disables)",
    )
    ap.add_argument(
        "--continuous", type=int, default=0, metavar="SLOTS",
        help="continuous (in-flight) batching: a fleet of SLOTS slots "
             "decodes in lock-step and new requests join free slots "
             "mid-flight, over the block-paged KV pool with "
             "--kv-pool-blocks, else over a dense SLOTS x "
             "--continuous-max-seq cache (0 = disabled)",
    )
    ap.add_argument(
        "--continuous-chunk", type=int, default=16,
        help="decode steps per device round trip when no prompt is pending",
    )
    ap.add_argument(
        "--continuous-max-seq", type=int, default=None, metavar="N",
        help="per-slot KV budget (prompt + generated tokens per request; "
             "default: the model's max_seq_len)",
    )
    ap.add_argument(
        "--kv-pool-blocks", type=int, default=None, metavar="N",
        help="block-paged KV for --continuous: a shared pool of N blocks "
             "(engine/paged.py); admission waits when the pool is full",
    )
    ap.add_argument(
        "--kv-block-size", type=int, default=16,
        help="tokens per KV pool block (with --kv-pool-blocks)",
    )
    ap.add_argument(
        "--continuous-lag", type=int, default=2,
        help="launches in flight before blocking on the oldest fetch",
    )
    ap.add_argument(
        "--restart-budget", type=int, default=3, metavar="N",
        help="continuous-scheduler supervisor: how many CONSECUTIVE "
             "crashes to absorb (restart + re-admit in-flight requests "
             "as continuation prefills) before declaring the fleet dead; "
             "a healthy fetch resets the window",
    )
    ap.add_argument(
        "--poison-strikes", type=int, default=2, metavar="K",
        help="quarantine a request implicated in K consecutive "
             "scheduler crash-restarts (error_type 'poison'), instead of "
             "letting it take the fleet down with it",
    )
    ap.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="arm the deterministic fault-injection harness "
             "(utils/faults.py), e.g. 'decode_launch:transient:on=3'; "
             "the DLI_FAULTS env var is the config-file-free spelling. "
             "Chaos drills only — never in front of real traffic",
    )
    args = ap.parse_args(argv)
    if args.kv_pool_blocks is not None and args.continuous <= 0:
        raise SystemExit("--kv-pool-blocks requires --continuous")
    from ..utils import faults as _faults

    if args.faults:
        try:
            _faults.arm(args.faults)
        except ValueError as e:
            raise SystemExit(f"--faults: {e}") from e
        print(f"fault injection armed: {args.faults}")
    elif _faults.arm_from_env() is not None:
        print("fault injection armed from DLI_FAULTS")

    tokenizer = None
    if args.tokenizer:
        from ..utils.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer, strict=True)
    engine = create_engine(
        args.model,
        engine_cfg=EngineConfig(request_deadline_s=args.deadline),
        dtype=args.dtype,
        quant=args.quant,
        kv_quant=args.kv_quant,
        attn_impl=args.attn_impl,
        tokenizer=tokenizer,
        seed=args.seed,
        device=args.device,
    )
    continuous = None
    if args.continuous > 0:
        from ..engine.continuous import ContinuousEngine

        continuous = ContinuousEngine(
            engine, n_slots=args.continuous, chunk_steps=args.continuous_chunk,
            chunk_lag=args.continuous_lag, slot_max_seq=args.continuous_max_seq,
            kv_pool_blocks=args.kv_pool_blocks, kv_block_size=args.kv_block_size,
            restart_budget=args.restart_budget, poison_strikes=args.poison_strikes,
        )
    InferenceServer(
        engine, args.host, args.port, args.max_tokens_cap,
        drain_deadline_s=args.drain_deadline,
        wedge_unready_s=args.wedge_unready, continuous=continuous,
    ).serve_forever()


if __name__ == "__main__":
    main()
