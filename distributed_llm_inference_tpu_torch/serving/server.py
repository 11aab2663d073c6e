"""HTTP serving surface of the PyTorch port (the solo path of the JAX
package's serving/server.py).

Routes: `POST /generate` (one "prompt", or a "prompts" list served as one
left-padded batch), `POST /v1/completions`, `POST /v1/chat/completions`,
`GET /v1/models`, `GET /health`, `GET /ready`, `GET /workers` (the
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
supervisor. `--prefix-cache N` gives the paged fleet its block-prefix
cache and, unless `--no-kv-shadow`, the KV shadow (warm crash recovery
and "swap" resumes; `--restore-dir DIR` persists it across a drain,
`--kv-disk-dir DIR` adds the disk tier); `/stats` then carries
`continuous.prefix_cache` and `continuous.shadow`. With the shadow on, the
cross-replica KV fabric (serving/kv_fabric.py) serves the fleet's chains
on `GET /kv/{digest}` (whole, or streamed with `X-KV-Stream: 1`) and takes
a peer's pushed chain on `POST /kv`; `/generate` honors a router's
`X-KV-Transfer-Peer` / `X-KV-Transfer-Digest` hint (the admission pulls
the chain) and `X-KV-Prefill-Only` / `X-KV-Push-To` (phase 1 of a
prefill->decode handoff), and `/health` carries a `kv` residency block
(`--no-kv-fabric` turns all of it off). On `--continuous` a single-prompt
`"stream": true` request answers an NDJSON stream (`{"delta": ...}` lines,
then the envelope with `"done": true`); a client that goes away mid-stream
cancels its request, which frees its slot and blocks at the next launch
boundary. The OpenAI routes (serving/openai_api.py): `GET /v1/models`,
`POST /v1/completions` and `/v1/chat/completions`, unstreamed or as SSE
(real deltas on `--continuous`, one emulated chunk otherwise). Runtime
LoRA adapters (engine/adapters.py): `--adapter-slots S` reserves S pool
pages beside the base weights on the paged fleet, `--adapter NAME=DIR`
registers a PEFT directory at start, and a request picks one by
`"adapter"` on `/generate` or `"model"` on the OpenAI routes (an unknown
name is a 400; `/v1/models` lists them); `--lora DIR` merges one adapter
into the weights at load instead. The solo engine's features: a
`/generate` request's `"num_beams"` (with `length_penalty`,
`early_stopping`) runs beam search and `"speculative": true` greedy
speculation (through `--draft-model NAME`'s chain when one is attached,
else prompt-lookup n-grams); an OpenAI completion with `echo`, `logprobs`
and `max_tokens: 0` scores the prompt teacher-forced (at most four
scorers at once, a fifth gets 429); `--prefix-cache N` without a pool
gives the solo engine and the dense fleet their prefix snapshots
(engine/prefix.py). `--queue N` (with `--queue-max-batch`,
`--queue-wait-ms`) puts the bounded batching queue (serving/queue.py) in
front of the solo engine: the ladder is fleet > queue > engine, a full
queue answers 429 with Retry-After and `/stats` carries `queue`. Every
request records a `replica.request` span (its envelope's stage timings as
`stage.*` children; fabric pulls, pushes and serves as `fabric.*` /
`kv.serve`) into the engine's trace store (serving/trace_store.py) under
its inbound `traceparent`: `GET /debug/traces` lists the trace ids,
`GET /debug/traces/{id}` returns one trace's spans and tree (the replica
router, serving/router.py, merges every replica's into one), and
`?format=chrome` emits it as Chrome trace-event JSON. `--trace-sample-rate
F` adds one `launch.mixed` / `launch.chunk` span per fleet launch to that
fraction of traces. `--compile-cache DIR` builds and loads the CUDA
kernels' libraries under DIR instead of `build/`, so restarted or spawned
replicas reuse them.

    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --attn-impl auto
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024 --prefix-cache 8 --restore-dir warm/
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024 --prefix-cache 8 --replica-class decode \\
        --port 5001
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --quant int4 --kv-quant int8 --continuous 8 --kv-pool-blocks 513 \\
        --kv-block-size 16 --continuous-max-seq 1024
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --continuous-max-seq 1024
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024 --warmup --tenant-weight a=3
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --continuous-max-seq 1024 --adapter-slots 4 --adapter-rank 8 \\
        --adapter tuned=adapters/tuned --adapter chat=adapters/chat
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --queue 16 --queue-max-batch 8 --queue-wait-ms 5 --prefix-cache 4
    python -m distributed_llm_inference_tpu_torch.serving.server \\
        --model tinyllama-1.1b --dtype bfloat16 --attn-impl auto \\
        --continuous 8 --kv-pool-blocks 513 --kv-block-size 16 \\
        --prefix-cache 8 --trace-sample-rate 1.0 --compile-cache build/
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

from . import kv_fabric as kvf
from .trace_store import assemble_tree, span_tree_total, to_chrome_trace

__version__ = "torch_port_v1"

DEFAULT_MAX_TOKENS = 20
DEFAULT_TEMPERATURE = 0.7
DEFAULT_TOP_K = 50
DEFAULT_TOP_P = 0.9
# Retry-After (seconds) sent with every drain/overload rejection
RETRY_AFTER_S = 2
_KNOWN_ROUTES = frozenset((
    "/", "/health", "/ready", "/workers", "/stats", "/metrics", "/v1/models",
    "/generate", "/v1/completions", "/v1/chat/completions",
    "/profiler/start", "/profiler/stop", "/debug/traces", "/debug/flight",
))


def _route_label(path: str) -> str:
    if path == "/kv" or path.startswith("/kv/"):
        return "/kv"  # one label for every digest (bounded cardinality)
    if path.startswith("/debug/traces"):
        return "/debug/traces"  # one label for every trace id
    return path if path in _KNOWN_ROUTES else "other"


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
                 profiler: Optional[_Profiler] = None, queue=None):
    from ..utils.logging import request_id_context
    from ..utils.tracing import (
        SpanContext,
        new_request_id,
        parse_traceparent,
        sanitize_request_id,
    )
    from . import openai_api as oai

    if state is None:  # embedding callers without an InferenceServer
        state = _ServerState()
    profiler = profiler or _Profiler()
    started_at = int(time.time())
    slo_classes = {c[0] for c in engine.engine_cfg.slo_classes}
    # the runtime LoRA pool (engine/adapters.py), if configured: requests
    # pick a registered adapter by name (`adapter` on /generate, `model` on
    # the OpenAI routes); an unknown name is a 400 here, before admission
    adapters = getattr(engine, "adapters", None)
    http_requests = engine.metrics.counter(
        "dli_http_requests_total", "HTTP responses",
        ("route", "method", "status"),
    )
    # scoring is not a generation and bypasses the fleet / queue ladder, so
    # it has its own bound: past four concurrent scorers a request is shed
    # with 429 instead of piling threads on the engine lock
    score_slots = threading.BoundedSemaphore(4)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # serving logs are structured
            pass

        _rid: Optional[str] = None
        _trace_ctx = None

        def _count(self, code: int):
            path = self.path.split("?")[0].rstrip("/") or "/"
            http_requests.labels(
                route=_route_label(path), method=self.command, status=str(code),
            ).inc()

        def _send(self, code: int, payload: Any, content_type="application/json",
                  headers=None):
            body = (
                payload if isinstance(payload, bytes)
                else payload.encode() if isinstance(payload, str)
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
                out = {
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
                }
                if continuous is not None and continuous.fabric_serving:
                    # residency bootstrap: resident chain digests (MRU
                    # first, capped by --kv-health-digests), so a router can
                    # steer fabric pulls here without having routed traffic
                    out["kv"] = {
                        "fabric": True,
                        "block_size": continuous.kv_block_size,
                        "resident_digests": continuous.fabric_digests(),
                    }
                self._send(200, out)
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
            elif path == "/v1/models":
                self._send(200, oai.models_response(
                    engine.cfg.name, started_at,
                    adapters=adapters.names() if adapters else ()))
            elif path == "/debug/flight":
                # the ring the fleet's supervisor dumps on a crash
                self._send(200, engine.flight.dump())
            elif path == "/debug/traces" or path.startswith("/debug/traces/"):
                self._serve_traces(path)
            elif path == "/stats":
                s = engine.stats()
                if continuous is not None:
                    s["continuous"] = continuous.stats()
                if queue is not None:
                    s["queue"] = {"depth": queue.depth(),
                                  "coalesced_batches": queue.coalesced_batches}
                self._send(200, s)
            elif path == "/metrics":
                self._send(200, engine.metrics.render(),
                           content_type="text/plain; version=0.0.4; charset=utf-8")
            elif path.startswith("/kv/"):
                self._serve_kv(path[len("/kv/"):])
            else:
                self._send(404, {"error": f"no route {path}"})

        def _serve_traces(self, path: str):
            """This process's span store: the bare route lists the known
            trace ids; /debug/traces/{id} returns that trace's spans plus
            the locally assembled tree (the router concatenates the flat
            `spans` lists of every replica into the cross-process view);
            ?format=chrome emits Chrome trace-event JSON for Perfetto."""
            store = getattr(engine, "trace_store", None)
            if store is None:
                self._send(404, {"error": "no trace store"})
                return
            trace_id = path[len("/debug/traces/"):] if path.startswith(
                "/debug/traces/") else ""
            if not trace_id:
                self._send(200, {"traces": store.trace_ids(), "stats": store.stats()})
            elif "format=chrome" in self.path.partition("?")[2]:
                self._send(200, to_chrome_trace(store.get(trace_id)))
            else:
                spans = store.get(trace_id)
                tree = assemble_tree(spans)
                self._send(200, {
                    "trace_id": trace_id,
                    "service": store.service,
                    "spans": spans,
                    "tree": tree,
                    "total_s": round(span_tree_total(tree), 6),
                })

        def _serve_kv(self, digest: str):
            """GET /kv/{digest}, the fabric's serving half: the resident
            shadow chain ending at this chunk digest, wire-encoded, whole
            or (X-KV-Stream: 1) as lazily encoded one-block frames. A miss
            (unknown digest, evicted, or no fabric) is a 404 the fetching
            peer treats as "prefill locally". Its X-Request-Id is echoed."""
            self._rid = sanitize_request_id(self.headers.get("X-Request-Id"))
            ctx = self._trace_ctx = parse_traceparent(self.headers.get("traceparent"))
            t0 = time.time()
            tier = (continuous.fabric_digest_tier(digest)
                    if continuous is not None else None) or "host"
            miss = {"error": f"no resident chain for digest {digest[:64]!r}"}

            def serve_span(hit: bool, streamed: bool):
                # the serve joins the puller's trace under its fabric.pull
                if ctx is not None:
                    engine.trace_store.add_span(
                        ctx.trace_id, "kv.serve", t0, time.time(),
                        parent_id=ctx.span_id,
                        attrs={"digest": digest[:16], "hit": hit,
                               "streamed": streamed, "tier": tier})

            if (continuous is not None
                    and self.headers.get("X-KV-Stream") in ("1", "true")):
                res = continuous.fabric_chain_stream(digest)
                serve_span(res is not None, True)
                if res is None:
                    self._send(404, miss)
                    return
                n_chunks, tier, frames = res
                # no Content-Length: frames go out as they encode
                self._count(200)
                self.send_response(200)
                self.send_header("Content-Type", kvf.STREAM_CONTENT_TYPE)
                self.send_header("X-KV-Block-Size", str(continuous.kv_block_size))
                self.send_header("X-KV-Chain-Len", str(n_chunks))
                self.send_header("X-KV-Tier", tier)
                if self._rid:
                    self.send_header("X-Request-Id", self._rid)
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for frame in frames:
                        self.wfile.write(frame)
                    self.wfile.flush()
                except OSError:
                    pass  # the peer gave up mid-pull: its problem only
                return
            chain = continuous.fabric_chain(digest) if continuous is not None else None
            serve_span(chain is not None, False)
            if chain is None:
                self._send(404, miss)
            else:
                self._send(200, chain, content_type="application/octet-stream",
                           headers={"X-KV-Block-Size": str(continuous.kv_block_size),
                                    "X-KV-Tier": tier})

        def _kv_headers(self) -> tuple:
            """(kv_hint, prefill_only, kv_push_to): a router's
            disaggregation headers. X-KV-Transfer-Peer and
            X-KV-Transfer-Digest name where this prompt's prefix chain is
            resident (the fleet pulls it at admission); X-KV-Prefill-Only
            marks phase 1 of a prefill->decode handoff (prefill, shadow
            flush, one token); X-KV-Push-To names the decode replica that
            phase 1 pushes the finished chain to. No-ops without
            --continuous."""
            peer = self.headers.get("X-KV-Transfer-Peer")
            digest = self.headers.get("X-KV-Transfer-Digest")
            hint = ({"peer": peer, "digest": digest}
                    if continuous is not None and peer and digest else None)
            prefill_only = (continuous is not None
                            and self.headers.get("X-KV-Prefill-Only") in ("1", "true"))
            push_to = self.headers.get("X-KV-Push-To") if prefill_only else None
            return hint, prefill_only, push_to

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

        # -- the OpenAI routes (serving/openai_api.py) -----------------------

        def _run_single(self, prompt: str, kwargs: dict) -> dict:
            """One prompt through the dispatch ladder of /generate and the
            OpenAI routes: the continuous fleet > the bounded queue > the
            solo engine, under a `replica.request` span. The finished
            envelope's contiguous stage timings become its child spans, and
            the child context rides kwargs into the fleet, so its fabric and
            launch spans nest under the same parent."""
            ctx = self._trace_ctx
            store = getattr(engine, "trace_store", None)
            if ctx is None or store is None:  # embedding callers
                kwargs["trace_ctx"] = ctx
                return self._dispatch(prompt, kwargs)
            with store.span("replica.request", ctx,
                            attrs={"request_id": kwargs.get("request_id")}) as sp:
                kwargs["trace_ctx"] = ctx.child(sp["span_id"])
                result = self._dispatch(prompt, kwargs)
                sp["attrs"]["status"] = result.get("status")
                self._stage_spans(store, sp, result)
            return result

        def _dispatch(self, prompt: str, kwargs: dict) -> dict:
            if continuous is not None:
                return continuous.submit(prompt, **kwargs)
            if queue is not None:
                return queue.submit(prompt, **kwargs)
            kwargs.pop("trace_ctx", None)  # the solo engine takes none
            return engine.generate(prompt, **kwargs)

        @staticmethod
        def _stage_spans(store, parent: dict, result: dict):
            """Re-export the envelope's contiguous `timings` (spans sum to
            about total_s by construction) as `stage.<name>` children of
            `parent`, laid end to end from its start. A no-op for an
            envelope without timings."""
            timings = result.get("timings")
            if not isinstance(timings, dict):
                return
            t = parent["t0"]
            for key, dur in timings.items():
                if key == "total_s" or not key.endswith("_s"):
                    continue
                try:
                    dur = float(dur)
                except (TypeError, ValueError):
                    continue
                store.add_span(parent["trace_id"], f"stage.{key[:-2]}", t, t + dur,
                               parent_id=parent["span_id"])
                t += dur

        def _run_batch(self, prompts: list, kwargs: dict) -> dict:
            """A client batch: through the queue's backpressure when there
            is one (dispatched as its own batch), else the solo engine."""
            for k in ("kv_hint", "prefill_only", "kv_push_to", "trace_ctx"):
                kwargs.pop(k, None)  # the solo batch has no fabric
            if queue is not None:
                return queue.submit_batch(prompts, **kwargs)
            return engine.generate_batch(prompts, **kwargs)

        def _stream_span(self, kwargs: dict):
            """Open the `replica.request` span of a STREAMED request and
            thread its child context into kwargs. The span outlives this
            frame: _write_stream, which owns it from here, ends it."""
            ctx = self._trace_ctx
            store = getattr(engine, "trace_store", None)
            if ctx is None or store is None:
                kwargs["trace_ctx"] = ctx
                return None
            sp = store.start_span("replica.request", ctx, attrs={
                "request_id": kwargs.get("request_id"), "stream": True,
            })
            kwargs["trace_ctx"] = ctx.child(sp["span_id"])
            return sp

        def _write_stream(self, payloads, events, sp=None):
            """Write a stream's payloads as its events come, never under
            the fleet's lock (the worker only puts events on a queue). A
            client gone mid-stream closes the event generator, which
            cancels the request: its slot and blocks free at the next
            launch boundary instead of after its whole budget. Ends the
            stream's span `sp` on every exit."""
            try:
                for payload in payloads:
                    self.wfile.write(payload)
                    self.wfile.flush()
            except OSError:
                events.close()
            finally:
                if sp is not None:
                    engine.trace_store.end_span(sp)

        def _stream_headers(self, content_type: str, extra=None):
            self._count(200)
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            if self._rid:
                self.send_header("X-Request-Id", self._rid)
            if self._trace_ctx is not None:
                self.send_header("X-Trace-Id", self._trace_ctx.trace_id)
            self.end_headers()

        def _openai_stream(self, prompt: str, kwargs: dict, chat: bool):
            """SSE: real per-launch deltas on --continuous, one emulated
            chunk otherwise (still valid SSE for OpenAI-SDK clients)."""
            sp = None
            if continuous is not None:
                # the emulation below records its span through _run_single
                sp = self._stream_span(kwargs)
                events = continuous.stream(prompt, **kwargs)
            else:
                def _one_shot():
                    result = self._run_single(prompt, kwargs)
                    if result.get("status") == "success":
                        yield {"delta": result.get("response", "")}
                    yield {**result, "done": True}

                events = _one_shot()
            self._stream_headers("text/event-stream", {"Cache-Control": "no-cache"})
            self._write_stream(
                (payload for payload, _final in
                 oai.stream_events(events, engine.cfg.name, kwargs, chat=chat)),
                events, sp)

        def _openai(self, path: str, data: dict):
            chat = path == "/v1/chat/completions"
            envelope = None  # the engine envelope carrying request_id/timings
            try:
                if chat:
                    prompt, kwargs, meta = oai.parse_chat(
                        data, engine.render_chat, max_tokens_cap)
                    prompts = [prompt]
                else:
                    prompts, kwargs, meta = oai.parse_completion(data, max_tokens_cap)
                if (kwargs.get("slo_class") is not None
                        and kwargs["slo_class"] not in slo_classes):
                    raise oai.OpenAIError(
                        f"unknown slo_class {kwargs['slo_class']!r}; "
                        f"configured: {sorted(slo_classes)}", param="slo_class")
                req_model = data.get("model")
                if (adapters is not None and isinstance(req_model, str) and req_model
                        and req_model != engine.cfg.name):
                    # `model` names a registered runtime adapter (the base
                    # model's own name keeps meaning the base). With a pool,
                    # an unknown id is the caller's error, never a silent
                    # base fallback; without one `model` stays informational
                    if not adapters.is_registered(req_model):
                        raise oai.OpenAIError(
                            f"model {req_model!r} is neither the base model "
                            f"{engine.cfg.name!r} nor a registered adapter; "
                            f"see GET /v1/models", param="model")
                    kwargs["adapter"] = req_model
                hdr_dl = self.headers.get("X-Request-Deadline-Ms")
                if hdr_dl is not None:
                    # a router's relay of the remaining budget wins
                    try:
                        kwargs["deadline_ms"] = float(hdr_dl)
                    except (TypeError, ValueError):
                        pass
                kwargs["request_id"] = self._rid
                kv_hint, prefill_only, kv_push_to = self._kv_headers()
                if kv_hint is not None:
                    kwargs["kv_hint"] = kv_hint
                if prefill_only:
                    # handoff phase 1 is never streamed (the decode replica
                    # streams phase 2)
                    kwargs["prefill_only"] = True
                    meta["stream"] = False
                    if kv_push_to:
                        kwargs["kv_push_to"] = kv_push_to
                if meta.get("echo_score"):
                    # echo + logprobs + max_tokens=0: teacher-forced
                    # scoring of the prompt itself (the lm-eval pattern)
                    if not score_slots.acquire(blocking=False):
                        raise oai.OpenAIError(
                            "too many concurrent scoring requests",
                            status=429, err_type="overloaded_error")
                    try:
                        result = engine.score(prompts[0],
                                              top_n=meta.get("score_top_n", 0))
                    finally:
                        score_slots.release()
                    if result.get("status") != "success":
                        raise oai.error_for_envelope(result)
                    self._send(200, oai.echo_score_response(result, engine.cfg.name))
                    return
                if meta["stream"]:
                    if len(prompts) != 1:
                        raise oai.OpenAIError("streaming requires a single prompt",
                                              param="stream")
                    self._openai_stream(prompts[0], kwargs, chat=chat)
                    return
                n = meta.get("n", 1)
                if n > 1:
                    # n choices = one batch of the same prompt (categorical
                    # draws are independent per row)
                    prompts = prompts * n
                if len(prompts) == 1:
                    result = self._run_single(prompts[0], kwargs)
                    if result.get("status") != "success":
                        raise oai.error_for_envelope(result)
                    entries = [result]
                    envelope = result
                else:
                    if kwargs.get("logprobs"):
                        raise oai.OpenAIError(
                            "logprobs requires a single string prompt",
                            param="logprobs")
                    batch = self._run_batch(prompts, kwargs)
                    if batch.get("status") != "success":
                        raise oai.error_for_envelope(batch)
                    entries = batch["results"]
                    envelope = batch
            except oai.OpenAIError as e:
                self._send(e.status, e.body)
                return
            except (TypeError, ValueError) as e:
                # any param-shape error that escaped the parsers is a 400
                self._send(400, oai.OpenAIError(f"bad parameter: {e}").body)
                return
            build = oai.chat_response if chat else oai.completion_response
            # the KV fabric's fields ride the OpenAI envelope as extension keys
            kv_extra = {k: envelope[k] for k in ("kv_digests", "kv_fabric_blocks",
                                                 "kv_promoted_blocks", "prefill_only",
                                                 "kv_pushed") if k in envelope}
            # an adapter-resolved request echoes the adapter id as its model
            # (the vLLM convention): the id the client asked for
            self._send(200, build(
                entries, kwargs.get("adapter") or engine.cfg.name, kwargs,
                prompt_once=meta.get("n", 1) > 1,
                request_id=envelope.get("request_id", self._rid),
                timings=envelope.get("timings"), kv_extra=kv_extra or None,
                trace_id=(self._trace_ctx.trace_id
                          if self._trace_ctx is not None else None)))

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
            if state.draining and path in ("/generate", "/v1/completions",
                                           "/v1/chat/completions"):
                self._send(
                    503,
                    {"error": "Error: server draining", "status": "failed",
                     "error_type": "draining"},
                    headers={"Retry-After": str(RETRY_AFTER_S)},
                )
                return
            if path in ("/v1/completions", "/v1/chat/completions"):
                data = self._read_json()
                if data is not None:
                    self._openai(path, data)
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
            if path == "/kv":
                self._accept_kv_push()
                return
            if path != "/generate":
                self._send(404, {"error": f"no route {path}"})
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

        def _accept_kv_push(self):
            """POST /kv, the fabric's push half: a peer's chain at the
            prefill->decode handoff, validated against its OWN content key
            and this pool's layout, landed in the host shadow tier. A
            payload that fails is a 400 the pusher treats as "the pull
            fallback will cover it"."""
            if continuous is None or not continuous.fabric_serving:
                self._send(404, {"error": "kv fabric not serving"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = 0
            if length <= 0:
                self._send(400, {"error": "empty /kv push"})
                return
            res = continuous.fabric_accept_push(self.rfile.read(length))
            if res is None:
                self._send(400, {"error": "push payload failed content-key validation"})
            else:
                self._send(200, res)

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
                # the request's rows ride the named adapter's pool page; the
                # base model's own name means no adapter, so a caller may
                # pass its model id unconditionally
                if not isinstance(raw_adapter, str):
                    raise ValueError("adapter must be a string")
                if adapters is None:
                    raise ValueError(
                        "adapter serving is not configured: start with "
                        "--adapter-slots (and --continuous + --kv-pool-blocks)"
                    )
                if not adapters.is_registered(raw_adapter):
                    raise ValueError(
                        f"unknown adapter {raw_adapter!r}; registered: "
                        f"{adapters.names()}"
                    )
                kwargs["adapter"] = raw_adapter
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
            kv_hint, prefill_only, kv_push_to = self._kv_headers()
            if kv_hint is not None:
                kwargs["kv_hint"] = kv_hint
            if prefill_only:
                # handoff phase 1: prefill, shadow flush, one token; the
                # body's stream flag is ignored (the decode replica streams)
                kwargs["prefill_only"] = True
                if kv_push_to:
                    kwargs["kv_push_to"] = kv_push_to
            if not prefill_only and _parse_bool(data.get("stream", False), "stream"):
                # NDJSON: one {"delta": ...} line per fetched launch that
                # adds text, then the envelope with "done": true. The solo
                # engine decodes a whole request per call: nothing to stream
                if continuous is None or prompts is not None:
                    self._send(400, {"error": "streaming requires --continuous "
                                     "and a single 'prompt'"})
                    return None
                kwargs["debug"] = _parse_bool(data.get("debug", False), "debug")
                kwargs["speculative"] = _parse_bool(
                    data.get("speculative", False), "speculative")
                kwargs["logprobs"] = _parse_bool(data.get("logprobs", False), "logprobs")
                self._stream_headers("application/x-ndjson")
                sp = self._stream_span(kwargs)
                events = continuous.stream(prompt, **kwargs)
                self._write_stream((json.dumps(ev).encode() + b"\n" for ev in events),
                                   events, sp)
                return None
            if prompts is not None:
                # batched form: "prompts": [...] -> one batch, N results
                if not isinstance(prompts, list):
                    raise ValueError("prompts must be a list of strings")
                if kwargs.get("logit_bias"):
                    raise ValueError("logit_bias requires a single 'prompt'")
                if kwargs.get("num_beams", 1) > 1:
                    raise ValueError("num_beams requires a single 'prompt'")
                return self._run_batch(prompts, kwargs)
            kwargs["debug"] = _parse_bool(data.get("debug", False), "debug")
            kwargs["speculative"] = _parse_bool(
                data.get("speculative", False), "speculative"
            )
            kwargs["logprobs"] = _parse_bool(data.get("logprobs", False), "logprobs")
            return self._run_single(prompt, kwargs)

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
                 wedge_unready_s: float = 10.0, continuous=None, queue=None):
        self.engine = engine
        self.continuous = continuous
        self.queue = queue
        self.drain_deadline_s = float(drain_deadline_s)
        self.state = _ServerState()
        self.httpd = ThreadingHTTPServer(
            (host, port),
            make_handler(engine, max_tokens_cap, state=self.state,
                         wedge_unready_s=wedge_unready_s,
                         continuous=continuous, queue=queue),
        )
        self.port = self.httpd.server_address[1]

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Graceful drain: flip readiness (new requests get 503 +
        Retry-After), let queued and in-flight work finish up to the
        deadline, then stop the HTTP server. The order: the front door
        first (no new admissions), then the batching layers (their own
        queues: the fleet, the queue), then the engine's in-flight lock."""
        deadline = self.drain_deadline_s if deadline_s is None else float(deadline_s)
        t0 = time.time()
        self.state.draining = True
        ok = True

        def left() -> float:
            return max(0.0, deadline - (time.time() - t0))

        if self.continuous is not None:
            ok = self.continuous.drain(left()) and ok
        if self.queue is not None:
            ok = self.queue.drain(left()) and ok
        ok = self.engine.drain(left()) and ok
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
                    "/metrics", "/profiler/*", "/debug/traces", "/debug/flight",
                    "/kv"],
        )
        print(f"serving on :{self.port} — /generate /health /ready /workers /stats "
              f"/metrics /profiler/* /debug/traces /debug/flight /kv")
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.queue is not None:
            self.queue.close()
        if self.continuous is not None:
            self.continuous.close()


def _close_backend(engine):
    """Join a mesh backend's rank processes (a single device has none)."""
    close = getattr(engine.backend, "close", None)
    if close is not None:
        close()


def _parse_tenant_weights(specs) -> tuple:
    """--tenant-weight NAME=W values as EngineConfig.tenant_weights, with
    the JAX server's parse errors."""
    out = []
    for spec in specs or ():
        name, sep, w = spec.partition("=")
        if not sep or not name:
            raise SystemExit(f"--tenant-weight {spec!r}: expected NAME=WEIGHT")
        try:
            out.append((name, float(w)))
        except ValueError:
            raise SystemExit(f"--tenant-weight {spec!r}: WEIGHT must be a number") from None
    return tuple(out)


def _wedge_reaper(engine, limit_s: float):
    """--die-on-wedge: exit with code 17 once an abandoned deadline-overrun
    call has been stuck longer than limit_s (a restart is the only real
    recovery from a wedged device)."""
    while True:
        time.sleep(max(1.0, min(limit_s / 4, 10.0)))
        age = engine.max_wedged_age()
        if age is not None and age > limit_s:
            print(f"wedged device call stuck {age:.0f}s > --die-on-wedge "
                  f"{limit_s:g}s; exiting for a supervisor restart", flush=True)
            os._exit(17)


# every tokenizer format the converter carries into a store: BPE json,
# config, GPT-2 vocab / merges, and sentencepiece .model
_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "vocab.json", "tokenizer.model",
)


def _has_tokenizer_files(path: str) -> bool:
    import os

    return any(os.path.exists(os.path.join(path, f)) for f in _TOKENIZER_FILES)


def _load_checkpoint(args):
    """(cfg, params) for --checkpoint: a local store dir (manifest.json,
    models/checkpoint.py) or a HF checkpoint dir (config.json +
    safetensors, models/convert.py). A --dtype that conflicts with a
    store's recorded dtype is refused; an HF directory converts to --dtype
    (default bfloat16). Anything else exits."""
    import os

    path = args.checkpoint
    if os.path.exists(os.path.join(path, "manifest.json")):
        from ..models.checkpoint import load_params

        cfg, params = load_params(path)
        if args.dtype and args.dtype != cfg.dtype:
            raise SystemExit(
                f"--dtype {args.dtype} conflicts with the checkpoint's "
                f"recorded dtype {cfg.dtype!r}; re-convert with --dtype "
                f"{args.dtype} instead"
            )
        return cfg, params
    if os.path.exists(os.path.join(path, "config.json")):
        from ..models.convert import load_hf_checkpoint

        return load_hf_checkpoint(path, dtype=args.dtype or "bfloat16")
    raise SystemExit(
        f"--checkpoint {path}: neither a local store (manifest.json) nor "
        f"a HF checkpoint dir (config.json + *.safetensors)"
    )


def main(argv: Optional[list] = None):
    from ..config import EngineConfig, MeshConfig
    from ..runtime import create_engine

    ap = argparse.ArgumentParser(
        description="distributed_llm_inference_tpu_torch server (PyTorch port)"
    )
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="serve real weights: a local checkpoint store dir "
             "(models/checkpoint.py; produced by `python -m "
             "distributed_llm_inference_tpu_torch.models.convert`) or a "
             "HuggingFace checkpoint dir (config.json + *.safetensors). "
             "Overrides --model; tokenizer files in DIR are loaded strictly",
    )
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
        "--prefix-cache", type=int, default=0, metavar="N",
        help="block-prefix cache of the paged fleet (engine/block_prefix.py, "
             "needs --continuous and --kv-pool-blocks): a request whose "
             "prompt head matches a cached chain of full blocks maps them "
             "and prefills only its tail; without a pool, the solo engine's "
             "and the dense fleet's N prompt-prefix snapshots "
             "(engine/prefix.py), spliced back on a hit",
    )
    ap.add_argument(
        "--restore-dir", default=None, metavar="DIR",
        help="warm-state persistence for the paged fleet (engine/shadow.py): "
             "a graceful drain (SIGTERM) saves the shadowed KV blocks and "
             "their block-prefix chains here, and startup restores them "
             "into the fresh pool, so the fleet rejoins with a WARM prefix "
             "cache (needs --prefix-cache > 0); a crash writes "
             "flight_crash.json here",
    )
    ap.add_argument(
        "--no-kv-shadow", action="store_true",
        help="disable the warm-recovery shadow store (supervisor restarts "
             "and --restore-dir starts then recover cold, re-prefilling "
             "every salvaged request from its full prompt)",
    )
    ap.add_argument(
        "--kv-disk-dir", default=None, metavar="DIR",
        help="disk tier of the KV cache hierarchy: LRU-evicted host-shadow "
             "entries demote into parent-chained chunk files here instead "
             "of dropping, and admission promotes a chain back out. "
             "Default: no disk tier",
    )
    ap.add_argument(
        "--kv-disk-blocks", type=int, default=0, metavar="N",
        help="disk-tier bound in blocks (chunk files, LRU). 0 = auto: 8x "
             "the host shadow tier",
    )
    ap.add_argument(
        "--replica-class", default="mixed", choices=["mixed", "prefill", "decode"],
        help="disaggregation class for a router: 'prefill' replicas take "
             "fresh long-prompt work and hand the finished prefix to a "
             "'decode' replica by chunk digest over the KV fabric; 'mixed' "
             "(default) serves everything. The engine is the same: this "
             "labels /health and the dli_kv_fabric_* metrics' role",
    )
    ap.add_argument(
        "--no-kv-fabric", action="store_true",
        help="disable the cross-replica KV fabric (GET /kv/{digest}, POST "
             "/kv, the X-KV-Transfer-* fetch hints and /health's kv block); "
             "the shadow stays purely local",
    )
    ap.add_argument(
        "--kv-fabric-timeout", type=float, default=5.0, metavar="SECONDS",
        help="hard deadline on one fabric fetch; a dead or wedged peer costs "
             "at most this long before the admission prefills locally",
    )
    ap.add_argument(
        "--no-kv-stream", action="store_true",
        help="pull fabric chains as one whole blob instead of streamed "
             "one-block frames (which overlap the wire with the pool's "
             "scatters)",
    )
    ap.add_argument(
        "--kv-health-digests", type=int, default=64, metavar="N",
        help="cap on the resident-chain digests /health advertises for a "
             "router's residency bootstrap (MRU first, host tier before disk)",
    )
    ap.add_argument(
        "--spec-decode", action="store_true",
        help="fleet-wide speculative decoding on the chunked paged fleet: "
             "every eligible greedy slot submits draft-then-verify rows in the "
             "mixed launch (without it only requests with \"speculative\": "
             "true speculate); drafting stops under decode TPOT pressure and "
             "greedy output is unchanged",
    )
    ap.add_argument(
        "--spec-draft-len", type=int, default=4, metavar="K",
        help="drafted tokens per verify row (0 turns the fleet's speculation "
             "off)",
    )
    ap.add_argument(
        "--spec-draft-model", default=None, metavar="NAME",
        help="draft the fleet's verify rows with a small same-tokenizer "
             "model's greedy chain on the card (its own pool, the same block "
             "tables) instead of n-gram lookup",
    )
    ap.add_argument(
        "--draft-model", default=None, metavar="NAME",
        help="attach a smaller same-tokenizer model as a speculative draft: "
             "greedy requests with \"speculative\": true on the solo engine "
             "verify the draft's proposals (several tokens per target "
             "forward on text the draft predicts well)",
    )
    ap.add_argument(
        "--tenant-weight", action="append", default=None, metavar="NAME=W",
        help="per-tenant fairness weight on the continuous fleet "
             "(repeatable): within each SLO class, queued tenants split the "
             "class's token budget in proportion to their weights (unlisted "
             "tenants weigh 1.0); requests carry their tenant in 'tenant'",
    )
    ap.add_argument(
        "--tenant-queue-share", type=float, default=0.5, metavar="F",
        help="per-tenant admission-queue quota as a fraction of the "
             "continuous queue bound: one tenant's queued requests beyond "
             "max(4, F * queue-bound) shed with 429 + Retry-After; 1.0 "
             "disables the quota",
    )
    ap.add_argument(
        "--lora", default=None, metavar="DIR",
        help="PEFT-format LoRA adapter directory merged into the base "
             "weights at load (W + alpha/r * BA, before quantization): the "
             "single-adapter path, no per-step delta, but the whole server "
             "speaks that one adapter. Serve many adapters at once with "
             "--adapter-slots / --adapter instead (the same adapter cannot "
             "be used both ways)",
    )
    ap.add_argument(
        "--adapter-slots", type=int, default=0, metavar="N",
        help="runtime LoRA adapter pool (engine/adapters.py): N device "
             "pages of paged A/B factors beside the resident base weights; "
             "a request picks a registered adapter by name ('adapter' on "
             "/generate, 'model' on the OpenAI routes) and one CUDA graph "
             "per launch kind serves any adapter mix. Needs --continuous "
             "and --kv-pool-blocks (the ragged paged fleet); 0 = off",
    )
    ap.add_argument(
        "--adapter-rank", type=int, default=8, metavar="R",
        help="pool page rank: every registered adapter is zero-padded to "
             "rank R (a larger trained rank is refused at registration)",
    )
    ap.add_argument(
        "--adapter", action="append", default=None, metavar="NAME=DIR",
        help="register a PEFT-format LoRA adapter directory under NAME at "
             "start (repeatable). Needs --adapter-slots; more adapters than "
             "slots is fine: pages are refcounted and LRU-swapped on demand",
    )
    ap.add_argument(
        "--queue", type=int, default=0, metavar="N",
        help="bounded request queue of depth N in front of the solo engine "
             "(serving/queue.py): concurrent singles coalesce into "
             "left-padded batches, a full queue returns 429 (0 = disabled; "
             "not with --continuous)",
    )
    ap.add_argument(
        "--queue-max-batch", type=int, default=8,
        help="largest coalesced batch the queue's dispatcher forms",
    )
    ap.add_argument(
        "--queue-wait-ms", type=float, default=5.0,
        help="coalescing window before a batch is cut",
    )
    ap.add_argument(
        "--die-on-wedge", type=float, default=None, metavar="SECONDS",
        help="exit the process (code 17) once an abandoned deadline-overrun "
             "device call has been stuck this long, for a supervisor restart; "
             "/health reports \"degraded\" with the stuck age either way "
             "(needs --deadline)",
    )
    ap.add_argument(
        "--warmup", action="store_true",
        help="before serving, run every solo prefill bucket and decode "
             "shape once, then one request through the --continuous fleet "
             "(its launch kinds' graph captures), so the first requests pay "
             "no kernel load or capture; exits if either warmup fails",
    )
    ap.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="arm the deterministic fault-injection harness "
             "(utils/faults.py), e.g. 'decode_launch:transient:on=3'; "
             "the DLI_FAULTS env var is the config-file-free spelling. "
             "Chaos drills only — never in front of real traffic",
    )
    ap.add_argument(
        "--trace-sample-rate", type=float, default=0.0, metavar="F",
        help="fraction of traced requests that also get launch-level "
             "attribution on the continuous fleet: a sampled request's "
             "mixed launches and decode chunks record dispatch -> fetch "
             "spans (host timestamps keyed by the launch, never an extra "
             "device sync) into GET /debug/traces/{trace_id}. 0 (default) "
             "keeps the hot path allocation-free",
    )
    ap.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="directory of the CUDA kernels' built libraries (default "
             "build/ beside the package): restarted or spawned replicas "
             "pointed at one DIR reuse the libraries instead of running "
             "nvcc again",
    )
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel width (the batch-1 serving engine "
                         "needs 1, as in the JAX package)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: one rank process per stage "
                         "(parallel/pipeline.py)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks per stage")
    ap.add_argument(
        "--pp-wire-quant", default=None, choices=[None, "int8"],
        help="int8 rows + fp32 scales on every inter-stage hand-off and the "
             "last stage's broadcast (default off: the activations cross as "
             "they are)",
    )
    ap.add_argument(
        "--microbatches", type=int, default=1, metavar="M",
        help="M > 1 serves the 1F1B schedule: batched requests split into M "
             "microbatches chasing each other around the pp ring (needs "
             "--pp >= 2 and M >= pp); solo requests ride the plain ring",
    )
    ap.add_argument("--sp", type=int, default=1, help="context-parallel ring size")
    ap.add_argument(
        "--sp-strategy", default="ring", choices=["ring", "ulysses"],
        help="long-context prefill strategy over the sp axis: 'ring' (K/V "
             "rotate around the ring) or 'ulysses' (two all-to-alls re-shard "
             "sequence<->heads; needs heads divisible by sp)",
    )
    ap.add_argument("--ep", type=int, default=1, help="expert-parallel width (MoE)")
    # multi-host meshes are part C of "Multi-GPU SPMD": each of these
    # refuses anything but its default, naming the ROADMAP heading
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    from ..parallel.mesh import not_ported

    for flag, value, default in (
        ("--coordinator", args.coordinator, None),
        ("--num-processes", args.num_processes, None),
        ("--process-id", args.process_id, None),
    ):
        if value != default:
            raise SystemExit(str(not_ported(f"{flag} {value}")))
    if args.dp != 1:
        raise SystemExit("--dp > 1 is not available through the batch-1 serving "
                         "engine (as in the JAX server)")
    if args.die_on_wedge and not args.deadline:
        # checked before the model loads
        raise SystemExit(
            "--die-on-wedge needs --deadline: wedges are detected by "
            "deadline-overrun calls that never drain"
        )
    if args.continuous > 0 and args.queue > 0:
        raise SystemExit(
            "--continuous and --queue are mutually exclusive: in-flight "
            "batching already provides bounded admission + batching"
        )
    if args.kv_pool_blocks is not None and args.continuous <= 0:
        raise SystemExit("--kv-pool-blocks requires --continuous")
    if args.adapter and not args.adapter_slots:
        raise SystemExit("--adapter needs --adapter-slots N: the runtime pool's "
                         "device pages are reserved at engine build")
    if args.adapter_slots and (args.continuous <= 0 or args.kv_pool_blocks is None):
        # a pool no request could select is a misconfiguration: the adapter
        # path rides the ragged paged fleet's launches
        raise SystemExit("--adapter-slots needs --continuous SLOTS with "
                         "--kv-pool-blocks N: runtime adapters ride the ragged "
                         "paged fleet's mixed launch")
    adapter_specs = []
    for spec in args.adapter or ():
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--adapter {spec!r}: expected NAME=DIR")
        adapter_specs.append((name, path))
    tenant_weights = _parse_tenant_weights(args.tenant_weight)
    from ..utils import faults as _faults

    if args.faults:
        try:
            _faults.arm(args.faults)
        except ValueError as e:
            raise SystemExit(f"--faults: {e}") from e
        print(f"fault injection armed: {args.faults}")
    elif _faults.arm_from_env() is not None:
        print("fault injection armed from DLI_FAULTS")
    if args.compile_cache:
        # before the model loads: no kernel library is loaded yet
        from .. import kernels

        kernels.set_build_dir(args.compile_cache)

    model, params, dtype = args.model, None, args.dtype
    if args.checkpoint:
        model, params = _load_checkpoint(args)
        dtype = None  # the checkpoint's recorded dtype governs
    tokenizer = None
    tok_src = args.tokenizer or (
        args.checkpoint if args.checkpoint and _has_tokenizer_files(args.checkpoint)
        else None
    )
    if tok_src:
        from ..utils.tokenizer import load_tokenizer

        # strict: real weights through the byte fallback would answer
        # garbled text with status "success"
        tokenizer = load_tokenizer(tok_src, strict=True)
    elif args.checkpoint:
        print(
            "⚠️  --checkpoint without a tokenizer: responses will be "
            "byte-decoded. Pass --tokenizer PATH for real text."
        )
    engine = create_engine(
        model,
        engine_cfg=EngineConfig(
            request_deadline_s=args.deadline,
            prefix_cache_entries=args.prefix_cache,
            kv_shadow=not args.no_kv_shadow,
            kv_fabric=not args.no_kv_fabric,
            kv_fabric_timeout_s=args.kv_fabric_timeout,
            kv_fabric_stream=not args.no_kv_stream,
            kv_health_digests=args.kv_health_digests,
            replica_class=args.replica_class,
            kv_disk_dir=args.kv_disk_dir,
            kv_disk_blocks=args.kv_disk_blocks,
            spec_decode=args.spec_decode,
            spec_draft_len=args.spec_draft_len,
            spec_draft_model=args.spec_draft_model,
            tenant_weights=tenant_weights,
            tenant_max_queue_share=args.tenant_queue_share,
            adapter_slots=args.adapter_slots,
            adapter_rank=args.adapter_rank,
            trace_sample_rate=args.trace_sample_rate,
            pp_wire_quant=args.pp_wire_quant,
        ),
        mesh_cfg=MeshConfig(dp=args.dp, pp=args.pp, sp=args.sp, tp=args.tp,
                            ep=args.ep),
        microbatches=args.microbatches,
        sp_strategy=args.sp_strategy,
        draft_model=args.draft_model,
        lora=args.lora,
        params=params,
        dtype=dtype,
        quant=args.quant,
        kv_quant=args.kv_quant,
        attn_impl=args.attn_impl,
        tokenizer=tokenizer,
        seed=args.seed,
        device=args.device,
    )
    for name, path in adapter_specs:
        try:
            # a bad directory, a rank overflow, a shape mismatch or the
            # --lora directory itself fails the start
            engine.adapters.register(name, path)
        except (ValueError, OSError) as e:
            raise SystemExit(f"--adapter {name}={path}: {e}") from e
    if adapter_specs:
        print(f"{len(adapter_specs)} adapter(s) registered: "
              f"{', '.join(n for n, _ in adapter_specs)}", flush=True)
    if args.die_on_wedge:
        threading.Thread(target=_wedge_reaper, args=(engine, args.die_on_wedge),
                         daemon=True).start()
    if args.warmup:
        print("warming up (every solo prefill bucket and decode shape)...", flush=True)
        try:
            stats = engine.warmup()
        except ValueError as e:
            raise SystemExit(
                f"--warmup failed: {e}\nfix the engine prefill_buckets so every "
                f"bucket is servable, or start without --warmup"
            ) from e
        print(f"warm: {stats['programs']} shapes in {stats['seconds']}s", flush=True)
    continuous = None
    if args.continuous > 0:
        from ..engine.continuous import ContinuousEngine

        continuous = ContinuousEngine(
            engine, n_slots=args.continuous, chunk_steps=args.continuous_chunk,
            chunk_lag=args.continuous_lag, slot_max_seq=args.continuous_max_seq,
            kv_pool_blocks=args.kv_pool_blocks, kv_block_size=args.kv_block_size,
            restart_budget=args.restart_budget, poison_strikes=args.poison_strikes,
            restore_dir=args.restore_dir,
        )
        if args.warmup:
            w = continuous.warmup()
            if not w["ok"]:
                raise SystemExit(
                    f"--warmup failed on the continuous engine: {w}\n"
                    f"fix the configuration or start without --warmup"
                )
            print(f"continuous warm in {w['seconds']}s", flush=True)
    queue = None
    if args.queue > 0:
        from .queue import BatchingQueue

        queue = BatchingQueue(engine, max_queue=args.queue,
                              max_batch=args.queue_max_batch,
                              max_wait_ms=args.queue_wait_ms)
    try:
        InferenceServer(
            engine, args.host, args.port, args.max_tokens_cap,
            drain_deadline_s=args.drain_deadline,
            wedge_unready_s=args.wedge_unready, continuous=continuous, queue=queue,
        ).serve_forever()
    finally:
        _close_backend(engine)


if __name__ == "__main__":
    main()
