"""Bounded per-process span store and cross-process trace assembly (the
JAX package's serving/trace_store.py, copied: it imports no jax).

Each process of the fleet (the router, each replica server) keeps ONE
`TraceStore`: a thread-safe, LRU-bounded map of trace_id -> recorded
spans. Spans are plain dicts — `{"name", "trace_id", "span_id",
"parent_id", "t0", "t1", "attrs", "service"}` with wall-clock second
timestamps — so the store is JSON-dumpable as-is and the router
assembles a whole cross-process trace by concatenating the span lists
fetched from every replica's `GET /debug/traces/{trace_id}`
(serving/router.py) without any schema translation.

`start_span` / `end_span` form an acquire/release pair: every started
span is ended on all exit paths (try/finally or a transfer of
ownership). The `span()` context manager is safe by construction; the
explicit pair is for a span that outlives one frame (a streamed
request's span, closed when the stream ends). Spans measured elsewhere
(a launch-attribution record, a fabric pull) enter through `add_span`.

Export: `assemble_tree` nests spans by parent_id for the JSON debug
view; `to_chrome_trace` emits Chrome trace-event format (Perfetto-
loadable) with one pid lane per service (router / replica-N) declared by
`process_name` metadata events and every span a complete `ph:"X"` event
in microseconds.

Strictly host-side and dependency-free, like utils/metrics.py.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.tracing import SpanContext, new_span_id

# Bounds: per-process, tuned so a busy replica holds the last few
# hundred requests' spans in a few MB. Evicting is strictly LRU on
# trace_id — a trace being appended to (or read) is "recently used".
DEFAULT_MAX_TRACES = 256
DEFAULT_MAX_SPANS_PER_TRACE = 512


class TraceStore:
    """Thread-safe bounded span store for one process."""

    def __init__(
        self,
        service: str = "engine",
        max_traces: int = DEFAULT_MAX_TRACES,
        max_spans_per_trace: int = DEFAULT_MAX_SPANS_PER_TRACE,
    ):
        self.service = str(service)
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        # trace_id -> deque of finished span dicts (LRU order on the dict)
        self._traces: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self._dropped = 0  # spans lost to per-trace bound (not eviction)

    # -- recording -----------------------------------------------------------
    def start_span(
        self,
        name: str,
        ctx: SpanContext,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> dict:
        """Open a span under `ctx` (ctx.span_id is the parent). Returns
        the span dict — pass it to `end_span` on EVERY exit path. The
        open span is not visible in the store until ended."""
        return {
            "name": str(name),
            "trace_id": ctx.trace_id,
            "span_id": new_span_id(),
            "parent_id": ctx.span_id,
            "t0": time.time(),
            "t1": None,
            "attrs": dict(attrs) if attrs else {},
            "service": self.service,
        }

    def end_span(self, span: dict, attrs: Optional[Dict[str, Any]] = None):
        """Close `span` and commit it to the store. Idempotent: the first
        call sets t1 and commits; later calls only merge attrs (the store
        holds the same dict object, so they still land) — crash/cleanup
        paths may end defensively without duplicating the span."""
        if attrs:
            span["attrs"].update(attrs)
        if span.get("t1") is None:
            span["t1"] = time.time()
            self._commit(span)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        ctx: SpanContext,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        """Record a span around a block — ends on all exit paths by
        construction. Yields the open span dict so the block can attach
        attrs (`sp["attrs"]["rows"] = n`)."""
        sp = self.start_span(name, ctx, attrs)
        try:
            yield sp
        except BaseException:
            sp["attrs"]["error"] = True
            raise
        finally:
            self.end_span(sp)

    def add_span(
        self,
        trace_id: str,
        name: str,
        t0: float,
        t1: float,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
        service: Optional[str] = None,
    ) -> dict:
        """Commit a fully-formed span measured elsewhere (stage segments
        from a finished Trace, launch-attribution records). Returns the
        committed dict (its span_id can parent further spans)."""
        sp = {
            "name": str(name),
            "trace_id": trace_id,
            "span_id": span_id or new_span_id(),
            "parent_id": parent_id,
            "t0": float(t0),
            "t1": float(t1),
            "attrs": dict(attrs) if attrs else {},
            "service": service or self.service,
        }
        self._commit(sp)
        return sp

    def _commit(self, span: dict):
        tid = span["trace_id"]
        with self._lock:
            dq = self._traces.get(tid)
            if dq is None:
                dq = collections.deque(maxlen=self.max_spans_per_trace)
                self._traces[tid] = dq
            if len(dq) == dq.maxlen:
                self._dropped += 1
            dq.append(span)
            self._traces.move_to_end(tid)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    # -- reading -------------------------------------------------------------
    def get(self, trace_id: str) -> List[dict]:
        """All recorded spans for `trace_id` (chronological by record
        order), [] when unknown. Reading refreshes LRU recency — an
        operator inspecting a trace keeps it alive."""
        with self._lock:
            dq = self._traces.get(trace_id)
            if dq is None:
                return []
            self._traces.move_to_end(trace_id)
            return [dict(sp, attrs=dict(sp["attrs"])) for sp in dq]

    def trace_ids(self) -> List[str]:
        """Known trace ids, least- to most-recently used."""
        with self._lock:
            return list(self._traces.keys())

    def stats(self) -> dict:
        with self._lock:
            return {
                "service": self.service,
                "traces": len(self._traces),
                "spans": sum(len(dq) for dq in self._traces.values()),
                "max_traces": self.max_traces,
                "max_spans_per_trace": self.max_spans_per_trace,
                "spans_dropped": self._dropped,
            }


# -- assembly + export --------------------------------------------------------
def assemble_tree(spans: List[dict]) -> List[dict]:
    """Nest a flat span list (possibly concatenated from several
    processes' stores) into root trees: each node is the span dict plus a
    `children` list sorted by start time. Spans whose parent_id is
    unknown locally (the parent lives in a process that was not queried,
    or was evicted) surface as roots — partial traces degrade to a
    forest instead of vanishing."""
    by_id = {sp["span_id"]: dict(sp, children=[]) for sp in spans}
    roots: List[dict] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(nodes):
        nodes.sort(key=lambda n: (n["t0"], n["name"]))
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return roots


def span_tree_total(roots: List[dict]) -> float:
    """Wall-clock seconds covered by the trees' root spans (max end −
    min start over roots with both bounds) — the "span sum ≈ end-to-end
    wall time" acceptance check reads this."""
    t0s = [r["t0"] for r in roots if r.get("t0") is not None]
    t1s = [r["t1"] for r in roots if r.get("t1") is not None]
    if not t0s or not t1s:
        return 0.0
    return max(t1s) - min(t0s)


def to_chrome_trace(spans: List[dict]) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): one pid lane per
    service, named via `process_name` metadata events; every span a
    complete (`ph:"X"`) event with ts/dur in MICROseconds. Unfinished
    spans (t1 None — a crash mid-request) export with dur 0 and an
    `unfinished` arg rather than being dropped."""
    services = sorted({sp.get("service") or "unknown" for sp in spans})
    pid_of = {svc: i + 1 for i, svc in enumerate(services)}
    events: List[dict] = []
    for svc in services:
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid_of[svc],
            "tid": 0,
            "args": {"name": svc},
        })
        events.append({
            "name": "process_sort_index",
            "ph": "M",
            "pid": pid_of[svc],
            "tid": 0,
            "args": {"sort_index": pid_of[svc]},
        })
    for sp in sorted(spans, key=lambda s: s["t0"]):
        t1 = sp.get("t1")
        args = dict(sp.get("attrs") or {})
        args["span_id"] = sp["span_id"]
        if sp.get("parent_id"):
            args["parent_id"] = sp["parent_id"]
        if t1 is None:
            args["unfinished"] = True
        events.append({
            "name": sp["name"],
            "cat": sp.get("service") or "unknown",
            "ph": "X",
            "ts": round(sp["t0"] * 1e6, 3),
            "dur": round(max(0.0, (t1 or sp["t0"]) - sp["t0"]) * 1e6, 3),
            "pid": pid_of[sp.get("service") or "unknown"],
            "tid": 1,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
