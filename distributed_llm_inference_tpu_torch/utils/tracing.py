"""Per-request ids and host-side stage timings (the part of the JAX
package's utils/tracing.py that the solo engine and server use).

A `Trace` carries a request id and contiguous stage spans — queue_wait,
prefill, decode, detokenize: `checkpoint(name)` attributes the time since
the previous checkpoint to `name`, so the spans sum to about the
end-to-end latency. `SpanContext` / `parse_traceparent` read and mint
W3C `traceparent` ids, which cross every hop of the fleet (router,
replica, KV fabric) so each process records its spans under one trace
(serving/trace_store.py). `sample_decision` picks the traces whose
launches the continuous fleet attributes (engine_cfg.trace_sample_rate).
`FlightRecorder` is the bounded ring of control-plane events the fleet's
supervisor dumps on a crash and `GET /debug/flight` serves.
"""

from __future__ import annotations

import collections
import re
import threading
import time
import uuid
from typing import Optional

_SAFE_ID = re.compile(r"^[A-Za-z0-9_\-\.:]{1,128}$")
_TRACEPARENT = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_request_id() -> str:
    return "req-" + uuid.uuid4().hex[:20]


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def sanitize_request_id(raw) -> Optional[str]:
    """A client-supplied id, or None if absent or unusable (the id is
    echoed into headers and logs, so its charset and length are fenced)."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _SAFE_ID.match(raw) else None


class SpanContext:
    """One hop's trace context: trace id, current span id, sampled flag."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    @classmethod
    def new_root(cls, sampled: bool = True) -> "SpanContext":
        return cls(new_trace_id(), new_span_id(), sampled)

    def child(self, span_id: Optional[str] = None) -> "SpanContext":
        """The context of a span opened under this one (its id parents
        what the next hop records)."""
        return SpanContext(self.trace_id, span_id or new_span_id(), self.sampled)

    def header(self) -> str:
        """The `traceparent` header value for the next hop: this
        context's span id is its parent."""
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


def parse_traceparent(raw) -> Optional[SpanContext]:
    """Parse an inbound `traceparent` header; None when absent or
    malformed (the hop then roots a fresh trace)."""
    if not isinstance(raw, str):
        return None
    m = _TRACEPARENT.match(raw.strip().lower())
    if not m:
        return None
    trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, bool(int(flags, 16) & 1))


def sample_decision(trace_id: str, rate: float) -> bool:
    """Whether a trace's launches are attributed, as a pure function of
    its id (the JAX package's rule: the first 32 bits against `rate`), so
    every process of the fleet decides alike and no RNG runs on the hot
    path. rate <= 0 never samples; rate >= 1 always does."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return int(trace_id[:8], 16) / float(0x100000000) < rate


class Trace:
    """Ordered, contiguous stage spans for one request."""

    __slots__ = ("request_id", "_t0", "_last", "_spans", "_lock")

    def __init__(self, request_id: Optional[str] = None):
        self.request_id = request_id or new_request_id()
        now = time.perf_counter()
        self._t0 = now
        self._last = now
        self._spans: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict()
        )
        # a deadline-abandoned generation keeps checkpointing from its
        # daemon thread while the caller reads timings()
        self._lock = threading.Lock()

    def checkpoint(self, name: str) -> float:
        """Attribute the time since the last checkpoint to span `name`."""
        now = time.perf_counter()
        with self._lock:
            dur = now - self._last
            self._last = now
            self._spans[name] = self._spans.get(name, 0.0) + dur
        return dur

    def add(self, name: str, seconds: float):
        """Record a span measured elsewhere (serving/queue.py copies a
        coalesced batch's stage spans onto each member's trace)."""
        with self._lock:
            self._spans[name] = self._spans.get(name, 0.0) + float(seconds)

    def timings(self) -> dict:
        """`{"<span>_s": dur, ..., "total_s": wall}` in span order."""
        now = time.perf_counter()
        with self._lock:
            out = {f"{k}_s": round(v, 6) for k, v in self._spans.items()}
            out["total_s"] = round(now - self._t0, 6)
        return out


class FlightRecorder:
    """Bounded ring of recent control-plane events for one engine.

    Crash forensics: admissions, preemptions, drains, quarantines and
    restarts append here as cheap host-side dicts; the ring is dumped
    into the supervisor's crash report and served live at
    `GET /debug/flight` — so a poison-quarantine or restart-loop episode is
    reconstructable after the fact. Strictly host-side control-plane
    code, called only at seams that already do host work (admission,
    preempt, quarantine, restart)."""

    __slots__ = ("_events", "_lock", "_seq", "capacity")

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields):
        """Append one event. `fields` must already be JSON-safe scalars
        (the dump is json.dumps'd into crash reports verbatim)."""
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "ts": round(time.time(), 6),
                  "kind": kind}
            if fields:
                ev.update(fields)
            self._events.append(ev)

    def events(self, limit: Optional[int] = None) -> list:
        with self._lock:
            out = list(self._events)
        return out[-limit:] if limit else out

    def dump(self) -> dict:
        """The /debug/flight + crash-report payload."""
        events = self.events()
        return {
            "capacity": self.capacity,
            "recorded_total": self._seq,
            "events": events,
        }
