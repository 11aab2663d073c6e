"""Dependency-free metrics registry with a Prometheus text renderer.

The serving stack's measurement substrate: the part of the JAX package's
utils/metrics.py that the solo engine and server use. Counter / Gauge /
Histogram families, labeled (`engine` / `route` / `model` / ...), all
thread-safe, rendered two ways from ONE store: `render()`, the Prometheus
text exposition (served at `GET /metrics`), and `snapshot()`, the JSON
view; `percentile` is the nearest-rank formula /stats uses.

Design notes:
  * No prometheus_client dependency — the container must not grow deps;
    the text format is three line shapes (`# HELP`, `# TYPE`, samples).
  * Histograms use FIXED log-spaced latency buckets (DEFAULT_TIME_BUCKETS)
    so TTFT on an accelerator (~ms) and on the CPU (~s) land in resolvable
    buckets from one layout, and bucket layouts never vary per process.
    Each histogram child also keeps a bounded window of raw observations
    (the snapshot's exact p50/p90/p99) and, per bucket, its EXEMPLAR: the
    most recent observation made with a trace id, so a slow bucket links
    to one inspectable trace (`GET /debug/traces/{trace_id}`).
  * Label cardinality is capped per family (default MAX_SERIES): past the
    cap, new label sets collapse into one `"_other_"` series instead of
    growing without bound — an attacker-controlled label (route, model)
    must never be a memory-growth primitive.
  * Registration is get-or-create and idempotent; re-registering a name
    with a different type/labelnames raises (silent reuse would interleave
    two meanings under one exposition family).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Optional, Sequence

# Log-spaced latency buckets (seconds): sub-ms device decode steps through
# multi-minute CPU-fallback requests land in distinct buckets.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
# Small-integer-count buckets (batch sizes, fleet occupancy).
DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

MAX_SERIES = 64  # label-set cap per family
WINDOW = 256  # raw-observation window per histogram child (the engine's
# rolling sample deque's width, so the JSON percentiles line up)

_OTHER = "_other_"  # collapsed label value once a family hits MAX_SERIES


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (engine.stats()'s p50/p90/p99)."""
    if not values:
        return None
    vals = sorted(values)
    idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
    return round(vals[idx], 4)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labelnames: tuple, labelvalues: tuple, extra: str = "") -> str:
    parts = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, labelvalues)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series. All mutation under the family lock."""

    __slots__ = ("_family",)

    def __init__(self, family: "_Family"):
        self._family = family


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, family):
        super().__init__(family)
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up")
        with self._family._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, family):
        super().__init__(family)
        self._value = 0.0

    def set(self, v: float):
        with self._family._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class HistogramChild(_Child):
    __slots__ = ("_bucket_counts", "_sum", "_count", "_window",
                 "_exemplars")

    def __init__(self, family):
        super().__init__(family)
        self._bucket_counts = [0] * (len(family.buckets) + 1)  # +Inf last
        self._sum = 0.0
        self._count = 0
        self._window = collections.deque(maxlen=WINDOW)
        # bucket index -> (trace_id, value, ts): the most recent traced
        # observation per bucket. Bounded by construction (at most
        # len(buckets) + 1 entries); in the JSON snapshot, not the text
        # exposition (the 0.0.4 format has no exemplar syntax)
        self._exemplars: dict = {}

    def observe(self, v: float, trace_id: Optional[str] = None):
        v = float(v)
        with self._family._lock:
            i = 0
            buckets = self._family.buckets
            while i < len(buckets) and v > buckets[i]:
                i += 1
            self._bucket_counts[i] += 1
            self._sum += v
            self._count += 1
            self._window.append(v)
            if trace_id is not None:
                self._exemplars[i] = (trace_id, v, time.time())

    def exemplars(self) -> dict:
        """{bucket_le: {trace_id, value, ts}} for the buckets that have
        seen a traced observation."""
        with self._family._lock:
            items = dict(self._exemplars)
        les = tuple(self._family.buckets) + (math.inf,)
        return {
            _fmt(les[i]): {
                "trace_id": t, "value": round(v, 6), "ts": round(ts, 3),
            }
            for i, (t, v, ts) in sorted(items.items())
        }

    @property
    def count(self) -> int:
        with self._family._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._family._lock:
            return self._sum

    def window_values(self) -> list:
        with self._family._lock:
            return list(self._window)

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile over the recent-observation window."""
        return percentile(self.window_values(), q)


_CHILD_TYPES = {
    "counter": CounterChild,
    "gauge": GaugeChild,
    "histogram": HistogramChild,
}


class _Family:
    """One metric family: a name, a type, and its labeled children."""

    def __init__(self, name: str, mtype: str, help_: str,
                 labelnames: tuple, buckets: Optional[tuple],
                 max_series: int):
        self.name = name
        self.type = mtype
        self.help = help_
        self.labelnames = labelnames
        self.buckets = tuple(float(b) for b in (buckets or ()))
        self.max_series = max_series
        self._lock = threading.Lock()
        self._children: "collections.OrderedDict[tuple, _Child]" = (
            collections.OrderedDict()
        )

    def labels(self, **labelvalues):
        got = tuple(sorted(labelvalues))
        if got != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {got}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_series:
                    # cardinality cap: collapse into one overflow series
                    key = (_OTHER,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = _CHILD_TYPES[self.type](self)
                        self._children[key] = child
                else:
                    child = _CHILD_TYPES[self.type](self)
                    self._children[key] = child
            return child

    def _items(self):
        with self._lock:
            return list(self._children.items())

    # -- rendering -----------------------------------------------------------
    def render_lines(self) -> list:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.type}")
        for key, child in self._items():
            if self.type in ("counter", "gauge"):
                out.append(
                    f"{self.name}{_labels_str(self.labelnames, key)} "
                    f"{_fmt(child.value)}"
                )
                continue
            with self._lock:
                counts = list(child._bucket_counts)
                total, s = child._count, child._sum
            cum = 0
            for b, c in zip(self.buckets + (math.inf,), counts):
                cum += c
                le = f'le="{_fmt(b)}"'
                out.append(
                    f"{self.name}_bucket"
                    f"{_labels_str(self.labelnames, key, le)} {cum}"
                )
            out.append(
                f"{self.name}_sum{_labels_str(self.labelnames, key)} "
                f"{_fmt(s)}"
            )
            out.append(
                f"{self.name}_count{_labels_str(self.labelnames, key)} "
                f"{total}"
            )
        return out

    def snapshot(self) -> dict:
        series = []
        for key, child in self._items():
            entry = {"labels": dict(zip(self.labelnames, key))}
            if self.type in ("counter", "gauge"):
                entry["value"] = child.value
            else:
                entry["count"] = child.count
                entry["sum"] = round(child.sum, 6)
                entry["p50"] = child.percentile(0.5)
                entry["p90"] = child.percentile(0.9)
                entry["p99"] = child.percentile(0.99)
                ex = child.exemplars()
                if ex:
                    entry["exemplars"] = ex
            series.append(entry)
        return {"type": self.type, "help": self.help, "series": series}


class MetricsRegistry:
    """Get-or-create registry of metric families.

    Each serving process owns ONE registry reachable from the engine
    (`engine.metrics`); the engine and the HTTP handler register into it
    so `GET /metrics` covers the whole stack in one scrape.
    """

    def __init__(self, max_series: int = MAX_SERIES):
        self._lock = threading.Lock()
        self._families: "collections.OrderedDict[str, _Family]" = (
            collections.OrderedDict()
        )
        self.max_series = max_series

    def _register(self, name: str, mtype: str, help_: str,
                  labelnames: Sequence[str], buckets=None) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}{fam.labelnames}, not "
                        f"{mtype}{labelnames}"
                    )
                return fam
            fam = _Family(
                name, mtype, help_, labelnames, buckets, self.max_series
            )
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> _Family:
        return self._register(name, "histogram", help, labelnames, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> list:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for fam in self.families():
            lines.extend(fam.render_lines())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """The JSON view over the same families the exposition renders."""
        return {f.name: f.snapshot() for f in self.families()}


def register_supervisor_metrics(registry: MetricsRegistry):
    """The continuous fleet's preemption and failure-containment families
    with the JAX package's names, unlabeled. The engine registers them up
    front, as the JAX engine does, so /metrics has them before any fleet
    exists; each fleet labels them (register_fleet_metrics)."""
    import types

    m = registry
    return types.SimpleNamespace(
        preempt=m.counter(
            "dli_preemptions_total",
            "slots killed before their budget drained", ("reason",),
        ),
        resume_s=m.histogram(
            "dli_preempted_resume_seconds",
            "preemption to successful re-admission latency",
        ),
        restarts=m.counter(
            "dli_scheduler_restarts_total",
            "continuous-scheduler supervisor restarts", ("engine",),
        ),
        recovered=m.counter(
            "dli_requests_recovered_total",
            "in-flight requests re-admitted (continuation prefill) after "
            "a scheduler restart", ("engine",),
        ),
        poison=m.counter(
            "dli_poison_requests_total",
            "requests quarantined as poison after repeated crash "
            "implication", ("engine",),
        ),
        drain=m.histogram(
            "dli_drain_duration_seconds",
            "graceful-drain wall time (SIGTERM / drain())", ("component",),
        ),
        cancelled=m.counter(
            "dli_cancelled_total",
            "requests cancelled before completion", ("cause",),
        ),
        recovery_recomputed=m.counter(
            "dli_recovery_tokens_recomputed_total",
            "prompt tokens re-prefilled for crash-recovery re-admissions "
            "(warm recovery bounds this by the partial tail block)",
            ("engine",),
        ),
    )


def register_spec_metrics(registry: MetricsRegistry):
    """The fleet's speculation families with the JAX package's names,
    unlabeled: draft / accept / reject token flow, verify rows by draft
    source, the tokens each emitted, the planned K and the acceptance
    EWMA (the last two labeled by engine/scheduler.py). The engine
    registers them up front, as the JAX engine does."""
    import types

    m = registry
    return types.SimpleNamespace(
        drafted=m.counter(
            "dli_spec_drafted_tokens_total",
            "draft tokens submitted in mixed-launch verify rows",
        ),
        accepted=m.counter(
            "dli_spec_accepted_tokens_total",
            "draft tokens accepted (matched the model's own argmax and "
            "were emitted)",
        ),
        rejected=m.counter(
            "dli_spec_rejected_tokens_total",
            "draft tokens rejected by the verify",
        ),
        launches=m.counter(
            "dli_spec_launches_total",
            "verify rows launched inside mixed scheduler steps, by draft "
            "source", ("mode",),
        ),
        tokens=m.histogram(
            "dli_spec_tokens_per_launch",
            "tokens emitted per verify row (accepted drafts + the "
            "correction token; > 1 is the speculation win)",
            buckets=DEFAULT_SIZE_BUCKETS,
        ),
        draft_len=m.histogram(
            "dli_spec_draft_len",
            "planned draft length K per verify row (after the adaptive "
            "per-slot throttle)",
            buckets=DEFAULT_SIZE_BUCKETS,
        ),
        accept_ewma=m.gauge(
            "dli_spec_accept_ewma",
            "fleet-mean per-slot draft acceptance-rate EWMA (0..1)",
        ),
    )


def register_adapter_metrics(registry: MetricsRegistry):
    """The runtime adapter pool's families with the JAX package's names,
    unlabeled: pool residency and reserved device bytes, page loads,
    evictions and swaps. The engine registers them up front, as the JAX
    engine does; engine/adapters.AdapterPool sets them."""
    import types

    m = registry
    return types.SimpleNamespace(
        resident=m.gauge(
            "dli_adapter_pool_resident",
            "adapters resident in device pool pages (referenced + LRU)",
        ).labels(),
        bytes=m.gauge(
            "dli_adapter_pool_bytes",
            "device bytes reserved by the paged adapter leaves (all pages, "
            "base page included)",
        ).labels(),
        loads=m.counter(
            "dli_adapter_loads_total", "adapter page writes into the device pool",
        ).labels(),
        evictions=m.counter(
            "dli_adapter_evictions_total",
            "resident adapters dropped from their page (LRU reclaim; "
            "referenced pages are never evicted)",
        ).labels(),
        swaps=m.counter(
            "dli_adapter_swaps_total",
            "page loads that displaced another adapter (evict + write on "
            "one page)",
        ).labels(),
    )


def register_kv_cache_metrics(registry: MetricsRegistry):
    """The block-prefix index's, the KV shadow's, the tier hierarchy's and
    the KV fabric's families with the JAX package's names, unlabeled,
    registered up front by the engine as the JAX engine does
    (engine/block_prefix.py, engine/shadow.py and serving/kv_fabric.py
    label them when a fleet builds them). Returns the
    two the fleet itself increments: shadowed blocks restored into the
    pool, and ragged prefix hits reused at exact depth."""
    m = registry
    m.counter("dli_prefix_cache_hits_total",
              "prefix-cache hits (tail actually planned and spliced)", ("scope",))
    m.counter("dli_prefix_cache_misses_total", "prefix-cache misses", ("scope",))
    m.counter("dli_prefix_cache_evictions_total",
              "prefix snapshots evicted by the LRU bound", ("scope",))
    m.gauge("dli_prefix_cache_entries", "resident prefix snapshots", ("scope",))
    m.counter("dli_prefix_tail_copies_total",
              "prefix-hit admissions that prefilled a private tail past the "
              "mapped shared head")
    m.counter("dli_prefix_dedup_saved_tokens_total",
              "prompt tokens served by mapping shared blocks instead of "
              "prefilling them")
    m.gauge("dli_shadow_blocks",
            "host-shadowed paged-KV blocks resident for warm recovery")
    m.counter("dli_shadow_copies_total",
              "paged-KV blocks copied device->host into the shadow store")
    m.counter("dli_shadow_dropped_total",
              "shadow blocks dropped (copier backpressure or a failed "
              "device->host transfer)")
    m.gauge("dli_kv_tier_entries",
            "KV blocks resident per cache tier (host = shadow DRAM, disk = "
            "persisted chunk files)", ("tier",))
    m.gauge("dli_kv_tier_bytes", "approximate bytes resident per KV cache tier",
            ("tier",))
    m.counter("dli_kv_tier_promotions_total",
              "KV blocks promoted up the tier hierarchy, by destination tier "
              "(host = disk->DRAM load, pool = scattered into HBM)", ("tier",))
    m.counter("dli_kv_tier_demotions_total",
              "KV blocks demoted down the tier hierarchy, by destination tier "
              "(disk = host-LRU spill or copier-backpressure spill)", ("tier",))
    m.counter("dli_kv_tier_disk_hits_total",
              "lookups served from the disk tier (chunk files loaded and "
              "verified on a read that missed the host tier)")
    # the KV fabric's (serving/kv_fabric.py), labeled by the fleet's fetch
    # client with role = its replica_class
    m.counter("dli_kv_fabric_fetches_total",
              "cross-replica /kv chain fetches attempted", ("role",))
    m.counter("dli_kv_fabric_hits_total",
              "fabric fetches that returned a verified chain", ("role",))
    m.counter("dli_kv_fabric_misses_total",
              "fabric fetches that fell back to local prefill (404, "
              "dead/wedged peer, failed content-key recheck)", ("role",))
    m.counter("dli_kv_fabric_bytes_total",
              "wire bytes of verified fabric chains moved, by serving tier "
              "(host/disk = pull source at the peer, push = proactive "
              "POST /kv at the prefill->decode handoff)", ("role", "tier"))
    m.histogram("dli_kv_fabric_fetch_seconds",
                "fabric fetch wall time, failures included")
    import types

    return types.SimpleNamespace(
        shadow_restored=m.counter(
            "dli_shadow_restored_blocks_total",
            "shadowed blocks scattered back into a rebuilt pool (supervisor "
            "restart or --restore-dir start)",
        ),
        ragged_exact=m.counter(
            "dli_ragged_exact_prefix_hits_total",
            "prefix hits reused at exact chunk depth (no bucket degradation "
            "— the ragged path's planner win)",
        ),
    )


def register_fleet_metrics(registry: MetricsRegistry, n_slots: int):
    """The families the continuous paged fleet (engine/continuous.py)
    increments, registered once with the JAX package's names: fleet
    occupancy and queue, the decode step histogram, launch composition
    (`dli_sched_*`) and ragged-launch accounting (`dli_ragged_*`).
    Returns them as attributes of a namespace."""
    import types

    m = registry
    m.gauge("dli_slots_total", "continuous-fleet decode slots").labels().set(n_slots)
    sup = register_supervisor_metrics(m)
    kv = register_kv_cache_metrics(m)
    spec = register_spec_metrics(m)
    return types.SimpleNamespace(
        occupied=m.gauge(
            "dli_slots_occupied", "continuous-fleet slots serving a request"
        ).labels(),
        depth=m.gauge(
            "dli_queue_depth", "requests waiting for dispatch", ("queue",)
        ).labels(queue="continuous"),
        admission_wait=m.histogram(
            "dli_admission_wait_seconds", "enqueue-to-admission wait",
            ("queue",),
        ).labels(queue="continuous"),
        step=m.histogram(
            "dli_decode_step_seconds",
            "per-token decode step time, launch-to-fetch / tokens per row "
            "(includes pipelining lag)", ("engine",),
        ).labels(engine="continuous"),
        preempt=sup.preempt,
        shed=m.counter(
            "dli_queue_shed_total", "requests shed with 429", ("queue",)
        ).labels(queue="continuous"),
        tenant_shed=m.counter(
            "dli_tenant_shed_total",
            "requests shed with 429 by the per-tenant queue quota", ("tenant",),
        ),
        deadline_exceeded=m.counter(
            "dli_deadline_exceeded_total",
            "requests failed by their end-to-end deadline_ms",
        ).labels(),
        ragged_rows=m.counter(
            "dli_ragged_rows_total",
            "ragged-launch rows by kind (prefill chunk / decode token)",
            ("kind",),
        ),
        ragged_tiles=m.counter(
            "dli_ragged_tiles_total",
            "ragged-launch query tiles by liveness (live / pad — pad tiles "
            "read no K/V)", ("state",),
        ),
        ragged_launches=m.counter(
            "dli_ragged_launches_total", "ragged launches", ("phase",)
        ),
        sched_tokens=m.counter(
            "dli_sched_step_tokens_total",
            "flat tokens launched by the chunked-prefill scheduler, by kind "
            "(decode rows / prefill chunk tokens)", ("kind",),
        ),
        sched_chunks=m.counter(
            "dli_sched_prefill_chunks_total",
            "prefill chunks interleaved into mixed scheduler launches",
        ).labels(),
        sched_rows=m.counter(
            "dli_sched_decode_rows_total",
            "decode rows carried by mixed scheduler launches",
        ).labels(),
        # preemption and the supervisor
        resume_s=sup.resume_s.labels(),
        restarts=sup.restarts.labels(engine="continuous"),
        recovered=sup.recovered.labels(engine="continuous"),
        poison=sup.poison.labels(engine="continuous"),
        drain=sup.drain.labels(component="continuous"),
        cancelled=sup.cancelled,
        recovery_recomputed=sup.recovery_recomputed.labels(engine="continuous"),
        # the block-prefix cache and the KV shadow
        shadow_restored=kv.shadow_restored.labels(),
        ragged_exact=kv.ragged_exact.labels(),
        # speculation on the mixed launch
        spec_drafted=spec.drafted.labels(),
        spec_accepted=spec.accepted.labels(),
        spec_rejected=spec.rejected.labels(),
        spec_launches=spec.launches,
        spec_tokens=spec.tokens.labels(),
    )
