"""Deterministic host-side fault injection for the serving stack: the
JAX package's utils/faults.py, copied (it imports no jax; the port keeps
its own copy, and its own armed plan).

The continuous scheduler survives crashes (engine/continuous.py
supervisor), but a recovery path that is never exercised is a recovery
path that does not work. This module plants NAMED injection points
through the scheduler's host loop so every containment path runs in the
tests, deterministically. The points are the JAX package's; the port's
fleet checks admission, alloc, prefill, decode_launch, fetch and
preempt (the others name places of modules not ported yet):

    admission      _admit_one entry, before any resource grant
    alloc          the paged-pool block grant, before the shared-head
                   incref (a raise here must not leak references)
    prefill        just inside the admission try block, before the
                   scratch prefill / chunked ingest (resources granted;
                   the BaseException handler must release them)
    decode_launch  before a decode chunk launch
    fetch          before a chunk's device->host fetch
    shadow_copy    the warm-recovery shadow store (engine/shadow.py):
                   before a filled-block device->host capture is
                   dispatched (tag = the request's prompt) and before a
                   rebuilt pool restores shadowed blocks (tag
                   "restore" — the crash-during-restore double-fault
                   drill)
    solo           the solo engine's generation path, inside the
                   deadline wrapper (engine._generate_locked) — the
                   wedge drill for /ready-driven router ejection: a
                   wedge_s > deadline rule leaves an abandoned device
                   call in engine._wedged until the sleep drains
    preempt        SLO-aware KV preemption (engine/continuous.
                   _preempt_for): after the victim is selected, before
                   any of its state is touched (tag = the victim's
                   prompt) — the crash-during-preempt chaos drill
    stage_send     the MPMD stage transport (serving/stage_runtime.py):
                   before a cross-process activation/token hand-off is
                   shipped to the next stage (tag =
                   "{request_id}:{phase}:stage{i}") — drop/delay/wedge
                   the inter-stage wire deterministically
    stage_recv     the receiving side of the same hand-off: inside the
                   stage server's /stage/step handler before compute,
                   and inside the heartbeat handler (tag
                   "heartbeat:stage{i}" — a wedge rule here is the
                   heartbeat-timeout → unready drill)

Design rules:
  * Zero overhead disarmed: check() is one module-global None test.
    Production never pays for the harness.
  * Deterministic: triggers are per-point CALL COUNTERS (fail on the
    Nth call, then every Mth, at most `times` firings), never wall
    clock; the optional probabilistic mode draws from a seeded
    random.Random so a chaos run replays identically under
    pytest-randomly or a CI retry.
  * Strictly host-side: nothing here runs inside a device launch or a
    captured CUDA graph. The wedge sleep below is a host stall; it stays
    legal only because these hooks live in the scheduler's host loop,
    between launches.

Arming: tests call arm([FaultRule(...), ...]); operators use the server
`--faults SPEC` flag or the DLI_FAULTS env var (serving/server.main
calls arm_from_env()). SPEC grammar, semicolon-separated rules:

    point:kind[:k=v[,k=v...]]
    e.g.  decode_launch:transient:on=3
          prefill:fatal:match=POISON,times=0
          fetch:transient:on=2,every=4,times=3,wedge=0.5
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

POINTS = (
    "admission", "prefill", "decode_launch", "fetch", "alloc",
    "shadow_copy", "solo", "preempt", "stage_send", "stage_recv",
)


class FaultError(RuntimeError):
    """Base class for injected faults (never raised by real code)."""


class TransientFault(FaultError):
    """Simulated transient device/runtime error (RESOURCE_EXHAUSTED-like):
    the operation would succeed if retried after a restart."""


class FatalFault(FaultError):
    """Simulated hard failure: every retry fails too (the supervisor's
    restart budget is what bounds the damage)."""


@dataclass
class FaultRule:
    """One armed trigger at one injection point.

    Fires on the `on_call`-th MATCHING call (1-based), then every
    `every`-th call after that (0 = only the on_call firing window), at
    most `times` total firings (0 = unlimited). `match` restricts the
    rule to calls whose tag contains the substring — the poison-request
    targeting hook (the scheduler tags admission/prefill checks with the
    request's prompt). `wedge_s` sleeps before raising, simulating a
    call that wedges the runtime before dying. `p` < 1.0 fires
    probabilistically from a random.Random(seed) stream (deterministic
    per rule instance).
    """

    point: str
    kind: str = "transient"  # "transient" | "fatal"
    on_call: int = 1
    every: int = 0
    times: int = 1
    wedge_s: float = 0.0
    match: str = ""
    p: float = 1.0
    seed: int = 0
    calls: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known: {POINTS}"
            )
        if self.kind not in ("transient", "fatal"):
            raise ValueError(
                f"fault kind must be 'transient' or 'fatal', got {self.kind!r}"
            )
        if self.on_call < 1:
            raise ValueError("on_call is 1-based (first matching call = 1)")
        if self.p < 1.0:
            self._rng = random.Random(self.seed)

    def should_fire(self, tag: str) -> bool:
        """Count this call; True when the rule fires on it."""
        if self.match and self.match not in tag:
            return False
        self.calls += 1
        if self.times and self.fired >= self.times:
            return False
        n = self.calls
        due = n == self.on_call or (
            self.every > 0 and n > self.on_call
            and (n - self.on_call) % self.every == 0
        )
        if not due:
            return False
        if self._rng is not None and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def raise_fault(self):
        if self.wedge_s > 0:
            time.sleep(self.wedge_s)
        cls = FatalFault if self.kind == "fatal" else TransientFault
        detail = "simulated fatal fault" if self.kind == "fatal" else \
            "RESOURCE_EXHAUSTED: simulated transient fault"
        raise cls(f"{detail} at {self.point!r} (call {self.calls})")


class FaultPlan:
    """A set of armed rules + thread-safe counters (the scheduler worker,
    test threads, and HTTP handler threads may all hit check())."""

    def __init__(self, rules):
        self._lock = threading.Lock()
        self.rules = list(rules)
        self._by_point: dict = {}
        for r in self.rules:
            self._by_point.setdefault(r.point, []).append(r)

    def check(self, point: str, tag: str = ""):
        rules = self._by_point.get(point)
        if not rules:
            return
        with self._lock:
            due = [r for r in rules if r.should_fire(tag)]
        if due:
            due[0].raise_fault()

    def fired(self, point: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                r.fired for r in self.rules
                if point is None or r.point == point
            )


_PLAN: Optional[FaultPlan] = None


def arm(rules) -> FaultPlan:
    """Arm a plan from FaultRule instances or a SPEC string (see module
    docstring). Replaces any existing plan; returns it (tests read
    plan.fired())."""
    global _PLAN
    if isinstance(rules, str):
        rules = parse_spec(rules)
    _PLAN = FaultPlan(rules)
    return _PLAN


def disarm():
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def check(point: str, tag: str = ""):
    """The injection point. ONE global None test when disarmed — the
    only cost production code ever pays."""
    plan = _PLAN
    if plan is None:
        return
    plan.check(point, tag)


_FLOAT_KEYS = ("wedge", "p")
_INT_KEYS = ("on", "every", "times", "seed")
_KEY_MAP = {
    "on": "on_call", "every": "every", "times": "times",
    "wedge": "wedge_s", "match": "match", "p": "p", "seed": "seed",
}


def parse_spec(spec: str) -> list:
    """'point:kind[:k=v,...];...' -> [FaultRule, ...]. Raises ValueError
    with the offending fragment on malformed input (server startup should
    fail loudly, not arm a half-parsed plan)."""
    rules = []
    for frag in spec.split(";"):
        frag = frag.strip()
        if not frag:
            continue
        parts = frag.split(":", 2)
        if len(parts) < 2:
            raise ValueError(f"fault spec {frag!r}: need point:kind[:opts]")
        kw: dict = {"point": parts[0].strip(), "kind": parts[1].strip()}
        if len(parts) == 3 and parts[2].strip():
            for opt in parts[2].split(","):
                if "=" not in opt:
                    raise ValueError(f"fault spec option {opt!r}: need k=v")
                k, v = (s.strip() for s in opt.split("=", 1))
                if k not in _KEY_MAP:
                    raise ValueError(
                        f"fault spec option {k!r}; known: {sorted(_KEY_MAP)}"
                    )
                if k in _FLOAT_KEYS:
                    kw[_KEY_MAP[k]] = float(v)
                elif k in _INT_KEYS:
                    kw[_KEY_MAP[k]] = int(v)
                else:
                    kw[_KEY_MAP[k]] = v
        rules.append(FaultRule(**kw))
    if not rules:
        raise ValueError(f"fault spec {spec!r} contains no rules")
    return rules


def arm_from_env(env=None) -> Optional[FaultPlan]:
    """Arm from DLI_FAULTS when set (server startup hook); None if unset."""
    spec = (env or os.environ).get("DLI_FAULTS")
    if not spec:
        return None
    return arm(spec)
