"""Multi-process serving: one HTTP front door, mirrored followers (the JAX
package's serving/multihost.py on torch.distributed).

A mesh that spans several server processes (parallel/mesh.py,
`multihost_initialize`) has one driver per process, each driving only
its own ranks, and every program's collectives span the processes. So
every process runs the SAME engine build, and each driver must send its
ranks the same program sequence. Serving becomes a mirroring problem,
not an RPC problem:

  * process 0 serves HTTP. Before it runs an engine method that launches
    programs, it broadcasts the (method, args, kwargs) triple to every
    process: one fixed-size uint8 broadcast on the processes' gloo group.
  * processes > 0 run `follower_loop`: receive a triple, invoke the same
    engine method with the same arguments, discard the result, repeat.
    The engine surface is deterministic (tokenizer, bucket planning, the
    generator seeded from the request's seed or the engine's own seeded
    counter), so both sides issue the same programs.
  * one issue lock around (broadcast, engine call) on the leader pins the
    order: no second request can put its broadcast between another
    request's broadcast and its programs.

Scope: the bare engine surface (generate / generate_batch / score).
`--continuous` and `--queue` batch by request ARRIVAL TIMING, which
differs per process, and are refused at startup for mirrored serving.
The MPMD stage runtime (serving/stage_runtime.py) is the multi-process
deployment that admits them: its controller alone owns arrival timing.
"""

from __future__ import annotations

import json
import threading

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger("multihost")

# Fixed wire size: the broadcast must have the same shape on every process;
# a request is length-prefixed inside it. 64 KiB covers any request the
# HTTP edge accepts (prompts are bounded by the prefill buckets first).
_WIRE_BYTES = 64 * 1024

# Engine methods that launch programs and therefore must be mirrored on
# every process. Everything else (health, stats, tokenizer helpers) is
# host or local-rank work the leader answers alone.
MIRRORED_METHODS = ("generate", "generate_batch", "score")

_SHUTDOWN = {"m": "__shutdown__"}


def _broadcast_obj(obj, is_source: bool):
    """Broadcast a JSON-serializable obj from process 0 to all processes:
    one broadcast of a fixed [4 + _WIRE_BYTES] uint8 tensor (a 4-byte
    big-endian length prefix) on the default group. Every process must
    call this the same number of times in the same order: the leader's
    issue lock guarantees it."""
    buf = torch.zeros(4 + _WIRE_BYTES, dtype=torch.uint8)
    if is_source:
        payload = json.dumps(obj).encode()
        if len(payload) > _WIRE_BYTES:
            raise ValueError(
                f"mirrored request of {len(payload)} bytes exceeds the "
                f"{_WIRE_BYTES}-byte wire buffer"
            )
        buf[:4] = torch.frombuffer(bytearray(len(payload).to_bytes(4, "big")),
                                   dtype=torch.uint8)
        buf[4:4 + len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    dist.broadcast(buf, src=0)
    raw = buf.numpy().tobytes()
    n = int.from_bytes(raw[:4], "big")
    return json.loads(raw[4:4 + n].decode())


class MirroredEngine:
    """Leader-side proxy: broadcast-then-run for the mirrored methods,
    transparent passthrough for everything else (health, stats, cfg,
    tokenizer, backend: all local to the process)."""

    def __init__(self, engine):
        self._engine = engine
        # ONE lock across (broadcast, engine call): a follower issues
        # [bcast_i, programs_i, bcast_i+1, ...] strictly in order, so the
        # leader must too; a second thread slipping its broadcast between
        # another request's broadcast and its programs would desynchronize
        # the collectives and wedge every process
        self._issue_lock = threading.Lock()

    def _mirrored(self, method, args, kwargs):
        with self._issue_lock:
            _broadcast_obj({"m": method, "a": list(args), "kw": kwargs}, is_source=True)
            return getattr(self._engine, method)(*args, **kwargs)

    def generate(self, *args, **kwargs):
        return self._mirrored("generate", args, kwargs)

    def generate_batch(self, *args, **kwargs):
        return self._mirrored("generate_batch", args, kwargs)

    def score(self, *args, **kwargs):
        return self._mirrored("score", args, kwargs)

    def shutdown_followers(self, timeout_s: float = 5.0) -> bool:
        """Release the follower loops (best effort: call once, right before
        the leader exits). Bounded: a follower that already died can never
        answer the broadcast, and a stuck mirrored call may hold the issue
        lock, so the lock and the broadcast run on a daemon thread the
        leader abandons past `timeout_s` (the abandonment discipline of
        engine._with_deadline). Returns True when the broadcast completed
        inside the timeout."""
        done = threading.Event()

        def _bcast():
            try:
                with self._issue_lock:
                    _broadcast_obj(_SHUTDOWN, is_source=True)
            finally:
                done.set()

        threading.Thread(target=_bcast, daemon=True, name="multihost-shutdown").start()
        if done.wait(timeout_s):
            return True
        log.warning("shutdown_followers_timeout", timeout_s=timeout_s)
        return False

    def __getattr__(self, name):
        return getattr(self._engine, name)


def follower_loop(engine, process_id: int):
    """Processes > 0: mirror every leader request until the shutdown.

    Results are discarded: the point is the programs, which the mesh needs
    from every process's driver. Errors the engine returns as envelopes
    (validation, deadline) return normally on both sides; anything raised
    here is fatal by design (a diverged follower cannot safely keep
    answering collectives)."""
    while True:
        msg = _broadcast_obj(None, is_source=False)
        if msg["m"] == _SHUTDOWN["m"]:
            return
        if msg["m"] not in MIRRORED_METHODS:
            raise RuntimeError(
                f"follower {process_id} received unknown mirrored method "
                f"{msg['m']!r}"
            )
        getattr(engine, msg["m"])(*msg["a"], **msg["kw"])
