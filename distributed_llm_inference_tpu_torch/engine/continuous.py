"""Continuous (in-flight) batching: the JAX package's engine/continuous.py
in PyTorch, over the block-paged KV pool or the dense slot cache.

A fixed fleet of `n_slots` slots decodes in lock-step and a queued request
joins the moment a slot (and, paged, pool blocks) is free. Three ways in,
as in the JAX package:

  * chunked (the paged fleet's default, `ragged_prefill` and
    `chunked_prefill` True): every scheduler step is ONE mixed launch
    (engine/paged.mixed_step_ragged) carrying a decode token for every
    active slot plus the prompt chunks that the token-budget scheduler
    (engine/scheduler.py) granted this step. The launch that carries an
    admission's last chunk samples its first token and arms its slot on
    the device. A step with no prompt pending falls back to a decode
    chunk (engine/paged.decode_slots_paged, `chunk_steps` tokens per slot);
  * whole-prefill (`chunked_prefill` or `ragged_prefill` False, and every
    dense fleet): each iteration admits every queued request a free slot
    can take, its prompt prefilled whole before the slot decodes —
    ragged, straight into the pool (engine/paged.extend_ragged_paged /
    prefill_ragged_paged); bucketed, on a batch-1 scratch cache spliced
    into the slot (engine/paged.insert_slot_paged, or
    engine/generate.insert_slot for the dense fleet) — then launches one
    decode chunk. The wave's first tokens come back in one stacked copy;
  * the dense fleet (no `kv_pool_blocks`): the cache is [L, n_slots, KV,
    slot_max_seq, Dh] and decode chunks run engine/generate.decode_slots,
    whose attention is the einsum over per-row positions (the JAX
    package's decode gate).

Lag pipelining: each launch's results are ONE packed int32 array, copied
to pinned host memory with `non_blocking=True` behind a CUDA event; up to
`chunk_lag` launches are in flight before the worker waits on the oldest
event. Launches read their decode positions from the slot state on the
device (engine/paged.DeviceMeta) and their operands are uploaded from
pinned memory, so planning the next launch never waits for a fetch.

CUDA graphs (engine/graphs.py): the decode chunk and the mixed launch
are each captured once per fleet, at their fixed shapes, and replayed for
every later launch on the card; on the CPU they run eagerly. The slot
state and knobs, the block table and the mixed launch's inputs are
static device buffers: every launch and every eager site (arming, insert,
kill) writes them IN PLACE, on every device, and each launch's operands
are copied into them on the launch's stream. Whole-prefill admission
launches stay eager.

Tenants, as in the JAX package: a request's `tenant` weighs its share of
its SLO class's prefill grant (engine_cfg.tenant_weights) and caps its
share of the bounded queue (engine_cfg.tenant_max_queue_share): an
over-quota tenant sheds with a 429 "overloaded" envelope that names it,
counted in dli_tenant_shed_total{tenant}.

Attribution discipline: each launch snapshots the slot -> request
assignment, so emissions of a launch still in flight when a slot is
freed and re-armed are never credited to the new tenant.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): speculation, the shadow / KV fabric, adapters, grammar constraints
in the fleet (they go to the solo engine, as in the JAX package),
preemption and the supervisor's restart / salvage, the prefix caches, and
gpt2's fleet. A crash in the worker loop fails every request in flight
with an error envelope and marks the engine not ready; it is not
restarted.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..models.llama import ADAPTERS, FAMILIES, _not_ported
from ..utils.logging import get_logger
from ..utils.metrics import register_fleet_metrics
from ..utils.tracing import Trace
from . import generate as G
from . import graphs
from . import paged as P
from .scheduler import MIN_SHED_DEPTH, PrefillJob, TokenBudgetScheduler, parse_slo_classes

log = get_logger("continuous")

# _start_job sentinel: the pool has no blocks for this request right now —
# requeue it (front) and retry after the next release
_BLOCKED = object()


class _Request:
    __slots__ = (
        "prompt", "kwargs", "done", "result", "t_start", "ttft", "first_id",
        "tokens", "slot", "enqueued", "budget", "record", "prompt_tokens",
        "block_ids", "need", "trace", "allowed", "slo", "ids", "deadline_at",
        "prefill_chunks", "tenant",
    )

    def __init__(self, prompt: str, kwargs: dict, request_id=None, tenant=None):
        self.prompt = prompt
        self.slo = kwargs.pop("slo_class", None)
        # the tenant the request bills (None: anonymous): its prefill share
        # (engine_cfg.tenant_weights) and its queue quota
        self.tenant = tenant
        self.kwargs = kwargs
        self.trace = Trace(request_id)
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.enqueued = time.time()
        self.t_start = self.enqueued
        self.ttft: float = 0.0
        self.first_id: Optional[int] = None
        self.tokens: list = []
        self.slot: Optional[int] = None
        self.budget = 0
        self.record = True  # False: warmup traffic, kept out of /stats
        self.prompt_tokens = 0
        self.block_ids = None
        self.need = None
        self.allowed: Optional[int] = None
        self.ids: Optional[list] = None
        dl = kwargs.pop("deadline_ms", None)
        self.deadline_at = self.enqueued + float(dl) / 1e3 if dl is not None else None
        self.prefill_chunks = 0  # mixed launches that carried its prompt


class ContinuousEngine:
    """In-flight batching front end over an InferenceEngine's model and
    backend. submit() blocks until the request's envelope is ready (the
    solo engine's schema plus "continuous": true)."""

    def __init__(
        self,
        engine: Any,
        n_slots: int = 8,
        chunk_steps: int = 16,
        max_queue: int = 64,
        chunk_lag: int = 2,
        slot_max_seq: Optional[int] = None,
        kv_pool_blocks: Optional[int] = None,
        kv_block_size: int = 16,
        kv_shadow: Optional[bool] = None,
        restore_dir: Optional[str] = None,
    ):
        cfg = engine.cfg
        ecfg = engine.engine_cfg
        if cfg.arch != "llama":
            raise _not_ported(f"the continuous fleet for arch {cfg.arch!r}",
                              FAMILIES)
        backend = engine.backend
        if not getattr(backend, "supports_slots", False):
            raise ValueError(
                f"backend {backend.name!r} does not support slot decode; the "
                f"fleet runs on the single-device llama backend"
            )
        self.paged = kv_pool_blocks is not None
        if self.paged and not getattr(backend, "supports_paged", False):
            raise ValueError(f"backend {backend.name!r} does not support paged "
                             f"KV; drop kv_pool_blocks or use the dense fleet")
        if kv_shadow or restore_dir is not None:
            raise _not_ported("the KV shadow (engine/shadow.py)", "Shadow and fabric")
        if ecfg.prefix_cache_entries > 0:  # paged: block chains; dense: snapshots
            raise _not_ported("the fleet's prefix cache", "Block-prefix cache"
                              if self.paged else "Solo-engine features")
        if ecfg.preempt_policy != "off":
            raise _not_ported(f"preempt_policy {ecfg.preempt_policy!r}",
                              "Preemption and the supervisor")
        if ecfg.adapter_slots > 0:
            raise _not_ported("adapter pages in the fleet", ADAPTERS)
        self.engine = engine
        self.cfg = cfg
        self.backend = engine.backend
        self.device = torch.device(engine.device)
        self._cuda = self.device.type == "cuda"
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.max_queue = int(max_queue)
        # launches in flight before the worker waits on the oldest fetch
        self.chunk_lag = max(1, int(chunk_lag))
        self.slot_max_seq = min(int(slot_max_seq or cfg.max_seq_len),
                                cfg.max_seq_len)
        # ragged paged ingest: the prompt lands straight in the pool, with
        # no bucket ladder, so the bucket guard below does not apply
        self._ragged = bool(self.paged and ecfg.ragged_prefill
                            and getattr(backend, "supports_ragged_fill", False))
        buckets = engine._buckets()
        if not self._ragged and buckets and self.slot_max_seq < buckets[0]:
            raise ValueError(
                f"slot_max_seq={self.slot_max_seq} is smaller than the "
                f"smallest prefill bucket {buckets[0]}; raise it or shrink "
                f"engine_cfg.prefill_buckets"
            )
        self._ragged_tile = 8
        if self.paged:
            self.kv_block_size = int(kv_block_size)
            if self.kv_block_size < 1:
                raise ValueError("kv_block_size must be >= 1")
            self._max_blocks = -(-self.slot_max_seq // self.kv_block_size)
            # the scratch is a whole number of blocks: the insert scatter
            # is an exact block reshape
            self._scratch_seq = self._max_blocks * self.kv_block_size
            if int(kv_pool_blocks) - 1 < self._max_blocks:
                raise ValueError(
                    f"kv_pool_blocks={kv_pool_blocks} cannot hold one full "
                    f"slot-class request ({self._max_blocks} blocks of "
                    f"{self.kv_block_size} + the trash block); raise it or "
                    f"shrink slot_max_seq"
                )
            self._pool_blocks = int(kv_pool_blocks)
            self.cache = self.backend.init_paged_pool(self._pool_blocks,
                                                      self.kv_block_size)
            self._alloc = P.BlockAllocator(self._pool_blocks,
                                           registry=engine.metrics)
            # host-side block tables, copied into the static device table
            # before the next launch once they changed
            self._table = np.zeros((self.n_slots, self._max_blocks), np.int32)
            self._table_dev = torch.zeros(self._table.shape, dtype=torch.int32,
                                          device=self.device)
            self._table_stale = True
            self._ragged_width = -(-max(1, int(ecfg.ragged_width))
                                   // self._ragged_tile) * self._ragged_tile
        else:
            self._scratch_seq = self.slot_max_seq
            self.cache = self.backend.init_cache(self.n_slots, self.slot_max_seq)
        self._chunked = bool(self._ragged and ecfg.chunked_prefill
                             and getattr(backend, "supports_mixed_step", False))
        # the bucketed admissions' batch-1 prefill cache, written in place
        # and spliced into the slot; the ragged ingest needs none
        self._scratch = (None if self._ragged
                         else self.backend.init_cache(1, self._scratch_seq))
        self._slo = parse_slo_classes(ecfg)
        self._sched = TokenBudgetScheduler(
            self._slo, ecfg.slo_default_class, int(ecfg.step_token_budget),
            self._ragged_tile, self.n_slots, registry=engine.metrics,
            tenant_weights=ecfg.tenant_weights,
        )
        self._tenant_max_share = float(ecfg.tenant_max_queue_share)
        # tenants that have ever queued (guarded-by: _cv): the per-tenant
        # queue-depth gauge keeps its schema after they drain
        self._gauge_tenants: set = {""}
        self._sched_width = self._sched.width
        # chunked mode: pending PrefillJobs (arrival order), and slot -> job
        # while its prompt lands
        self._jobs: list = []
        self._prefilling: dict = {}
        self._idle_arm = (P.idle_mixed_arm(self.n_slots, cfg.vocab_size,
                                           device=self.device)
                          if self._chunked else None)
        # static: every launch and eager site writes them in place
        self.state, self.sparams = G.init_slots(self.n_slots, cfg.vocab_size,
                                                device=self.device)
        self._mixed_in = (graphs.mixed_inputs(self._sched_width, self._ragged_tile,
                                              self.n_slots, cfg.vocab_size,
                                              device=self.device)
                          if self._chunked else None)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(time.time()) & 0x7FFFFFFF
        )
        # the launch kinds, captured as CUDA graphs on their first launch
        self._chunk_graph = graphs.LaunchGraph(self._chunk_body, "decode_chunk",
                                               self.device, self._gen)
        self._mixed_graph = (graphs.LaunchGraph(self._mixed_body, "mixed_launch",
                                                self.device, self._gen)
                             if self._chunked else None)
        self._cv = threading.Condition()
        self._queue: list = []  # guarded-by: _cv
        self._assignment: list = [None] * self.n_slots  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._draining = False  # guarded-by: _cv
        self._dead = False
        # the request a whole-prefill admission is serving right now: a
        # crash there fails it with the rest
        self._admitting: Optional[_Request] = None
        self.admitted = 0
        self.completed = 0
        self.peak_occupancy = 0
        # launch accounting (/stats "launches"): mixed steps, those that
        # carried decode rows and prompt chunks at once, decode chunks
        self.mixed_launches = 0
        self.mixed_with_both = 0
        self.chunk_launches = 0
        self._m = register_fleet_metrics(engine.metrics, self.n_slots)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-engine")
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def _needs_solo(self, kwargs: dict) -> bool:
        """Contracts slots cannot honor run solo on the wrapped engine (the
        JAX package's rule): a seed, debug, logprobs, logit_bias, beams,
        constraints, and speculation (not ported to the fleet)."""
        return bool(
            kwargs.get("seed") is not None
            or kwargs.get("debug")
            or kwargs.get("speculative")
            or kwargs.get("logprobs")
            or kwargs.get("logit_bias")
            or int(kwargs.get("num_beams", 1) or 1) > 1
            or kwargs.get("constraint") is not None
        )

    def _note_queue_locked(self):  # guarded-by: _cv
        """Refresh the global and per-(SLO class, tenant) queue-depth
        gauges; a tenant ever seen keeps its series (a drained tenant
        reads 0, not its stale last value)."""
        self._m.depth.set(len(self._queue))
        counts: dict = {}
        for r in self._queue:
            t = r.tenant or ""
            self._gauge_tenants.add(t)
            counts[(r.slo, t)] = counts.get((r.slo, t), 0) + 1
        for name in self._slo:
            for t in self._gauge_tenants:
                self._sched.set_depth(name, counts.get((name, t), 0), tenant=t)

    def _deadline_env(self, req: _Request, where: str = "") -> dict:
        self._m.deadline_exceeded.inc()
        suffix = f" {where}" if where else ""
        return {"error": f"Error: request exceeded its deadline_ms budget{suffix}",
                "status": "failed", "error_type": "deadline_exceeded"}

    @staticmethod
    def _past_deadline(req: _Request, now: Optional[float] = None) -> bool:
        return req.deadline_at is not None and (
            now if now is not None else time.time()
        ) >= req.deadline_at

    def _enqueue(self, req: _Request) -> Optional[dict]:
        """Admit a request to the bounded queue; returns an error envelope
        (queue full, over-target sheddable class, closed, draining, dead)
        or None. Retry-After derives from the request's SLO class."""
        cls = self._sched.classify(req.slo)
        req.slo = cls.name
        if self._past_deadline(req):
            return self._deadline_env(req, where="before admission")
        with self._cv:
            if self._closed or self._dead:
                return {"error": "Error: server shutting down" if self._closed
                        else "Error: the continuous scheduler crashed",
                        "status": "failed",
                        "error_type": "overloaded" if self._closed else "unavailable"}
            if self._draining:
                return {"error": "Error: server draining", "status": "failed",
                        "error_type": "draining"}
            class_depth = sum(1 for r in self._queue if r.slo == cls.name)
            full = len(self._queue) >= self.max_queue
            if not full and req.tenant is not None and self._tenant_max_share < 1.0:
                # the tenant quota: one tenant's queued share of the bounded
                # queue is capped (beyond a small absolute floor), so a
                # tenant flooding the queue sheds before the others meet a
                # full queue
                t_depth = sum(1 for r in self._queue if r.tenant == req.tenant)
                t_cap = max(MIN_SHED_DEPTH, int(self.max_queue * self._tenant_max_share))
                if t_depth >= t_cap:
                    log.warning("tenant_shed", tenant=req.tenant, depth=t_depth,
                                cap=t_cap, slo_class=cls.name)
                    self._m.shed.inc()
                    self._m.tenant_shed.labels(tenant=req.tenant).inc()
                    return {
                        "error": (f"Error: tenant {req.tenant!r} is at its queue "
                                  f"quota ({t_cap} of {self.max_queue})"),
                        "status": "failed", "error_type": "overloaded",
                        "slo_class": cls.name, "tenant": req.tenant,
                        "retry_after_s": self._sched.retry_after_s(cls, class_depth),
                    }
            if full or self._sched.should_shed(cls, class_depth):
                log.warning("queue_full" if full else "slo_shed",
                            depth=len(self._queue), slo_class=cls.name)
                self._m.shed.inc()
                self._sched.count_shed(cls.name)
                return {
                    "error": (f"Error: request queue full ({self.max_queue})"
                              if full else
                              f"Error: {cls.name} queue drain estimate exceeds "
                              f"the {cls.ttft_target_s:g}s TTFT target"),
                    "status": "failed", "error_type": "overloaded",
                    "slo_class": cls.name,
                    "retry_after_s": self._sched.retry_after_s(cls, class_depth),
                }
            self._queue.append(req)
            self._note_queue_locked()
            self._cv.notify_all()
        return None

    def submit(self, prompt: str, **kwargs) -> dict:
        if kwargs.pop("adapter", None):
            return {"error": "Error: adapter serving needs the fleet's adapter "
                    "pool, which is not ported yet", "status": "failed",
                    "error_type": "invalid_request"}
        tenant = kwargs.pop("tenant", None) or None
        if self._needs_solo(kwargs):
            return self.engine.generate(prompt, **kwargs)
        req = _Request(prompt, kwargs, request_id=kwargs.pop("request_id", None),
                       tenant=tenant)
        err = self._enqueue(req)
        if err is not None:
            return err
        req.done.wait()
        return req.result

    @property
    def ready(self) -> bool:
        """Load-balancer readiness: False while draining, once closed, or
        once the worker loop died."""
        return not (self._draining or self._dead or self._closed)

    def _work_pending(self) -> bool:
        return bool(self._queue or any(r is not None for r in self._assignment))

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Stop admitting (draining envelopes), then wait for the queue
        and every slot to finish, up to deadline_s. True when drained."""
        t0 = time.time()
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._work_pending():
                if self._closed or self._dead:
                    return not self._work_pending()
                left = None if deadline_s is None else deadline_s - (time.time() - t0)
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=0.1 if left is None else min(left, 0.1))
        return True

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
        if not self._thread.is_alive():  # a replay may still be running otherwise
            for graph in self._graphs():
                graph.close()
        fail = {"error": "Error: server shutting down", "status": "failed",
                "error_type": "overloaded"}
        with self._cv:
            pending = self._queue[:]
            self._queue.clear()
        for req in pending + [r for r in self._assignment if r is not None]:
            if req.result is None:
                req.result = dict(fail)
            self._push_final(req)

    def warmup(self) -> dict:
        """Serve one throwaway request through the fleet (kept out of
        /stats) so the kernels are built and loaded before traffic."""
        t0 = time.time()
        req = _Request("warmup", dict(max_tokens=self.chunk_steps + 2,
                                      greedy=True, chat=False))
        req.record = False
        err = self._enqueue(req)
        if err is not None:
            return {"ok": False, "seconds": 0.0, **err}
        req.done.wait()
        return {"ok": (req.result or {}).get("status") == "success",
                "seconds": round(time.time() - t0, 2)}

    def stats(self) -> dict:
        with self._cv:
            out = {
                "slots": self.n_slots,
                "occupied": sum(r is not None for r in self._assignment),
                "queued": len(self._queue),
                "admitted": self.admitted,
                "completed": self.completed,
                "peak_occupancy": self.peak_occupancy,
                "chunk_steps": self.chunk_steps,
            }
        out["preemption"] = {"policy": "off"}
        out["supervisor"] = {"ready": self.ready, "draining": self._draining,
                             "dead": self._dead}
        if self.paged:
            out["paged"] = {
                "block_size": self.kv_block_size,
                "pool_blocks": self._alloc.n_blocks,
                "free_blocks": self._alloc.free_blocks,
                "shared_blocks": self._alloc.shared_blocks,
                "cached_blocks": 0,
                "ragged_prefill": self._ragged,
            }
            if self._ragged:
                out["paged"]["ragged_width"] = self._ragged_width
        out["slo"] = {
            "default": self._sched.default_name,
            "classes": {
                name: {
                    "ttft_target_s": c.ttft_target_s,
                    "tpot_target_s": c.tpot_target_s,
                    "weight": c.weight,
                    "sheddable": c.sheddable,
                    "ttft_ewma_s": self._sched.feedback[name].ttft_ewma,
                    "tpot_ewma_s": self._sched.feedback[name].tpot_ewma,
                }
                for name, c in self._slo.items()
            },
        }
        out["scheduler"] = {"chunked_prefill": self._chunked}
        if self._chunked:
            out["scheduler"].update(step_width=self._sched_width,
                                    tile=self._ragged_tile,
                                    prefilling=len(self._jobs))
        out["launches"] = {
            "mixed": self.mixed_launches,
            "mixed_with_decode_and_prefill": self.mixed_with_both,
            "decode_chunks": self.chunk_launches,
        }
        # CUDA graphs: a launch kind is captured once, then replayed
        out["graphs"] = {g.name: {"captures": g.captures, "replays": g.replays}
                         for g in self._graphs()}
        return out

    def _graphs(self) -> list:
        return [g for g in (self._chunk_graph, self._mixed_graph) if g is not None]

    # -- host <-> device -----------------------------------------------------
    def _upload(self, *arrays):
        """numpy arrays -> device tensors. On the card each goes through
        pinned memory with non_blocking=True: a copy from pageable memory
        would synchronize the stream and stall lag pipelining."""
        if not self._cuda:
            return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                .to(self.device, non_blocking=True) for a in arrays]

    def _upload_into(self, dsts, arrays):
        """Copy numpy arrays into static device tensors in place, through
        pinned memory with non_blocking=True on the card: ordered on the
        launch stream behind every launch already in flight."""
        for dst, a in zip(dsts, arrays):
            src = torch.from_numpy(np.ascontiguousarray(a))
            if self._cuda:
                src = src.pin_memory()
            dst.copy_(src, non_blocking=self._cuda)

    def _commit(self, state: G.SlotState, sparams: Optional[G.SlotParams] = None):
        """Write a new slot state (and knobs) into the static ones."""
        graphs.commit(self.state, state)
        if sparams is not None:
            graphs.commit(self.sparams, sparams)

    def _to_host(self, packed: torch.Tensor):
        """Start the packed result's copy to the host: pinned memory,
        non_blocking, and a CUDA event the fetch waits on."""
        if not self._cuda:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _table_device(self):
        if self._table_stale:
            self._upload_into((self._table_dev,), (self._table,))
            self._table_stale = False
        return self._table_dev

    # -- worker thread -------------------------------------------------------
    def _loop(self):
        """The worker: a crash fails every request in flight with an
        error envelope and marks the engine dead (not ready); it is not
        restarted (the JAX supervisor is not ported)."""
        try:
            self._sched_loop()
        except Exception as e:  # noqa: BLE001 - every request gets an envelope
            log.error("scheduler_crashed", exc_info=True, error=str(e))
            fail = {"error": f"Error: the continuous scheduler crashed: {e}",
                    "status": "failed", "error_type": "unavailable"}
            with self._cv:
                self._dead = True
                pending = self._queue[:]
                self._queue.clear()
                live = [r for r in self._assignment if r is not None]
                if self._admitting is not None:
                    live.append(self._admitting)
                self._cv.notify_all()
            for req in pending + live:
                if not req.done.is_set():
                    req.result = dict(fail)
                    self._push_final(req)

    def _sched_loop(self):
        """Each iteration takes queued requests into free slots, then
        launches ONE step. Chunked: start PrefillJobs (host work only),
        then a mixed launch while prompt chunks are pending, else a decode
        chunk. Whole-prefill: admit (prefill and arm) every request a free
        slot can take, then a decode chunk. Up to chunk_lag launches stay
        in flight."""
        inflight: collections.deque = collections.deque()
        while True:
            with self._cv:
                while (not self._queue and not any(self._assignment)
                       and not inflight and not self._closed):
                    self._cv.wait()
                if self._closed:
                    return
                queued = bool(self._queue)
            if self._chunked:
                self._reap_jobs()
                self._start_jobs()
                step = self._launch_mixed() if self._jobs else self._launch_chunk()
            else:
                if queued:
                    self._admit()
                step = self._launch_chunk()
            launched = step is not None
            if launched:
                inflight.append(step)
            while inflight and (len(inflight) > self.chunk_lag or not launched):
                self._process_any(inflight.popleft())
                launched = True

    def _process_any(self, step):
        if step[0] == "mixed":
            self._process_mixed(step)
        else:
            self._process(step)

    def _reap_jobs(self):
        """Fail pending prefills whose deadline passed before spending more
        budget on them."""
        deadline = self.engine.engine_cfg.request_deadline_s
        now = time.time()
        for job in list(self._jobs):
            req = job.req
            if self._past_deadline(req, now):
                req.result = self._deadline_env(req, where="mid-prefill")
            elif deadline and now - req.t_start > deadline:
                req.result = {"error": f"Error: request exceeded the {deadline:g}s "
                              "deadline", "status": "failed", "error_type": "timeout"}
            else:
                continue
            self._m.preempt.labels(reason="deadline").inc()
            self._release(req)

    def _start_jobs(self):
        """Move queued requests into PrefillJobs while a slot and pool
        blocks are available (host-side only: tokenize, allocate blocks,
        install the slot's table row)."""
        while True:
            with self._cv:
                if not self._queue:
                    return
                free = [b for b, r in enumerate(self._assignment) if r is None]
                if not free:
                    return
                head = self._queue[0]
                if head.need is not None and head.need > self._alloc.free_blocks:
                    return  # a sized head that still cannot get blocks waits
                req = self._queue.pop(0)
                self._note_queue_locked()
            try:
                started = self._start_job(req, free[0])
            except ValueError as e:
                self._free_slot_resources(req)
                log.warning("invalid_request", error=str(e))
                req.result = {"error": f"Error: {e}", "status": "failed",
                              "error_type": "invalid_request"}
                self._push_final(req)
                continue
            if started is _BLOCKED:
                with self._cv:
                    self._queue.insert(0, req)
                    self._note_queue_locked()
                return

    def _expired_in_queue(self, req: _Request) -> bool:
        """Fail a request whose deadline passed while it queued (before any
        block grant or prefill); True when it did."""
        req.trace.checkpoint("queue_wait")
        if self._past_deadline(req):
            req.result = self._deadline_env(req, where="while queued")
        else:
            deadline = self.engine.engine_cfg.request_deadline_s
            if not (deadline and time.time() - req.enqueued > deadline):
                return False
            req.result = {"error": f"Error: request exceeded the {deadline:g}s "
                          "deadline while queued", "status": "failed",
                          "error_type": "timeout"}
        self._push_final(req)
        return True

    def _start_job(self, req: _Request, slot: int):
        """Plan one chunked admission: tokenize, clamp the budget,
        allocate pool blocks and queue the PrefillJob. Returns _BLOCKED
        when the pool cannot take it, None when the request failed fast,
        or the job."""
        eng, cfg = self.engine, self.cfg
        if self._expired_in_queue(req):
            return None
        k = req.kwargs
        text = eng.render_chat(req.prompt) if k.get("chat", True) else req.prompt
        ids = eng.tokenizer.encode(text)
        req.prompt_tokens = prompt_len = len(ids)
        if not 1 <= prompt_len <= self.slot_max_seq - 2:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the slot capacity "
                f"(slot_max_seq {self.slot_max_seq})"
            )
        max_tokens, _ = eng._clamp_decode(
            prompt_len, int(k.get("max_tokens", 20)), capacity=self.slot_max_seq,
        )
        req.allowed = max_tokens
        rp = float(k.get("repetition_penalty", 1.0))
        sampling = (
            float(k.get("temperature", 0.7)), int(k.get("top_k", 50)),
            float(k.get("top_p", 0.9)), bool(k.get("greedy", False)),
            float(k.get("min_p", 0.0)), rp,
            float(k.get("frequency_penalty", 0.0)),
            float(k.get("presence_penalty", 0.0)),
        )
        need_total = P.blocks_needed(prompt_len, max_tokens, self.kv_block_size)
        req.need = need_total
        blk_ids = self._alloc.alloc(need_total)
        if blk_ids is None:
            return _BLOCKED
        req.block_ids = blk_ids
        table_row = np.zeros((self._max_blocks,), np.int32)
        table_row[:need_total] = blk_ids
        presence_row = np.zeros((cfg.vocab_size,), bool)
        if rp != 1.0:
            presence_row[ids] = True
        job = PrefillJob(req, ids, 0, prompt_len, max_tokens, slot, sampling,
                         presence_row, table_row, self._sched.classify(req.slo))
        self._table[slot] = table_row
        self._table_stale = True
        req.slot = slot
        req.ids = ids
        with self._cv:
            self._assignment[slot] = req
        self._jobs.append(job)
        self._prefilling[slot] = job
        log.info("prefill_started", slot=slot, prompt_len=prompt_len,
                 tail=job.remaining, slo_class=job.cls.name,
                 request_id=req.trace.request_id)
        return job

    def _launch_chunk(self):
        """Launch one decode chunk over the fleet; returns the in-flight
        tuple ("chunk", fetch handle, assignment snapshot, launch time) or
        None when no slot is active."""
        if not any(r is not None for r in self._assignment):
            return None
        if self.paged:
            self._table_device()
        packed = self._chunk_graph()
        self.chunk_launches += 1
        return ("chunk", self._to_host(packed), list(self._assignment),
                time.perf_counter())

    def _chunk_body(self):
        """The decode chunk over the static buffers (a LaunchGraph)."""
        return graphs.decode_chunk(
            self.backend, self.state, self.sparams, self.cache,
            self._table_dev if self.paged else None, self._gen, self.chunk_steps,
        )

    def _mixed_body(self):
        """The mixed launch over the static buffers (a LaunchGraph)."""
        return graphs.mixed_launch(self.backend, self._mixed_in, self.cache,
                                   self._table_dev, self.state, self.sparams,
                                   self._gen)

    def _launch_mixed(self):
        """ONE scheduler step: every decoding slot's token plus the budget
        slice of pending prompt chunks in one mixed launch. Decode rows'
        positions are substituted on the device (DeviceMeta). Returns the
        in-flight tuple ("mixed", fetch handle, decode snapshot, {slot:
        req} completions, launch time) or None."""
        active = [b for b, r in enumerate(self._assignment)
                  if r is not None and b not in self._prefilling]
        plan = self._sched.plan(
            len(active), self._jobs,
            active_classes={self._assignment[b].slo for b in active},
        )
        if not active and not plan:
            return None
        W, B, tile = self._sched_width, self.n_slots, self._ragged_tile
        # decode rows' positions are placeholders: the launch derives them
        # from the slot state on the device (DeviceMeta)
        entries = [(b, 0, 1, P.RAGGED_DECODE) for b in active]
        chunk_list = []
        for job, n in plan:
            start = job.p0 + job.done
            entries.append((job.slot, start, n, P.RAGGED_PREFILL))
            chunk_list.append((job, n, start))
        meta, tok_row, tok_pos, offsets, stats = P.build_ragged_meta(
            entries, width=W, tile=tile)
        n_dec = len(active)
        dev_np = P.build_device_meta(entries, offsets, n_dec, width=W, tile=tile)
        toks = np.zeros((W,), np.int32)
        dec_flag = np.zeros((W,), bool)
        dec_idx = np.zeros((B,), np.int32)
        for b, off in zip(active, offsets[:n_dec]):
            dec_flag[off] = True
            dec_idx[b] = off
        completions = {}
        arm_np = None
        for (job, n, start), off in zip(chunk_list, offsets[n_dec:]):
            toks[off: off + n] = job.ids[start: start + n]
            job.done += n
            job.req.prefill_chunks += 1
            if job.remaining == 0:
                # final chunk: the launch samples this admission's first
                # token and arms its slot on the device
                if arm_np is None:
                    arm_np = self._fresh_arm()
                on, idx, plen, mtk, sp, presence = arm_np
                s = job.slot
                on[s] = True
                idx[s] = off + n - 1
                plen[s] = job.prompt_len
                mtk[s] = job.max_tokens
                for field, value in zip(sp, job.sampling):
                    field[s] = value
                presence[s] = job.presence_row
                completions[s] = job.req
                job.req.budget = job.max_tokens - 1
        # the operands into the launch's static inputs; one arm buffer
        # serves both arms, the idle one copied in on the device
        inp = self._mixed_in
        if arm_np is None:
            graphs.commit(inp.arm, self._idle_arm)
        else:
            on, idx, plen, mtk, sp, presence = arm_np
            a = inp.arm
            self._upload_into((a.on, a.idx, a.prompt_len, a.max_tokens, a.presence,
                               *a.params), (on, idx, plen, mtk, presence, *sp))
        self._upload_into(
            (inp.tokens, inp.tok_row, inp.tok_pos, inp.dec_flag, inp.meta,
             inp.dec_idx, *inp.dev),
            (toks, tok_row, tok_pos, dec_flag, meta, dec_idx, *dev_np))
        self._table_device()
        handle = self._to_host(self._mixed_graph())
        for slot in completions:
            self._jobs.remove(self._prefilling.pop(slot))
        n_pf_tokens = sum(n for _, n, _ in chunk_list)
        self.mixed_launches += 1
        if n_dec and chunk_list:
            self.mixed_with_both += 1
        self._m.sched_rows.inc(n_dec)
        self._m.sched_chunks.inc(len(chunk_list))
        self._m.sched_tokens.labels(kind="decode").inc(n_dec)
        self._m.sched_tokens.labels(kind="prefill").inc(n_pf_tokens)
        if stats["prefill_rows"]:
            self._m.ragged_rows.labels(kind="prefill").inc(stats["prefill_rows"])
        if stats["decode_rows"]:
            self._m.ragged_rows.labels(kind="decode").inc(stats["decode_rows"])
        self._m.ragged_tiles.labels(state="pad").inc(stats["pad_tiles"])
        self._m.ragged_tiles.labels(state="live").inc(
            stats["tiles"] - stats["pad_tiles"])
        self._m.ragged_launches.labels(phase="mixed").inc()
        snapshot = [self._assignment[b] if b in active else None for b in range(B)]
        return ("mixed", handle, snapshot, completions, time.perf_counter())

    def _fresh_arm(self):
        """Mutable numpy MixedArm builder (one per launch WITH completions;
        other steps reuse the device-resident idle arm)."""
        B, V = self.n_slots, self.cfg.vocab_size
        return (
            np.zeros((B,), bool), np.zeros((B,), np.int32),
            np.zeros((B,), np.int32), np.zeros((B,), np.int32),
            [np.ones((B,), np.float32), np.zeros((B,), np.int32),
             np.ones((B,), np.float32), np.ones((B,), bool),
             np.zeros((B,), np.float32), np.ones((B,), np.float32),
             np.zeros((B,), np.float32), np.zeros((B,), np.float32)],
            np.zeros((B, V), bool),
        )

    def _process_mixed(self, step):
        """Fetch one mixed step's packed results: first-token bookkeeping
        for admissions that completed in that launch, then the shared
        decode distribution."""
        _, handle, snapshot, completions, t_launch = step
        packed = self._fetch(handle)
        self._m.step.observe(max(0.0, time.perf_counter() - t_launch))
        emitted, mask, active, firsts = packed[:4]
        now = time.time()
        for slot, req in completions.items():
            if req.done.is_set():
                continue
            req.first_id = int(firsts[slot])
            if not req.ttft:
                req.ttft = now - req.t_start
            self._count_admission(req)
            self._post_admit(req)
        self._distribute(emitted[None, :], mask[None, :].astype(bool),
                         active.astype(bool), snapshot)

    def _count_admission(self, req: _Request):
        """Admission bookkeeping once req's prompt landed in its slot."""
        req.trace.checkpoint("admission")
        with self._cv:
            self.admitted += 1
            if req.record:
                self.engine.request_count += 1
            occ = sum(r is not None for r in self._assignment)
            self.peak_occupancy = max(self.peak_occupancy, occ)
        self._m.occupied.set(occ)
        if req.record:
            self._m.admission_wait.observe(time.time() - req.enqueued)
        log.info("admitted", slot=req.slot, prompt_len=req.prompt_tokens,
                 budget=req.budget, occupancy=occ, chunked=self._chunked,
                 request_id=req.trace.request_id)

    # -- whole-prefill admission ---------------------------------------------
    def _admit(self):
        """Prefill and arm every queued request a free slot (and, paged,
        pool blocks) can take. The wave's first tokens come back in ONE
        stacked copy at the end: the stop / budget decision already ran
        on the device when each slot was armed."""
        wave = []  # (req, first token [1] on the device)
        while True:
            with self._cv:
                if not self._queue:
                    break
                free = [b for b, r in enumerate(self._assignment) if r is None]
                if not free:
                    break
                head = self._queue[0]
                if self.paged and head.need is not None \
                        and head.need > self._alloc.free_blocks:
                    break  # a sized head that still cannot get blocks waits
                req = self._queue.pop(0)
                self._note_queue_locked()
            try:
                self._admitting = req
                first = self._admit_one(req, free[0])
                self._admitting = None
            except ValueError as e:
                self._admitting = None
                self._free_slot_resources(req)
                log.warning("invalid_request", error=str(e))
                req.result = {"error": f"Error: {e}", "status": "failed",
                              "error_type": "invalid_request"}
                self._push_final(req)
                continue
            if first is _BLOCKED:
                # the pool cannot take it now: back to the front, and the
                # fleet keeps decoding until a release frees blocks
                with self._cv:
                    self._queue.insert(0, req)
                    self._note_queue_locked()
                break
            if first is not None:  # None: failed fast, its result is set
                wave.append((req, first))
        if not wave:
            return
        firsts = torch.cat([f.reshape(1) for _, f in wave]).tolist()
        now = time.time()
        for (req, _), first_id in zip(wave, firsts):
            req.first_id = int(first_id)
            if not req.ttft:
                req.ttft = now - req.t_start
            self._post_admit(req)

    def _admit_one(self, req: _Request, slot: int):
        """Prefill req's whole prompt and arm `slot` (the cold,
        unconstrained, adapter-free admission of the JAX package).
        Returns its first token ([1], on the device), None when it failed
        fast (its result is set), or _BLOCKED when the pool cannot take
        it now."""
        eng, cfg = self.engine, self.cfg
        if self._expired_in_queue(req):
            return None
        k = req.kwargs
        text = eng.render_chat(req.prompt) if k.get("chat", True) else req.prompt
        ids = eng.tokenizer.encode(text)
        req.prompt_tokens = prompt_len = len(ids)
        p0, entry, plan = eng._prefix_plan(None, ids, capacity=self.slot_max_seq,
                                           ragged=self._ragged)
        if plan is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the slot capacity "
                f"(slot_max_seq {self.slot_max_seq})"
            )
        max_tokens, _ = eng._clamp_decode(
            prompt_len, int(k.get("max_tokens", 20)), capacity=self.slot_max_seq,
        )
        req.allowed = max_tokens
        table_row = None
        if self.paged:
            need_total = P.blocks_needed(prompt_len, max_tokens, self.kv_block_size)
            req.need = need_total
            blk_ids = self._alloc.alloc(need_total)
            if blk_ids is None:
                return _BLOCKED
            req.block_ids = blk_ids
            table_row = np.zeros((self._max_blocks,), np.int32)
            table_row[:need_total] = blk_ids  # the tail stays at the trash block
        try:
            sampling = G.default_sampling(
                k.get("temperature", 0.7), k.get("top_k", 50),
                k.get("top_p", 0.9), k.get("greedy", False),
                k.get("min_p", 0.0), k.get("repetition_penalty", 1.0),
                k.get("frequency_penalty", 0.0), k.get("presence_penalty", 0.0),
            )
            # the prompt's token set rides the first-token sample only when
            # the repetition penalty is on (the solo prefill's program)
            presence = (eng._presence_rows([ids]) if sampling.rep_penalty != 1.0
                        else None)
            if self._ragged:
                first = self._ragged_ingest(ids, table_row, sampling, presence)
                req.prefill_chunks = -(-prompt_len // self._ragged_width)
            else:
                # the scratch is written in place and spliced below: a
                # failed ingest leaves it usable for the next admission
                first, _, _ = eng._ingest_with_prefix(
                    None, ids, p0, entry, plan, self._scratch, self._gen,
                    sampling, presence=presence,
                )
                req.prefill_chunks = plan[0] + 1
            req.budget = max_tokens - 1
            presence_row = (presence[0] if presence is not None else
                            torch.zeros((cfg.vocab_size,), dtype=torch.bool,
                                        device=self.device))
            arm = (first, prompt_len, max_tokens, *sampling, presence_row)
            # the cache is written in place; the armed state goes into the
            # static one
            if self._ragged:  # the prompt's K/V is in its blocks already
                self._commit(*self.backend.arm_slot_paged(
                    self.state, self.sparams, slot, *arm))
            elif self.paged:
                (row_d,) = self._upload(table_row)
                self._commit(*self.backend.insert_slot_paged(
                    self.cache, self._scratch, self.state, self.sparams, slot,
                    row_d, *arm)[1:])
            else:
                self._commit(*G.insert_slot(
                    cfg, self.cache, self._scratch, self.state, self.sparams,
                    slot, *arm)[1:])
        except BaseException:
            if req.block_ids is not None:
                # the admission died after its block grant: give them back
                self._alloc.decref(req.block_ids)
                req.block_ids = None
            raise
        if self.paged:
            self._table[slot] = table_row
            self._table_stale = True  # copied in before the next launch
        req.ids = ids
        req.slot = slot
        with self._cv:
            self._assignment[slot] = req
        self._count_admission(req)
        return first

    def _ragged_launch_args(self, chunk_ids, start: int):
        """One whole-prefill ragged launch's device operands (tokens,
        tok_row, tok_pos, meta) for chunk_ids at `start` of table row 0,
        counted into the dli_ragged_* families."""
        W, tile = self._ragged_width, self._ragged_tile
        meta, tok_row, tok_pos, _, stats = P.build_ragged_meta(
            [(0, start, len(chunk_ids), P.RAGGED_PREFILL)], width=W, tile=tile)
        toks = np.zeros((W,), np.int32)
        toks[:len(chunk_ids)] = chunk_ids
        self._m.ragged_rows.labels(kind="prefill").inc(stats["prefill_rows"])
        self._m.ragged_tiles.labels(state="pad").inc(stats["pad_tiles"])
        self._m.ragged_tiles.labels(state="live").inc(
            stats["tiles"] - stats["pad_tiles"])
        return self._upload(toks, tok_row, tok_pos, meta)

    def _ragged_ingest(self, ids, table_row, sampling, presence):
        """Prefill ids straight into the pool: whole-width extend launches
        for the body, then ONE width-padded prefill launch that samples
        the first token off the last prompt token, all over the one-row
        table [1, MB] of this admission. Returns the first token [1]."""
        be, W = self.backend, self._ragged_width
        n_full = max(0, (len(ids) - 1) // W)  # leaves >= 1 sampling token
        (table1,) = self._upload(table_row[None, :])
        for c in range(n_full):  # the pool is written in place
            args = self._ragged_launch_args(ids[c * W:(c + 1) * W], c * W)
            be.extend_ragged_paged(*args, self.cache, table1)
            self._m.ragged_launches.labels(phase="extend").inc()
        rem = ids[n_full * W:]
        args = self._ragged_launch_args(rem, n_full * W)
        first, _, _ = be.prefill_ragged_paged(
            *args, self.cache, table1, len(rem) - 1, self._gen, sampling,
            presence=presence)
        self._m.ragged_launches.labels(phase="prefill").inc()
        return first

    def _post_admit(self, req: _Request):
        """A stop token first, or a zero budget, finishes the request at
        once (mirroring the on-device arming decision)."""
        if req.first_id in self.cfg.all_stop_ids or req.budget == 0:
            self._finalize(req)

    def _process(self, step):
        """Fetch one decode chunk's packed results and distribute them."""
        _, handle, snapshot, t_launch = step
        packed = self._fetch(handle)  # [2K+1, B] — ONE copy per chunk
        self._m.step.observe(
            max(0.0, time.perf_counter() - t_launch) / self.chunk_steps)
        K = self.chunk_steps
        self._distribute(packed[:K], packed[K: 2 * K].astype(bool),
                         packed[2 * K].astype(bool), snapshot)

    def _distribute(self, emitted, mask, active, snapshot):
        """Attribute one fetched launch's emissions ([K, B] + final active
        row) to the snapshot's tenants and handle stop / deadline
        / finalize."""
        deadline = self.engine.engine_cfg.request_deadline_s
        now = time.time()
        for b, req in enumerate(snapshot):
            if req is None or req.done.is_set():
                continue  # a freed tenant's masked leftovers
            new = emitted[mask[:, b], b]
            req.tokens.extend(int(t) for t in new)
            gen = None
            if len(new) and req.kwargs.get("stop"):
                gen = self._gen_text(req)
                if gen[2]:  # a textual stop sequence fired: free the slot now
                    if self._assignment[b] is req:
                        self._commit(G.kill_slot(self.state, b))
                        self._m.preempt.labels(reason="stop").inc()
                    self._finalize(req, pre=gen)
                    continue
            if self._assignment[b] is req and not active[b]:
                self._finalize(req, pre=gen)
            elif self._past_deadline(req, now) and self._assignment[b] is req:
                self._commit(G.kill_slot(self.state, b))
                self._m.preempt.labels(reason="deadline").inc()
                req.result = self._deadline_env(req)
                self._release(req)
            elif deadline and now - req.t_start > deadline:
                self._commit(G.kill_slot(self.state, b))
                self._m.preempt.labels(reason="deadline").inc()
                req.result = {"error": f"Error: request exceeded the {deadline:g}s "
                              "deadline", "status": "failed", "error_type": "timeout"}
                self._release(req)

    def _gen_text(self, req: _Request) -> tuple:
        """(generated ids, stop-truncated text, stop hit) for req."""
        head = ([req.first_id] if req.first_id is not None
                and req.first_id not in self.cfg.all_stop_ids else [])
        gen_ids = head + req.tokens
        text = self.engine.tokenizer.decode(gen_ids, skip_special_tokens=True)
        cut, hit = self.engine._truncate_at_stop(text, req.kwargs.get("stop"))
        return gen_ids, cut, hit

    def _finalize(self, req: _Request, pre=None):
        req.trace.checkpoint("decode")
        gen_ids, response, stopped = pre if pre is not None else self._gen_text(req)
        req.trace.checkpoint("detokenize")
        elapsed = time.time() - req.t_start
        n = len(gen_ids)
        tps = n / elapsed if elapsed > 0 else 0.0
        tpot = max(0.0, elapsed - req.ttft) / (n - 1) if n > 1 else None
        if req.record:
            self.engine._record_sample(req.ttft, tps, n, elapsed=elapsed,
                                       engine="continuous")
            self._sched.observe(req.slo, req.ttft or None, tpot)
            # the per-tenant twin of the same samples (no-op when anonymous)
            self._sched.observe_tenant(req.tenant, req.ttft or None, tpot)
        req.result = {
            "prompt": req.prompt,
            "response": response,
            "status": "success",
            "time_taken": f"{elapsed:.2f}s",
            "tokens_generated": n,
            "prompt_tokens": req.prompt_tokens,
            "tokens_per_sec": f"{tps:.2f}",
            "ttft_s": round(req.ttft, 4),
            "backend": "continuous",
            "continuous": True,
            "finish_reason": "stop" if stopped or n < req.allowed else "length",
            "prefill_chunks": req.prefill_chunks,
            "token_ids": gen_ids,
        }
        if req.slo is not None:
            req.result["slo_class"] = req.slo
        if req.tenant is not None:
            req.result["tenant"] = req.tenant
        if stopped:
            req.result["stopped"] = True
        log.info("completed", slot=req.slot, tokens=n,
                 elapsed_s=round(elapsed, 3), tokens_per_sec=round(tps, 2))
        self._release(req)

    def _free_slot_resources(self, req: _Request):
        """Return req's pool blocks, table row and slot (and drop a
        pending prefill job) without finalizing it."""
        if req.slot is not None:
            job = self._prefilling.pop(req.slot, None)
            if job is not None and job in self._jobs:
                self._jobs.remove(job)
        if req.block_ids is not None:
            # freed blocks may be re-granted before in-flight launches
            # drain: safe, device execution is serialized in launch order
            # and this slot's table row reverts to trash for later launches
            self._alloc.decref(req.block_ids)
            req.block_ids = None
            if req.slot is not None:
                self._table[req.slot] = 0
                self._table_stale = True
        with self._cv:
            if req.slot is not None and self._assignment[req.slot] is req:
                self._assignment[req.slot] = None
            occ = sum(r is not None for r in self._assignment)
            self._cv.notify_all()
        self._m.occupied.set(occ)

    def _release(self, req: _Request):
        self._free_slot_resources(req)
        with self._cv:
            self.completed += 1
        self._push_final(req)

    def _push_final(self, req: _Request):
        """Single completion point: attach request id + timings, count the
        request (warmup excluded), then wake submit()."""
        if req.result is not None:
            self.engine._finish_request(req.result, req.trace,
                                        engine="continuous", record=req.record)
        req.done.set()
