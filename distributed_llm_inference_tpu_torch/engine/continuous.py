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

Preemption (engine_cfg.preempt_policy, the JAX default "swap"): when the
pool cannot place an admission, _preempt_for evicts the lowest-SLO-weight
/ youngest decoding request (scheduler.select_victim): its fetched tokens
fold into its salvage record, its blocks go back, and it is parked in
`_resume`, which re-enters admission before the queue as a CONTINUATION
prefill (prompt + salvaged tokens) — greedy output bit-identical to an
unpressured run. Under "swap" with a KV shadow the victim's filled blocks
are flushed to the host shadow first and its resume restores them in one
scatter (_prepare_resume), re-prefilling only the tail; with no shadow
"swap" recomputes, as the JAX fleet does. A request preempted
max_preemptions_per_req times becomes immune.

The block-prefix cache (engine/block_prefix.py, prefix_cache_entries >
0): a prompt whose head matches a cached chain of full blocks maps those
physical blocks into its table, refcounted, and prefills only the tail —
ragged at the exact cached depth, bucketed degraded to a depth its tail
bucket fits, over a scratch gathered from the pool (`fill_scratch_paged`).
A completed prompt registers its full blocks; the pool-pressure ladder
evicts unreferenced chains before it preempts. Shared blocks are never
written: a hit's writes land at positions past its head, launch padding
and the restore's pad rows in the trash block.

The KV shadow (engine/shadow.py, kv_shadow, on wherever the block-prefix
index is): every filled block is gathered behind the launch that filled
it and copied to host memory off the scheduler thread. A supervisor
restart restores the shadowed chains into the rebuilt pool IN PLACE
before re-admitting anything, so salvaged requests hit them and
re-prefill only their partial tail block; a drain persists the shadow to
`restore_dir` and a fleet started on it restores it before serving; an
optional disk tier (kv_disk_dir) takes the host tier's LRU evictions and
promotes a chain back on admission. Every restore writes the static pool
in place, so the captured CUDA graphs stay valid.

The cross-replica KV fabric (serving/kv_fabric.py, kv_fabric, on wherever
the shadow is): the shadow's chains are served by chunk digest (the
server's GET /kv/{digest}, whole or streamed, and POST /kv for a peer's
pushed chain), and a router's hint (`kv_hint`, the X-KV-Transfer-*
headers) makes the admission pull the named chain from its peer before
the prefix plan, scatter it into the pool in place (the restore's path)
and register it, so the plan sees a deeper hit. Every failure (a dead or
wedged peer, a 404, a failed content-key recheck, leaves that are not
this pool's) is counted as a miss and ends in the local cold prefill. A
`prefill_only` request (the handoff's phase 1) samples one token, waits
for its shadow copies to land and can push its chain to the decode
replica (`kv_push_to`). The envelope carries `kv_digests` and
`kv_fabric_blocks`.

Failure containment, as in the JAX package: the worker loop runs under a
supervisor (_loop / _supervise). A crash releases every fleet-held
resource, resets the device-side fleet IN PLACE (the captured CUDA graphs
keep pointing at the same buffers, so each launch kind stays captured
once), and restarts the loop under a bounded consecutive-crash budget
with exponential backoff. Live requests are salvaged and re-admitted one
per healthy chunk (_run_recovery), so a recurring crash implicates one
suspect, and a request implicated poison_strikes times fails alone
(error_type "poison"). Past the budget every waiter gets a clean
"unavailable" envelope and the fleet is dead (not ready). A device fault
that poisons the CUDA context makes the in-place reset raise too: that
counts as the next crash, so such a fault ends in the same clean death.
utils/faults.py injection points (admission, alloc, prefill,
decode_launch, fetch, preempt) drive every path in the tests.

Speculation on the mixed launch (a chunked fleet with spec_draft_len > 0,
the JAX default; _init_spec): an eligible greedy request's slot carries a
[current + K drafts] verify row in place of its decode row, accepted or
rejected on the device, its emissions spliced into the fetch; n-gram
drafts (positions derived on the device, back to back, K adapting per
slot; or the host-planned freeze) or a draft model's chain over a draft
pool that shares the block tables. A launch with no verify row and no
frozen slot is the plain mixed launch; the verify launch, the draft fill
and the propose chain are launch kinds of their own.

Streaming and cancellation, as in the JAX package: stream() yields a
request's text as deltas, pushed by the worker when its first token and
each later launch that adds text are fetched (a partial UTF-8 character
and a textual stop's possible start held back, so the joined deltas
equal the response), then its envelope. cancel() (a closed stream, a
client gone) dequeues a waiting request at once, or flags an admitted
one, whose slot the worker kills and whose blocks it frees at the next
launch boundary, as a deadline kill does; dli_cancelled_total{cause}
counts them.

Runtime LoRA adapters, as in the JAX package: on a ragged paged fleet
over an engine with an adapter pool (engine/adapters.py), a request
naming a registered `adapter` holds that adapter's pool page while it
holds its slot (a pool with every page referenced backpressures the
admission as an empty block pool does). Each slot's page rides every
target launch as a static device operand (0 = the base page), so the
mixed launch and the decode chunk stay one CUDA graph each for any
adapter mix. Adapter KV is fenced from every token-keyed reuse surface
but the block-prefix index, where it hangs under the adapter's own root:
the shadow, the fabric and the digest export never see it, and a
preempted adapter request always recomputes.

Grammar constraints (constrain/), as in the JAX package: the dense fleet
serves constrained tenants beside unconstrained ones. Admission compiles
the constraint through the engine's LRU and acquires its rows in the
fleet's combined table (constrain/fleet.py; a full table backpressures
like an empty block pool), the first token is sampled under the mask of
the DFA state its salvaged continuation reaches, and the slot's row of
the static FSM vector `_fsm` is set in place before the next launch.
While any constrained tenant is active the decode chunk is the
constrained kind (engine/graphs.decode_chunk_constrained, captured once
per table bucket the fleet crosses); otherwise the plain one, which
leaves `_fsm` alone: release sets a slot's row back to the free state 0,
so every live row is at 0 whenever no tenant is constrained. The paged
fleet, a DFA that can never fit the table and a malformed spec go to the
solo engine (which answers the malformed spec with a 400).

The dense fleet's prefix cache (prefix_cache_entries > 0 with no pool)
is the solo engine's snapshot kind (engine/prefix.py), its own instance:
a hit splices the snapshot into the admission scratch in place and
prefills the tail; the completed prompt's snapshot is stored.

Both families ride every fleet: gpt2 through the shared attention hook
seam (its learned positions gathered per flat token on the mixed launch),
the MoE llama configs as llama (the expert banks inside each layer).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..ops.kv_quant import KVQuant
from ..utils import faults
from ..utils.logging import get_logger
from ..utils.metrics import register_fleet_metrics
from ..utils.tracing import Trace, sample_decision
from . import generate as G
from . import graphs
from . import paged as P
from .block_prefix import BlockPrefixIndex, chunk_digests
from .prefix import PrefixCache
from .scheduler import MIN_SHED_DEPTH, PrefillJob, TokenBudgetScheduler, parse_slo_classes

log = get_logger("continuous")

# _start_job sentinel: the pool has no blocks for this request right now —
# requeue it (front) and retry after the next release
_BLOCKED = object()


def _zero_tree(tree):
    """Zero every tensor of a cache tree (dicts, tuples, KVQuant leaves)
    in place. A KVQuant is zeroed leaf by leaf: iterating it would slice
    it down its axes one index at a time."""
    if isinstance(tree, torch.Tensor):
        tree.zero_()
    elif isinstance(tree, KVQuant):
        tree.q.zero_()
        tree.s.zero_()
    elif isinstance(tree, dict):
        for v in tree.values():
            _zero_tree(v)
    else:
        for v in tree:
            _zero_tree(v)


class _Request:
    __slots__ = (
        "prompt", "kwargs", "done", "result", "t_start", "ttft", "first_id",
        "tokens", "slot", "enqueued", "budget", "record", "prompt_tokens",
        "block_ids", "need", "trace", "allowed", "slo", "ids", "deadline_at",
        "prefill_chunks", "tenant", "salvaged", "strikes", "recovering",
        "preemptions", "preempted_at", "drop_seq", "prefix_hit_tokens",
        "shadow_depth", "resume_seq", "promoted_blocks", "kv_hint",
        "fabric_blocks", "trace_ctx", "spec_want", "spec_drafted",
        "spec_accepted", "spec_launches", "stream_q", "streamed_text",
        "cancelled", "cancel_cause", "adapter", "adapter_page", "cart",
        "profiled",
    )

    def __init__(self, prompt: str, kwargs: dict, request_id=None, tenant=None,
                 kv_hint=None, trace_ctx=None, stream_q=None, adapter=None):
        self.prompt = prompt
        # the registered runtime adapter it runs under (None: the base
        # model), and the adapter-pool page it holds once admitted
        self.adapter = adapter
        self.adapter_page: Optional[int] = None
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
        # tokens fetched before a crash or a preemption, re-prefilled as a
        # continuation on re-admission so greedy decode resumes bit-exactly
        self.salvaged: list = []
        # crash-restarts this request was implicated in (the suspect set
        # at crash time); poison_strikes of them quarantine it
        self.strikes = 0
        # set while recovery re-admits it (recomputed-prefill accounting)
        self.recovering = False
        # times evicted for pool room (max_preemptions_per_req makes it
        # immune) and when it was last parked (dli_preempted_resume_seconds)
        self.preemptions = 0
        self.preempted_at = 0.0
        # launch-seq barrier: emissions of launches that started before
        # this seq are dropped (a preempted victim's launches in flight)
        self.drop_seq = 0
        # prompt tokens served from the block-prefix cache (the mapped head)
        self.prefix_hit_tokens = 0
        # full blocks of this admission already handed to the shadow
        self.shadow_depth = 0
        # a "swap" victim's token sequence (prompt + fetched tokens) whose
        # shadowed chain its resume restores; None: recompute
        self.resume_seq = None
        # prefix blocks promoted out of the shadow hierarchy at admission
        self.promoted_blocks = 0
        # a router's KV-fabric hint, {"peer": url, "digest": hex}: where
        # this prompt's prefix chain is resident. Consumed by the FIRST
        # admission attempt; requeues and salvages never fetch again
        self.kv_hint = kv_hint
        # prefix blocks imported over the fabric for this request
        self.fabric_blocks = 0
        # the request's trace context (its traceparent rides the fabric),
        # and whether its launches are attributed (sample_decision)
        self.trace_ctx = trace_ctx
        self.profiled = False
        # speculation: the request asked for it ("speculative": true; the
        # fleet-wide spec_decode makes every eligible greedy request a
        # candidate too), and its draft / accept / verify-row counts
        self.spec_want = bool(kwargs.get("speculative"))
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_launches = 0
        # token streaming (stream()): the worker pushes delta events and the
        # final envelope here; None for a request that does not stream
        self.stream_q = stream_q
        self.streamed_text = ""  # text already streamed (the deltas' sum)
        # the client went away (cancel()): the worker frees the slot early,
        # and why (dli_cancelled_total{cause})
        self.cancelled = False
        self.cancel_cause = "disconnect"
        # grammar constraint (constrain/): (CompiledConstraint, fleet-table
        # row offset) once admitted; None = unconstrained
        self.cart = None


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
        restart_budget: int = 3,
        restart_backoff_s: float = 0.05,
        poison_strikes: int = 2,
        kv_shadow: Optional[bool] = None,
        restore_dir: Optional[str] = None,
    ):
        cfg = engine.cfg
        ecfg = engine.engine_cfg
        if cfg.arch not in ("llama", "gpt2"):
            raise ValueError(
                f"continuous batching supports the llama and gpt2 families; "
                f"model arch is {cfg.arch!r}"
            )
        backend = engine.backend
        if not getattr(backend, "supports_slots", False):
            raise ValueError(
                f"backend {backend.name!r} does not support slot "
                f"decode; continuous batching runs on the single-device "
                f"backend or a pp pipeline mesh with dp == 1"
            )
        self.paged = kv_pool_blocks is not None
        if self.paged and not getattr(backend, "supports_paged", False):
            raise ValueError(f"backend {backend.name!r} does not support paged "
                             f"KV; drop kv_pool_blocks or use the dense fleet")
        # KV preemption under pool pressure ("swap" restores the victim's
        # chain from the KV shadow when the fleet has one, else recomputes)
        self.preempt_policy = str(ecfg.preempt_policy)
        if self.preempt_policy not in ("swap", "recompute", "off"):
            raise ValueError(
                f"preempt_policy must be 'swap', 'recompute', or 'off', "
                f"got {self.preempt_policy!r}"
            )
        self.max_preemptions = max(0, int(ecfg.max_preemptions_per_req))
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
            # each slot's adapter-pool page (0 = the base page), set beside
            # its table row at admission and zeroed at release
            self._slot_pages = np.zeros((self.n_slots,), np.int32)
            self._ragged_width = -(-max(1, int(ecfg.ragged_width))
                                   // self._ragged_tile) * self._ragged_tile
        else:
            self._scratch_seq = self.slot_max_seq
            self.cache = self.backend.init_cache(self.n_slots, self.slot_max_seq)
        self._chunked = bool(self._ragged and ecfg.chunked_prefill
                             and getattr(backend, "supports_mixed_step", False))
        # the engine's adapter pool, honored only where every launch can
        # carry the pages operand (the ragged paged fleet); every other
        # fleet answers an adapter request with a 400 envelope. The pages
        # are a static device input of the launches, copied in place from
        # _slot_pages before a launch once they changed
        self._adapters = (getattr(engine, "adapters", None)
                          if self.paged and self._ragged else None)
        self._pages_dev = (torch.zeros((self.n_slots,), dtype=torch.int32,
                                       device=self.device)
                           if self._adapters is not None else None)
        self._pages_stale = False
        # block-level prefix sharing (engine/block_prefix.py): a hit MAPS
        # the cached physical blocks into the request's table
        self._bpx = (BlockPrefixIndex(self._alloc, self.kv_block_size,
                                      registry=engine.metrics)
                     if self.paged and ecfg.prefix_cache_entries > 0 else None)
        # warm-state recovery (engine/shadow.py): the host-side shadow of
        # filled pool blocks. It needs the paged fleet (block immutability
        # is the consistency argument) and the block-prefix index (a
        # restore re-enters through the ordinary prefix-hit machinery).
        self._shadow = None
        self._restore_dir = restore_dir
        self._needs_restore = False
        self.shadow_restored_total = 0
        use_shadow = ecfg.kv_shadow if kv_shadow is None else kv_shadow
        if (self.paged and use_shadow and self._bpx is not None
                and hasattr(backend, "gather_shadow_blocks")):
            from .shadow import ShadowStore

            self._shadow = ShadowStore(
                self.kv_block_size,
                max_blocks=ecfg.kv_shadow_blocks or 2 * self._pool_blocks,
                registry=engine.metrics, disk_dir=ecfg.kv_disk_dir,
                max_disk_blocks=ecfg.kv_disk_blocks,
            )
            if restore_dir and self._shadow.load(restore_dir):
                # a drained predecessor's blocks and chains: restored by the
                # worker thread before it serves anything
                self._needs_restore = True
        # the capture's gather width (callers pad by repeating a block) and
        # the restore's scatter width (pad rows go to the trash block)
        self._shadow_gather_w = 8
        self._shadow_restore_w = 32
        if self._shadow is not None and self._cuda:
            self._prewarm_pinned()
        # the cross-replica KV fabric (serving/kv_fabric.py): this
        # replica's fetch client and the serving half's gate. It rides the
        # shadow's stack: the store holds the servable chains, the
        # restore's in-place scatter lands fetched ones, the block-prefix
        # index registers them
        self.replica_class = str(ecfg.replica_class)
        if self.replica_class not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"replica_class must be 'prefill', 'decode', or 'mixed', "
                f"got {self.replica_class!r}"
            )
        self._fabric = None
        self.fabric_serving = bool(self._shadow is not None and ecfg.kv_fabric)
        if self.fabric_serving:
            from ..serving.kv_fabric import KVFabricClient

            self._fabric = KVFabricClient(registry=engine.metrics,
                                          role=self.replica_class,
                                          timeout_s=ecfg.kv_fabric_timeout_s)
        # streamed pulls (frames scattered as they arrive) or whole blobs,
        # and the /health residency cap (MRU first)
        self._fabric_stream = bool(ecfg.kv_fabric_stream)
        self._kv_health_digests = max(1, int(ecfg.kv_health_digests))
        # the bucketed admissions' batch-1 prefill cache, written in place
        # and spliced into the slot; the ragged ingest needs none
        self._scratch = (None if self._ragged
                         else self.backend.init_cache(1, self._scratch_seq))
        # the dense fleet's prefix snapshots (engine/prefix.py): its own
        # PrefixCache, not the solo engine's (that one is touched under the
        # engine lock, this one on the worker), spliced into the scratch in
        # place, so the scratch keeps its address
        self._prefix = None
        if not self.paged and ecfg.prefix_cache_entries > 0:
            if PrefixCache.compatible(self._scratch):
                self._prefix = PrefixCache(ecfg.prefix_cache_entries, ecfg.prefix_chunk,
                                           registry=engine.metrics, scope="continuous")
            else:
                log.info("prefix_cache_disabled", reason="cache layout")
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
        # the launch kinds, captured as CUDA graphs on their first launch;
        # a backend whose programs span processes (a mesh) declares them
        # eager, and its launches run as they are on every call
        self._eager = not getattr(backend, "supports_graphs", True)
        self._chunk_graph = graphs.LaunchGraph(self._chunk_body, "decode_chunk",
                                               self.device, self._gen, self._eager)
        self._mixed_graph = (graphs.LaunchGraph(self._mixed_body, "mixed_launch",
                                                self.device, self._gen, self._eager)
                             if self._chunked else None)
        # grammar constraints (constrain/): the static per-slot FSM states
        # into the COMBINED resident table (row 0 = the free state every
        # unconstrained slot sits at), the table registry, and the
        # constrained decode chunk, one graph per table bucket crossed
        from ..constrain import FleetConstraintTable

        self._fsm = torch.zeros((self.n_slots,), dtype=torch.int32,
                                device=self.device)
        self._ctable = FleetConstraintTable(
            cfg.vocab_size, max_states=ecfg.constraint_fleet_states,
            registry=engine.metrics)
        self._cchunk_graphs: dict = {}  # bucket -> LaunchGraph
        self.constrained_chunk_launches = 0
        self._init_spec(engine)
        self._cv = threading.Condition()
        self._queue: list = []  # guarded-by: _cv
        self._assignment: list = [None] * self.n_slots  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._draining = False  # guarded-by: _cv
        # preempted requests parked for re-admission, served BEFORE the
        # queue (a victim must not also lose its place)
        self._resume: list = []  # guarded-by: _cv
        self.preempted_total = 0
        # the supervisor: how many CONSECUTIVE crashes it absorbs (a
        # healthy fetch resets the window), the backoff base doubled per
        # consecutive crash, and the crash implications that quarantine a
        # request as poison
        self.restart_budget = max(0, int(restart_budget))
        self.restart_backoff_s = float(restart_backoff_s)
        self.poison_strikes = max(1, int(poison_strikes))
        self._dead = False  # the restart budget ran out
        self._restarting = False  # mid crash-recovery (not ready)
        self._recovery: list = []  # salvaged, awaiting re-admission
        # requests admitted since the last healthy fetch: the crash suspects
        self._suspects: set = set()
        self._consecutive_crashes = 0
        # bumped per admission and preemption; each launch snapshots it
        self._mutation_seq = 0
        # launch-level attribution (engine_cfg.trace_sample_rate): a record
        # appended at dispatch and closed at the matching packed fetch,
        # matched by the launch's own perf_counter stamp, so lag-pipelined
        # launches attribute right with no device sync. At rate 0 the hot
        # path's only cost is one float compare: _prof_note_launch is never
        # called and the deque stays empty
        self._trace_rate = float(engine.engine_cfg.trace_sample_rate)
        self._launch_log: collections.deque = collections.deque()
        self.restarts_total = 0
        self.recovered_total = 0
        self.poisoned_total = 0
        # the request an admission is serving right now: it survives an
        # exception unwind on purpose, the supervisor salvages it
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

    def _init_spec(self, engine):
        """Speculation on the mixed launch (chunked fleets with
        spec_draft_len > 0, the JAX default): an eligible greedy decode slot
        carries a [current + K-draft] verify row in the mixed launch. Two
        position disciplines, as in the JAX fleet:
          * spec_device_meta (the default): a verify row's positions derive
            on the device (DeviceMeta), so a slot speculates every step,
            back to back; the host keeps a FIFO of its unfetched verify
            launches (_spec_pending: each one's predicted window, from
            which n-gram drafting continues, and its advance bound for the
            block-capacity clamp), and each slot's draft length adapts to
            its acceptance (scheduler.spec_slot_k);
          * host-planned (spec_device_meta=False): a slot with an
            unfetched verify row gets no row (_spec_inflight) until the
            packed fetch resyncs its host position.
        Drafts come from n-gram lookup in the slot's history or, with
        spec_draft_model (or a draft attached by engine.set_draft), from a
        draft model's greedy chain over its own pool, indexed by the same
        block tables (its blocks share the target's allocation). A launch
        with no verify row and no frozen slot runs the plain mixed launch;
        the verify launch, the draft fill and the propose chain are launch
        kinds of their own, each captured once."""
        ecfg = engine.engine_cfg
        self._spec_k_max = max(0, int(ecfg.spec_draft_len))
        self._spec_auto = bool(ecfg.spec_decode)
        self._spec_capable = bool(self._chunked and self._spec_k_max > 0)
        self._spec_devmeta = bool(self._spec_capable and ecfg.spec_device_meta)
        self._spec_inflight: dict = {}  # host-planned: slot -> (req, n_draft)
        # device-meta: slot -> FIFO of {req, nd, pred, adv} per unfetched
        # verify launch (pred: drafts + predicted correction, n-gram mode;
        # adv: the position-advance bound nd + 1)
        self._spec_pending: dict = {}
        # decode chunks not fetched yet: their many-token advances are
        # unpredictable, so n-gram drafting waits for their fetch
        self._chunk_unfetched = 0
        # launches in flight carrying each slot's row
        self._row_inflight = np.zeros((self.n_slots,), np.int64)
        # the host position model: each slot's write position as far as
        # the host knows it (prompt length at arming, + 1 per plain row,
        # + chunk_steps per decode chunk, + the fetched advance of a verify
        # row). Decode positions derive on the device; this sizes the
        # block-capacity clamp and plans host-planned verify rows
        self._host_pos = np.zeros((self.n_slots,), np.int64)
        self.spec_launches = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # verify rows launched while an earlier one of the slot was still
        # unfetched (0 by construction in the host-planned mode)
        self.spec_pipelined = 0
        self._draft_mode = False
        self._dcfg = self._dparams = self._dpool = None
        self._spec_in = self._spec_graph = None
        self._fill_graph = self._propose_graph = None
        if not self._spec_capable:
            return
        if ecfg.spec_draft_model:
            if getattr(engine, "_draft", None) is None:
                from ..models.registry import get_model_config

                # the named draft at the serving dtype (runtime.py's rule)
                engine.set_draft(get_model_config(ecfg.spec_draft_model)
                                 .replace(dtype=self.cfg.dtype))
            self._dcfg, self._dparams = engine._draft
            self._dpool = P.init_pool(self._dcfg, self._pool_blocks,
                                      self.kv_block_size, device=self.device)
            self._draft_mode = True
        self._spec_in = graphs.spec_inputs(self.n_slots, self._spec_k_max,
                                           device=self.device)
        self._spec_graph = graphs.LaunchGraph(self._spec_body, "mixed_spec",
                                              self.device, self._gen, self._eager)
        if self._draft_mode:
            self._fill_graph = graphs.LaunchGraph(self._fill_body, "draft_fill",
                                                  self.device, self._gen, self._eager)
            self._propose_graph = graphs.LaunchGraph(
                self._propose_body, "draft_propose", self.device, self._gen,
                self._eager)

    # -- client side ---------------------------------------------------------
    def _needs_solo(self, kwargs: dict) -> bool:
        """Contracts slots cannot honor run solo on the wrapped engine (the
        JAX package's rule): a seed, debug, logprobs, logit_bias, beams,
        and speculation on a fleet that cannot speculate (a speculative
        request stays in a spec-capable fleet; a non-greedy or penalized
        one decodes plainly there). A constraint runs solo on the paged
        fleet, when its DFA can never fit the fleet table, or when it is
        malformed (the solo engine answers it with a 400)."""
        if (
            kwargs.get("seed") is not None
            or kwargs.get("debug")
            or (kwargs.get("speculative") and not self._spec_capable)
            or kwargs.get("logprobs")
            or kwargs.get("logit_bias")
            or int(kwargs.get("num_beams", 1) or 1) > 1
        ):
            return True
        if kwargs.get("constraint") is not None:
            if self.paged or not getattr(
                    self.backend, "supports_constrained_slots", False):
                return True
            try:
                art = self.engine._compile_constraint(kwargs["constraint"])
            except ValueError:
                return True  # the solo engine raises it again, as a 400
            if not self._ctable.fits(art):
                return True
        return False

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

    def _cancel_env(self, req: _Request) -> dict:
        """The cancelled envelope (HTTP 499 at the edge), counted by cause."""
        self._m.cancelled.labels(cause=req.cancel_cause).inc()
        return {"error": "Error: request cancelled", "status": "failed",
                "error_type": "cancelled"}

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
            if self._dead:
                return {"error": "Error: the continuous scheduler died after "
                        "exhausting its restart budget", "status": "failed",
                        "error_type": "unavailable"}
            if self._closed:
                return {"error": "Error: server shutting down", "status": "failed",
                        "error_type": "overloaded"}
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
                    self.engine.flight.record(
                        "shed", reason="tenant_quota",
                        request_id=req.trace.request_id, tenant=req.tenant,
                        depth=t_depth, cap=t_cap)
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
                self.engine.flight.record(
                    "shed", reason="queue_full" if full else "slo_drain",
                    request_id=req.trace.request_id, depth=len(self._queue),
                    slo_class=cls.name)
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
        # the KV fabric's handoff surface: the hint is consumed at
        # admission; prefill_only serves phase 1 of a prefill->decode
        # handoff (prefill and shadow the prompt, sample one token, answer
        # once the shadow copies have LANDED, so the decode replica's
        # fetch finds the chain resident), optionally pushing the chain
        # to the decode replica (kv_push_to)
        kv_hint = kwargs.pop("kv_hint", None)
        kv_push_to = kwargs.pop("kv_push_to", None) or None
        trace_ctx = kwargs.pop("trace_ctx", None)
        adapter = kwargs.pop("adapter", None) or None
        tenant = kwargs.pop("tenant", None) or None
        err = self._adapter_reject(adapter, kwargs)
        if err is not None:
            return err
        prefill_only = bool(kwargs.pop("prefill_only", False))
        if prefill_only:
            kwargs["max_tokens"] = 1
        if self._needs_solo(kwargs):
            return self.engine.generate(prompt, **kwargs)
        req = _Request(prompt, kwargs, request_id=kwargs.pop("request_id", None),
                       tenant=tenant, kv_hint=kv_hint, trace_ctx=trace_ctx,
                       adapter=adapter)
        if trace_ctx is not None and trace_ctx.sampled:
            req.profiled = sample_decision(trace_ctx.trace_id, self._trace_rate)
        err = self._enqueue(req)
        if err is not None:
            return err
        req.done.wait()
        if prefill_only and isinstance(req.result, dict):
            if self._shadow is not None:
                self._shadow.flush(timeout_s=10.0)
            req.result.setdefault("prefill_only", True)
            if kv_push_to:
                # the chain is resident now: POST it to the decode replica
                # the router picked; any failure keeps the pull fallback
                pushed = self._fabric_push(req, kv_push_to)
                if pushed:
                    req.result["kv_pushed"] = pushed
        return req.result

    def _adapter_reject(self, adapter, kwargs) -> Optional[dict]:
        """The 400 envelope of an adapter request this fleet cannot serve:
        no pool (not a ragged paged fleet, or adapter_slots 0), an
        unregistered name, or a solo-engine contract (the solo engine
        serves only the base or merged model). None: servable."""
        if adapter is None:
            return None

        def env(msg):
            return {"error": f"Error: {msg}", "status": "failed",
                    "error_type": "invalid_request", "adapter": adapter}

        if self._adapters is None:
            return env("adapter serving needs the ragged paged fleet with an "
                       "attached adapter pool (engine_cfg.adapter_slots > 0)")
        if not self._adapters.is_registered(adapter):
            return env(f"unknown adapter {adapter!r}")
        if self._needs_solo(kwargs):
            return env("adapter requests cannot combine with solo-engine "
                       "contracts (seed / debug / logprobs / logit_bias / "
                       "beams / constraints)")
        return None

    def stream(self, prompt: str, **kwargs):
        """Generator of one request's streaming events: `{"delta": str,
        "tokens_so_far": N}` once its first token is fetched and then once
        per fetched launch that adds text, and last the standard envelope
        with "done": true. The caller iterates on its own thread (an HTTP
        handler writing NDJSON or SSE); the worker pushes into the
        request's queue. A request that runs solo (a seed, debug,
        logprobs, ...) yields its one final envelope. Abandoning the
        generator (close(), a dropped client) cancels the request."""
        import queue

        kv_hint = kwargs.pop("kv_hint", None)
        trace_ctx = kwargs.pop("trace_ctx", None)
        adapter = kwargs.pop("adapter", None) or None
        tenant = kwargs.pop("tenant", None) or None
        err = self._adapter_reject(adapter, kwargs)
        if err is not None:
            yield {**err, "done": True}
            return
        if self._needs_solo(kwargs):
            out = self.engine.generate(prompt, **kwargs)
            out["done"] = True
            yield out
            return
        q: queue.Queue = queue.Queue()
        req = _Request(prompt, kwargs, request_id=kwargs.pop("request_id", None),
                       tenant=tenant, kv_hint=kv_hint, trace_ctx=trace_ctx,
                       stream_q=q, adapter=adapter)
        if trace_ctx is not None and trace_ctx.sampled:
            req.profiled = sample_decision(trace_ctx.trace_id, self._trace_rate)
        err = self._enqueue(req)
        if err is not None:  # yielded outside the fleet's lock
            yield {**err, "done": True}
            return
        try:
            while True:
                ev = q.get()
                yield ev
                if ev.get("done"):
                    return
        finally:
            # the consumer abandoned the stream: free the slot for queued
            # requests instead of decoding to the full budget
            if not req.done.is_set():
                self.cancel(req)

    def cancel(self, req: _Request, cause: str = "disconnect"):
        """Cancel a request: a waiting one (queue or the preemption resume
        queue) leaves at once with its final envelope; an admitted one is
        flagged, and the worker kills its slot and frees its blocks at the
        next launch boundary. `cause` labels dli_cancelled_total."""
        req.cancel_cause = cause
        with self._cv:
            if req in self._queue or req in self._resume:
                if req in self._queue:
                    self._queue.remove(req)
                    self._note_queue_locked()
                else:
                    self._resume.remove(req)
                req.result = self._cancel_env(req)
                self._push_final(req)
                return
            req.cancelled = True
            # wake the worker: the slot frees within one scheduler step
            # even when nothing else is queued
            self._cv.notify_all()

    def _stream_tokens(self, req: _Request, final: bool = False, pre=None):
        """Push the not yet streamed suffix of req's text (worker thread).

        Deltas come from the whole decoded text. Text ending in U+FFFD is
        held back until more tokens arrive (a multi-byte character split
        across launches decodes to a replacement character first and to
        the real one later), and so are the last max(len(stop)) - 1
        characters (a stop string may span launches): the joined deltas
        never run ahead of the response. final=True flushes exactly up to
        the response. pre: (gen_ids, text, hit) from the caller's
        _gen_text, so a launch decodes the sequence once."""
        gen_ids, text, _ = pre if pre is not None else self._gen_text(req)
        if not gen_ids:
            return
        if not final:
            text = text.rstrip("�")
            stop = req.kwargs.get("stop") or ()
            hold = max((len(s) for s in stop if s), default=0) - 1
            if hold > 0:
                text = text[: max(len(req.streamed_text), len(text) - hold)]
        if len(text) > len(req.streamed_text):
            delta = text[len(req.streamed_text):]
            req.streamed_text = text
            req.stream_q.put({"delta": delta, "tokens_so_far": len(gen_ids)})

    @property
    def ready(self) -> bool:
        """Load-balancer readiness: False while draining, while the
        supervisor is mid-restart, or once the scheduler is closed or
        dead. Liveness (/health) stays separate: a restart-looping
        scheduler is alive but should take no new traffic."""
        return not (self._draining or self._restarting or self._dead
                    or self._closed)

    def _work_pending(self) -> bool:
        """Anything the fleet still owes a response for: queued, in a
        slot, mid-admission, salvaged or parked for resume."""
        return bool(self._queue or any(r is not None for r in self._assignment)
                    or self._admitting is not None or self._recovery
                    or self._resume)

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Stop admitting (draining envelopes), then wait for the queue
        and every slot to finish, up to deadline_s. True when drained."""
        t0 = time.time()
        self.engine.flight.record("drain", deadline_s=deadline_s)
        drained = True
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._work_pending():
                if self._closed or self._dead:
                    drained = not self._work_pending()
                    break
                left = None if deadline_s is None else deadline_s - (time.time() - t0)
                if left is not None and left <= 0:
                    drained = False
                    break
                self._cv.wait(timeout=0.1 if left is None else min(left, 0.1))
        if self._shadow is not None and self._restore_dir:
            # the warm handoff: persist the shadow (blocks and chains) so a
            # successor started on restore_dir restores a warm prefix cache
            try:
                self._shadow.flush(timeout_s=5.0)
                self._shadow.save(self._restore_dir)
            except Exception as e:  # noqa: BLE001 - a failed persist is only colder
                log.error("shadow_persist_failed", error=str(e))
        self._m.drain.observe(time.time() - t0)
        log.info("continuous_drained", ok=drained, seconds=round(time.time() - t0, 3))
        return drained

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
            pending = self._queue[:] + self._resume[:]
            self._queue.clear()
            self._resume.clear()
            self._note_queue_locked()
        for req in pending + [r for r in self._assignment if r is not None]:
            if req.result is None:
                req.result = dict(fail)
            self._push_final(req)
        if self._shadow is not None:
            self._shadow.close()

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
        out["preemption"] = {
            "policy": self.preempt_policy,
            "max_per_request": self.max_preemptions,
            "preempted_total": self.preempted_total,
            "parked": len(self._resume),
        }
        out["supervisor"] = {
            "ready": self.ready,
            "draining": self._draining,
            "dead": self._dead,
            "restarts": self.restarts_total,
            "recovered": self.recovered_total,
            "poisoned": self.poisoned_total,
            "consecutive_crashes": self._consecutive_crashes,
            "restart_budget": self.restart_budget,
        }
        if self.paged:
            out["paged"] = {
                "block_size": self.kv_block_size,
                "pool_blocks": self._alloc.n_blocks,
                "free_blocks": self._alloc.free_blocks,
                "shared_blocks": self._alloc.shared_blocks,
                "cached_blocks": (self._bpx.stats()["cached_blocks"]
                                  if self._bpx is not None else 0),
                "ragged_prefill": self._ragged,
            }
            if self._ragged:
                out["paged"]["ragged_width"] = self._ragged_width
        if self._shadow is not None:
            out["shadow"] = {**self._shadow.stats(),
                             "restored_blocks": self.shadow_restored_total}
        if self._fabric is not None:
            out["kv_fabric"] = {**self._fabric.stats(),
                                "serving": self.fabric_serving}
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
        if self._spec_capable:
            out["speculative"] = {
                "mode": "draft_model" if self._draft_mode else "ngram",
                "draft_len": self._spec_k_max,
                "fleet_wide": self._spec_auto,
                "device_meta": self._spec_devmeta,
                "launches": self.spec_launches,
                "drafted_tokens": self.spec_drafted,
                "accepted_tokens": self.spec_accepted,
                "inflight_rows": len(self._spec_inflight) + sum(
                    len(v) for v in self._spec_pending.values()),
                # verify rows launched while an earlier one was unfetched
                "pipelined_launches": self.spec_pipelined,
            }
        out["launches"]["constrained_chunks"] = self.constrained_chunk_launches
        cstats = self._ctable.stats()
        if cstats["resident"]:
            out["constraints"] = cstats
        # CUDA graphs: a launch kind is captured once, then replayed; the
        # speculation kinds are listed once they launched, the constrained
        # chunk (captured once per table bucket) once it launched
        base = (self._chunk_graph, self._mixed_graph)
        cgraphs = list(self._cchunk_graphs.values())
        out["graphs"] = {g.name: {"captures": g.captures, "replays": g.replays}
                         for g in self._graphs()
                         if g not in cgraphs and (g in base or g.calls)}
        if cgraphs:
            out["graphs"]["decode_chunk_constrained"] = {
                "captures": sum(g.captures for g in cgraphs),
                "replays": sum(g.replays for g in cgraphs),
                "buckets": sorted(self._cchunk_graphs),
            }
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        elif self._bpx is not None:
            out["prefix_cache"] = self._bpx.stats()
        if self._adapters is not None:
            out["adapters"] = self._adapters.stats()
        return out

    def _graphs(self) -> list:
        return [g for g in (self._chunk_graph, self._mixed_graph, self._spec_graph,
                            self._fill_graph, self._propose_graph) if g is not None] + [
            self._cchunk_graphs[b] for b in sorted(self._cchunk_graphs)]

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
        """The static block table, and with an adapter pool the static
        pages, refreshed in place on the launch stream once they changed
        on the host."""
        if self._table_stale:
            self._upload_into((self._table_dev,), (self._table,))
            self._table_stale = False
        if self._pages_stale:
            self._upload_into((self._pages_dev,), (self._slot_pages,))
            self._pages_stale = False
        return self._table_dev

    def _set_slot_page(self, slot: int, page: Optional[int]):
        """Slot `slot` decodes on adapter page `page` (None: the base page)
        from the next launch on."""
        if self.paged and self._slot_pages[slot] != (page or 0):
            self._slot_pages[slot] = page or 0
            self._pages_stale = self._adapters is not None

    # -- worker thread -------------------------------------------------------
    def _loop(self):
        """The supervisor: a scheduler crash is recoverable and
        request-scoped, not fleet-fatal. Each exception out of _loop_inner
        goes through one _supervise round (release every fleet-held
        resource, strike or quarantine suspects, salvage the rest), then
        the device-side fleet is reset and the loop restarts, under a
        bounded consecutive-crash budget with exponential backoff. A reset
        that raises (a device fault that poisoned the CUDA context) is the
        next crash of the same budget, so a dead worker never hangs a
        client: the give-up path fails everything with clean envelopes."""
        crashed = False
        while True:
            try:
                if crashed:
                    self._rebuild_fleet()
                    crashed = False
                self._loop_inner()
                return  # clean exit: close() flipped _closed
            except Exception as e:  # noqa: BLE001 - contained by the supervisor
                if not self._supervise(e):
                    return
                crashed = True

    def _casualties(self) -> list:
        """Detach every live request (plus the one mid-admission) from the
        dead fleet: running tenants first, the admitting request last, the
        order recovery re-admits them in. Pending prefill jobs die with
        the fleet (their requests sit in the assignment from job start)."""
        with self._cv:
            running = [r for r in self._assignment
                       if r is not None and not r.done.is_set()]
            self._assignment = [None] * self.n_slots
            admitting, self._admitting = self._admitting, None
        self._jobs = []
        self._prefilling = {}
        # speculation bookkeeping dies with the fleet: unfetched verify
        # rows are unfetched launches (their emissions drop; the salvage
        # holds fetched tokens only)
        self._host_pos[:] = 0
        self._spec_inflight.clear()
        self._spec_pending.clear()
        self._chunk_unfetched = 0
        self._row_inflight[:] = 0
        if (admitting is not None and admitting not in running
                and not admitting.done.is_set()):
            running.append(admitting)
        return running

    def _release_fleet_resources(self, reqs: list):
        """Return the pool blocks, cached block-prefix chains and table rows
        the dead fleet holds; shared by the restart and the give-up paths.
        The index is cleared BEFORE _rebuild_fleet zeroes the pool, and the
        shadow restore runs after it (_loop_inner), so no chain ever points
        at zeroed blocks and no restore is zeroed."""
        for req in reqs:
            if req.cart is not None:
                self._ctable.release(req.cart[0].key)
                req.cart = None
            if self.paged and req.block_ids is not None:
                self._alloc.decref(req.block_ids)
                req.block_ids = None
            req.adapter_page = None
        if self._adapters is not None:
            # the adapter pages' refcounts reset wholesale: every holder was
            # detached above, and the pages' content survives the crash (the
            # lora leaves live in the params, which the rebuild never
            # touches), so a recovered request re-acquires a resident page
            # and loads nothing
            self._adapters.reset_refs()
        if self._bpx is not None:
            # cached chains point into the pool the rebuild zeroes
            self._bpx.clear()
        if self.paged:
            self._table[:] = 0
            self._table_stale = True
            self._slot_pages[:] = 0
            self._pages_stale = self._adapters is not None
            if self._alloc.outstanding:
                # the explicit releases above must zero the books: a
                # mismatch is an accounting bug, surfaced, then reset so
                # the restarted fleet has no phantom holders
                log.error("kv_pool_leak_on_crash",
                          outstanding=self._alloc.outstanding)
                self._alloc.reset()

    def _rebuild_fleet(self):
        """Reset the device-side fleet for the restarted loop IN PLACE:
        the pool (or dense cache), the slot state and knobs, the block
        table, the mixed launch's inputs, the speculation buffers and the
        draft pool keep their storage, so every
        captured CUDA graph stays valid and each launch kind stays
        captured once. On the card the launches still in flight when the
        host raised land first (synchronize); a device fault that
        poisoned the context raises here, and the supervisor counts it."""
        if self._cuda:
            torch.cuda.synchronize(self.device)
        _zero_tree(self.cache)
        state, sparams = G.init_slots(self.n_slots, self.cfg.vocab_size,
                                      device=self.device)
        self._commit(state, sparams)
        self._fsm.zero_()
        if self.paged:
            self._table[:] = 0
            self._table_dev.zero_()
            self._table_stale = False
            self._slot_pages[:] = 0
        if self._pages_dev is not None:
            self._pages_dev.zero_()
            self._pages_stale = False
        if self._chunked:
            graphs.commit(self._mixed_in, graphs.mixed_inputs(
                self._sched_width, self._ragged_tile, self.n_slots,
                self.cfg.vocab_size, device=self.device))
        if self._spec_in is not None:
            graphs.commit(self._spec_in, graphs.spec_inputs(
                self.n_slots, self._spec_k_max, device=self.device))
        if self._dpool is not None:
            # draft-quality state only: recovered tenants refill it through
            # their admission
            _zero_tree(self._dpool)
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _supervise(self, exc: Exception) -> bool:
        """One crash-containment round. Returns True to restart the loop
        (after _rebuild_fleet), False to give up (budget spent or closing)."""
        self._restarting = True
        self._consecutive_crashes += 1
        log.error("continuous_loop_crashed", exc_info=True, error=str(exc),
                  consecutive=self._consecutive_crashes)
        # the flight recorder's tail rides the crash report
        self.engine.flight.record("crash", error=str(exc),
                                  consecutive=self._consecutive_crashes)
        flight = self.engine.flight.dump()
        log.error("crash_flight_recorder", recorded_total=flight["recorded_total"],
                  tail=flight["events"][-20:])
        if self._restore_dir:
            # the full ring next to restore_dir: a restart-loop or poison
            # episode stays reconstructable after the process is gone
            try:
                os.makedirs(self._restore_dir, exist_ok=True)
                with open(os.path.join(self._restore_dir, "flight_crash.json"),
                          "w") as f:
                    json.dump({"error": str(exc),
                               "consecutive": self._consecutive_crashes, **flight}, f)
            except OSError as e:
                log.warning("flight_persist_failed", error=str(e))
        casualties = self._casualties()
        for req in casualties:
            if req in self._suspects:
                req.strikes += 1
        self._suspects.clear()
        self._release_fleet_resources(casualties)
        survivors = []
        for req in casualties:
            if req.strikes >= self.poison_strikes:
                # implicated in poison_strikes consecutive crash-restarts:
                # fail it ALONE; its fleet-mates are salvaged below
                self.poisoned_total += 1
                self._m.poison.inc()
                self.engine.flight.record("quarantine",
                                          request_id=req.trace.request_id,
                                          strikes=req.strikes)
                log.error("request_quarantined", strikes=req.strikes,
                          request_id=req.trace.request_id)
                req.result = {
                    "error": f"Error: request quarantined after implication in "
                             f"{req.strikes} scheduler crashes (last: {exc})",
                    "status": "failed", "error_type": "poison",
                }
                self._push_final(req)
            else:
                survivors.append(req)
        if self._closed or self._consecutive_crashes > self.restart_budget:
            with self._cv:
                self._dead = not self._closed
                self._closed = True
                pending = self._queue[:]
                self._queue.clear()
                self._note_queue_locked()
                parked, self._resume = self._resume, []
                self._cv.notify_all()
            fail = {
                "error": f"Error: continuous scheduler died after "
                         f"{self._consecutive_crashes} consecutive crashes "
                         f"(restart budget {self.restart_budget}): {exc}",
                "status": "failed", "error_type": "unavailable",
            }
            # self._recovery: salvage a previous round never re-admitted (a
            # crash mid-recovery); parked: preempted requests awaiting resume
            for req in survivors + pending + self._recovery + parked:
                if req.result is None:
                    req.result = dict(fail)
                self._push_final(req)
            self._recovery = []
            self._restarting = False
            self.engine.flight.record("scheduler_dead", restarts=self.restarts_total)
            log.error("continuous_scheduler_dead", restarts=self.restarts_total)
            return False
        # exponential backoff: a crash loop must not spin the host
        time.sleep(min(self.restart_backoff_s * (2 ** (self._consecutive_crashes - 1)),
                       5.0))
        # warm recovery: the restarted loop restores the shadowed blocks
        # into the rebuilt pool BEFORE re-admitting anything (_loop_inner,
        # under the supervisor, so a crash inside the restore is contained
        # and the restore retried)
        self._needs_restore = self._shadow is not None
        for req in survivors:  # each re-admitted as a continuation prefill
            self._fold_salvage(req)
        # a crash mid-recovery leaves earlier salvage in self._recovery:
        # keep it, after this round's survivors
        self._recovery = survivors + [r for r in self._recovery if not r.done.is_set()]
        self.restarts_total += 1
        self._m.restarts.inc()
        self.engine.flight.record("restart", restart=self.restarts_total,
                                  salvaged=len(survivors))
        log.info("continuous_scheduler_restarted", restart=self.restarts_total,
                 salvaged=len(survivors))
        return True

    def _fold_salvage(self, req: _Request):
        """Fold req's fetched tokens into its salvage record and detach it
        from its slot: its re-admission prefills prompt + salvaged as a
        continuation, so greedy decode resumes bit-exactly where the
        fetched stream stopped (tokens of unfetched launches are
        regenerated)."""
        head = ([req.first_id] if req.first_id is not None
                and req.first_id not in self.cfg.all_stop_ids else [])
        req.salvaged = req.salvaged + head + req.tokens
        req.first_id = None
        req.tokens = []
        req.slot = None
        req.need = None
        req.ids = None
        # the re-admission plans its own prefix hit and shadows afresh
        # (content keys dedup the re-captures)
        req.prefix_hit_tokens = 0
        req.shadow_depth = 0

    def _run_recovery(self):
        """Serialized re-admission of salvaged requests: ONE request per
        healthy chunk, so a recurring crash implicates exactly the request
        just re-admitted (the suspect set narrows to one), which isolates a
        poison request within poison_strikes restarts while the rest of
        the fleet survives. Each re-admission is a whole-prefill ingest
        (ragged on the paged fleet), then one synchronous decode chunk."""
        try:
            while self._recovery:
                if self._closed:
                    fail = {"error": "Error: server shutting down",
                            "status": "failed", "error_type": "overloaded"}
                    while self._recovery:
                        r = self._recovery.pop(0)
                        if r.result is None:
                            r.result = dict(fail)
                        self._push_final(r)
                    return
                req = self._recovery[0]
                if req.allowed is not None and len(req.salvaged) >= req.allowed:
                    # the budget was spent before the crash (it cut the loop
                    # between the last fetch and finalize)
                    self._recovery.pop(0)
                    self._finalize(req)
                    continue
                with self._cv:
                    free = [b for b, r in enumerate(self._assignment) if r is None]
                if not free:
                    # more casualties than slots: decode until one completes
                    chunk = self._launch_chunk()
                    if chunk is None:
                        break
                    self._process(chunk)
                    continue
                self._recovery.pop(0)
                self._suspects.add(req)
                self._mutation_seq += 1
                req.recovering = True
                # survives an exception unwind on purpose (see _admit)
                self._admitting = req
                first = self._admit_one(req, free[0])
                self._admitting = None
                if first is _BLOCKED:
                    # the rebuilt pool cannot take it now: the queue's front
                    with self._cv:
                        self._queue.insert(0, req)
                        self._note_queue_locked()
                    continue
                if first is None:
                    continue  # failed fast; its result is set
                req.first_id = int(first.reshape(-1)[0])
                if not req.ttft:
                    req.ttft = time.time() - req.t_start
                self.recovered_total += 1
                self._m.recovered.inc()
                self._post_admit(req)
                # one synchronous chunk: the healthy step that vindicates this
                # re-admission before the next one joins the fleet
                chunk = self._launch_chunk()
                if chunk is not None:
                    self._process(chunk)
        finally:
            self._restarting = False

    def _loop_inner(self):
        """Each iteration takes queued (and parked) requests into free
        slots, then launches ONE step. Chunked: start PrefillJobs (host
        work only), then a mixed launch while prompt chunks are pending,
        else a decode chunk. Whole-prefill: admit (prefill and arm) every
        request a free slot can take, then a decode chunk. Up to chunk_lag
        launches stay in flight. A restart (or a restore_dir start) first
        restores the shadowed chains into the pool, then re-admits the
        salvage, which hits them."""
        # a restart abandoned any in-flight launches: their attribution
        # records can never close (the fetches died with the crash)
        self._launch_log.clear()
        if self._needs_restore:
            self._needs_restore = False
            self._restore_shadow()
        self._run_recovery()
        inflight: collections.deque = collections.deque()
        while True:
            with self._cv:
                while (not self._queue and not self._resume
                       and not any(self._assignment)
                       and not inflight and not self._closed):
                    self._cv.wait()
                if self._closed:
                    return
                queued = bool(self._queue or self._resume)
            if self._chunked:
                self._reap_jobs()
                self._start_jobs()
                spec_rows = self._plan_spec()
                # a mixed launch while prompt chunks or verify rows are
                # planned, or a verify row is unfetched (host-planned: its
                # slot stays frozen; device-meta: the per-launch emission
                # bookkeeping stays uniform), else a decode chunk
                if (self._jobs or spec_rows or self._spec_inflight
                        or self._spec_pending):
                    step = self._launch_mixed(spec_rows)
                else:
                    step = self._launch_chunk()
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
        """Fail pending prefills whose client went away or whose deadline
        passed before spending more budget on them."""
        deadline = self.engine.engine_cfg.request_deadline_s
        now = time.time()
        for job in list(self._jobs):
            req = job.req
            if req.cancelled:
                req.result = self._cancel_env(req)
            elif self._past_deadline(req, now):
                req.result = self._deadline_env(req, where="mid-prefill")
            elif deadline and now - req.t_start > deadline:
                req.result = {"error": f"Error: request exceeded the {deadline:g}s "
                              "deadline", "status": "failed", "error_type": "timeout"}
            else:
                continue
            self._m.preempt.labels(
                reason="cancelled" if req.cancelled else "deadline").inc()
            self._release(req)

    # -- adapter pages (engine/adapters.py) ----------------------------------
    def _acquire_adapter(self, req: _Request) -> bool:
        """Pin req's adapter page (a refcount, and a device write on a
        miss) for its whole slot tenure, FIRST in an admission, so every
        unwind below it releases only what it took on top. False: every
        page is referenced by other requests right now (backpressure, as
        an empty block pool). A base request holds no page."""
        if req.adapter is None or req.adapter_page is not None:
            return True
        page = self._adapters.acquire(req.adapter)
        if page is None:
            return False
        req.adapter_page = page
        return True

    def _release_adapter(self, req: _Request):
        """Drop req's page reference (idempotent). The page stays resident
        at refcount 0, so the next request for the adapter loads nothing."""
        if req.adapter_page is not None and self._adapters is not None:
            self._adapters.release(req.adapter)
        req.adapter_page = None

    def _start_jobs(self):
        """Move parked, then queued, requests into PrefillJobs while a slot
        and pool blocks are available (host-side only: tokenize, allocate
        blocks, install the slot's table row). Same suspect / _admitting
        crash discipline as whole-prefill admission."""
        while True:
            with self._cv:
                # preempted requests resume first (see _admit)
                from_resume = bool(self._resume)
                if not from_resume and not self._queue:
                    return
                free = [b for b, r in enumerate(self._assignment) if r is None]
                if not free:
                    return
                if not from_resume:
                    head = self._queue[0]
                    if head.need is not None and head.need > self._placeable():
                        # a sized head that still cannot get blocks (even by
                        # evicting every unreferenced cached chain) waits for
                        # a release; a head a victim could make room for is
                        # sized on its first attempt, which preempts
                        return
                    req = self._queue.pop(0)
                    self._note_queue_locked()
                else:
                    req = self._resume.pop(0)
            if from_resume and req.cancelled:
                req.result = self._cancel_env(req)
                self._push_final(req)
                continue
            if (from_resume and req.allowed is not None
                    and len(req.salvaged) >= req.allowed):
                self._finalize(req)
                continue
            try:
                self._suspects.add(req)
                self._mutation_seq += 1
                # survives an exception unwind ON PURPOSE (see _admit)
                self._admitting = req
                if from_resume:
                    # "swap": restore the victim's shadowed chain so the
                    # prefix plan below hits it (tail-only chunks)
                    self._prepare_resume(req)
                started = self._start_job(req, free[0])
                self._admitting = None
            except ValueError as e:
                self._admitting = None
                self._free_slot_resources(req)
                log.warning("invalid_request", error=str(e))
                req.result = {"error": f"Error: {e}", "status": "failed",
                              "error_type": "invalid_request"}
                self._push_final(req)
                continue
            # any other exception escapes to the supervisor
            if started is _BLOCKED:
                with self._cv:
                    if from_resume:
                        self._resume.insert(0, req)
                    else:
                        self._queue.insert(0, req)
                        self._note_queue_locked()
                return
            if started is not None and from_resume and req.preempted_at:
                self._m.resume_s.observe(time.time() - req.preempted_at)

    def _expired_in_queue(self, req: _Request) -> bool:
        """Fail a request cancelled, or past its deadline, while it queued
        (a requeued head can carry a cancel that raced the pop), before
        any block grant or prefill; True when it did."""
        req.trace.checkpoint("queue_wait")
        if req.cancelled:
            req.result = self._cancel_env(req)
        elif self._past_deadline(req):
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

    def _admission_ids(self, req: _Request) -> list:
        """The token ids an admission prefills: the rendered prompt, then
        the salvaged continuation of a crash or a preemption (the prompt
        alone counts as prompt_tokens)."""
        eng = self.engine
        text = (eng.render_chat(req.prompt) if req.kwargs.get("chat", True)
                else req.prompt)
        ids = eng.tokenizer.encode(text)
        req.prompt_tokens = len(ids)
        return ids + list(req.salvaged)

    def _placeable(self) -> int:
        """Blocks an admission could get without a release: free, plus
        cached chains nobody maps (the pressure ladder evicts them)."""
        return self._alloc.free_blocks + (self._bpx.evictable_blocks()
                                          if self._bpx is not None else 0)

    def _admission_budget(self, req: _Request, prompt_len: int, p0: int) -> int:
        """The admission's decode budget: max_tokens less the salvaged
        tokens, clamped to the slot, never past the total fixed at the
        first admission (`allowed`). A recovery re-admission counts the
        tokens it re-prefills: the tail past the mapped head `p0`."""
        max_tokens, _ = self.engine._clamp_decode(
            prompt_len, int(req.kwargs.get("max_tokens", 20)) - len(req.salvaged),
            capacity=self.slot_max_seq,
        )
        if req.allowed is None:
            req.allowed = max_tokens
        else:
            max_tokens = min(max_tokens, req.allowed - len(req.salvaged))
        if req.recovering:
            self._m.recovery_recomputed.inc(prompt_len - p0)
            req.recovering = False
        return max_tokens

    def _start_job(self, req: _Request, slot: int):
        """Plan one chunked admission: tokenize, prefix-reuse lookup at
        EXACT chunk depth, clamp the budget, map the shared head and
        allocate fresh pool blocks (evicting cached chains, then
        preempting a victim under pressure) and queue the PrefillJob.
        Returns _BLOCKED when the pool cannot take it, None when the
        request failed fast, or the job."""
        cfg = self.cfg
        faults.check("admission", tag=req.prompt)
        if self._expired_in_queue(req):
            return None
        if not self._acquire_adapter(req):
            return _BLOCKED
        k = req.kwargs
        ids = self._admission_ids(req)
        prompt_len = len(ids)
        # a router's hint: the chain pulled from its peer becomes a deeper
        # exact-depth hit below
        self._fabric_prefetch(req, ids)
        # tier promotion: a host- or disk-shadowed chain deeper than the
        # pool's becomes a deeper exact-depth hit below
        self._promote_local_chain(req, ids)
        p0, entry, plan = self.engine._prefix_plan(
            self._bpx, ids, capacity=self.slot_max_seq, ragged=True,
            adapter=req.adapter)
        if plan is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the slot capacity "
                f"(slot_max_seq {self.slot_max_seq})"
            )
        max_tokens = self._admission_budget(req, prompt_len, p0)
        rp = float(k.get("repetition_penalty", 1.0))
        sampling = (
            float(k.get("temperature", 0.7)), int(k.get("top_k", 50)),
            float(k.get("top_p", 0.9)), bool(k.get("greedy", False)),
            float(k.get("min_p", 0.0)), rp,
            float(k.get("frequency_penalty", 0.0)),
            float(k.get("presence_penalty", 0.0)),
        )
        faults.check("alloc", tag=req.prompt)
        need_total = P.blocks_needed(prompt_len, max_tokens, self.kv_block_size)
        blk_ids = self._grant_blocks(req, need_total, p0, entry)
        if blk_ids is None:
            self._release_adapter(req)
            return _BLOCKED
        table_row = np.zeros((self._max_blocks,), np.int32)
        table_row[:need_total] = req.block_ids
        req.prefix_hit_tokens = p0
        if p0:
            self._m.ragged_exact.inc()
        presence_row = np.zeros((cfg.vocab_size,), bool)
        if rp != 1.0:
            presence_row[ids] = True
        job = PrefillJob(req, ids, p0, prompt_len, max_tokens, slot, sampling,
                         presence_row, table_row, self._sched.classify(req.slo))
        self._table[slot] = table_row
        self._table_stale = True
        self._set_slot_page(slot, req.adapter_page)
        self._host_pos[slot] = 0
        # a new tenant's stream predicts nothing of the last one's: its
        # adaptive-K acceptance starts afresh
        self._sched.spec_reset(slot)
        req.slot = slot
        req.ids = ids
        req.shadow_depth = 0
        with self._cv:
            self._assignment[slot] = req
        self._jobs.append(job)
        self._prefilling[slot] = job
        log.info("prefill_started", slot=slot, prompt_len=prompt_len,
                 tail=job.remaining, prefix_hit=p0, slo_class=job.cls.name,
                 request_id=req.trace.request_id)
        return job

    def _grant_blocks(self, req: _Request, need_total: int, p0: int, entry):
        """Map a hit's shared head (the first p0 // block_size blocks of
        `entry`, incref'd at once so a crash inside the pressure ladder
        releases them through req.block_ids) and allocate the fresh rest
        through the pressure ladder. req.need records the FRESH shortfall
        (the head costs no new block). Sets req.block_ids = shared + fresh
        and returns the fresh ids, or None (nothing held) when the pool
        cannot take the request now."""
        shared = list(entry)[: p0 // self.kv_block_size] if p0 else []
        req.need = need_total - len(shared)
        if shared:
            self._alloc.incref(shared)
            req.block_ids = list(shared)
        blk_ids = self._alloc_with_pressure(req)
        if blk_ids is None:
            if shared:
                self._alloc.decref(shared)
            req.block_ids = None
            return None
        req.block_ids = shared + blk_ids
        return blk_ids

    # -- KV preemption under pool pressure -----------------------------------
    def _alloc_with_pressure(self, req: _Request) -> Optional[list]:
        """`req.need` fresh blocks through the memory-pressure ladder:
        plain alloc, evict unreferenced cached chains, preempt a victim
        (whose chains the next evict round can reclaim) and retry, until a
        victim can no longer be found (None: the caller requeues with
        _BLOCKED). Worker thread only."""
        blk_ids = self._alloc.alloc(req.need)
        while blk_ids is None:
            if self._bpx is not None:
                self._bpx.evict(req.need - self._alloc.free_blocks)
                blk_ids = self._alloc.alloc(req.need)
                if blk_ids is not None:
                    return blk_ids
            if not self._preempt_for(req):
                return None
            blk_ids = self._alloc.alloc(req.need)
        return blk_ids

    def _victim_for(self, req: _Request) -> Optional[_Request]:
        """The decoding request to evict so `req` can be placed, or None.
        Candidates: assigned, running, not mid-prefill, below the
        preemption cap; the scheduler's policy picks the lowest weight /
        youngest that does not outrank the beneficiary."""
        with self._cv:
            cands = [r for b, r in enumerate(self._assignment)
                     if r is not None and not r.done.is_set() and r is not req
                     and b not in self._prefilling
                     and r.preemptions < self.max_preemptions]
        if not cands:
            return None
        return self._sched.select_victim(
            [(r, self._sched.classify(r.slo), r.enqueued) for r in cands],
            self._sched.classify(req.slo),
        )

    def _preempt_for(self, req: _Request) -> bool:
        """Evict one decoding victim to make pool room for `req`. Its
        fetched tokens fold into its salvage record (the continuation its
        resume re-prefills, greedy bit-identical), its slot is killed, its
        blocks are released, and it is parked in `_resume`. Emissions of
        its launches still in flight are dropped (the drop_seq barrier)
        and regenerated after the resume. True when a victim was
        preempted."""
        if self.preempt_policy == "off":
            return False
        victim = self._victim_for(req)
        if victim is None:
            return False
        faults.check("preempt", tag=victim.prompt)
        swapped = False
        if self.preempt_policy == "swap" and self._shadow is not None:
            # capture the blocks filled since the last fetch, then wait for
            # every pending copy to LAND: only resident entries restore
            self._shadow_capture(victim)
            swapped = self._shadow.flush(timeout_s=5.0)
        head = ([victim.first_id] if victim.first_id is not None
                and victim.first_id not in self.cfg.all_stop_ids else [])
        # an adapter victim always recomputes: its KV was never shadowed
        victim.resume_seq = (list(victim.ids) + head + victim.tokens
                             if swapped and victim.ids is not None
                             and victim.adapter is None else None)
        victim.preemptions += 1
        victim.preempted_at = time.time()
        self._mutation_seq += 1
        victim.drop_seq = self._mutation_seq
        if victim.slot is not None:
            self._commit(G.kill_slot(self.state, victim.slot))
        self._free_slot_resources(victim)
        self._fold_salvage(victim)
        self.preempted_total += 1
        self._m.preempt.labels(reason="pool").inc()
        self.engine.flight.record(
            "preempt", request_id=victim.trace.request_id,
            policy=self.preempt_policy, swap=swapped,
            preemptions=victim.preemptions, slo_class=victim.slo,
            beneficiary=req.trace.request_id, **self._alloc.span_attrs(),
        )
        log.info("request_preempted", policy=self.preempt_policy, swap=swapped,
                 preemptions=victim.preemptions, slo_class=victim.slo,
                 beneficiary_class=req.slo, request_id=victim.trace.request_id)
        with self._cv:
            self._resume.append(victim)
            self._cv.notify_all()
        return True

    # -- the KV shadow (engine/shadow.py) -------------------------------------
    def _shadow_capture(self, req: _Request, written: Optional[int] = None):
        """Hand req's newly FILLED pool blocks to the shadow copier (worker
        thread). `written`: tokens known to be in the pool for this row
        (mid-prefill callers pass the job's progress); None derives it from
        the fetched stream (the last sampled token's K/V is not written
        yet, hence the -1). The gather is dispatched on the launch stream
        AFTER the launch that filled the blocks, so it reads their final
        bytes; the copy to the host starts behind it into pinned memory
        and lands on the copier thread: the scheduler never waits."""
        if self._shadow is None or req.block_ids is None or req.ids is None:
            return
        if req.adapter is not None:
            # adapter KV never enters the shadow: the store (and the fabric
            # it serves) keys chains by token content alone, and an
            # adapter's KV differs from the base model's for the same tokens
            return
        bs = self.kv_block_size
        if written is None:
            head = ([req.first_id] if req.first_id is not None
                    and req.first_id not in self.cfg.all_stop_ids else [])
            gen = head + req.tokens
            written = len(req.ids) + max(0, len(gen) - 1)
            seq_tokens = req.ids + gen
        else:
            seq_tokens = req.ids
        full = min(written // bs, len(req.block_ids))
        if full <= req.shadow_depth:
            return
        # the chaos hook BEFORE the dedup: a repeat prompt whose blocks are
        # all resident still exercises the shadow_copy drill
        faults.check("shadow_copy", tag=req.prompt)
        new_keys, new_blocks = [], []
        for i in range(req.shadow_depth, full):
            key = tuple(seq_tokens[: (i + 1) * bs])
            if not self._shadow.has(key):
                new_keys.append(key)
                new_blocks.append(int(req.block_ids[i]))
        req.shadow_depth = full
        W = self._shadow_gather_w
        for off in range(0, len(new_keys), W):
            ids = new_blocks[off: off + W]
            padded = ids + [ids[-1]] * (W - len(ids))  # one width for every batch
            (ids_dev,) = self._upload(np.asarray(padded, np.int32))
            dev = self.backend.gather_shadow_blocks(self.cache, ids_dev)
            self._shadow.put_async(new_keys[off: off + W], P.pool_leaves(dev),
                                   self._mutation_seq)

    def _pool_layout(self) -> list:
        """The whole pool's leaves, or their shape-and-dtype stand-ins on a
        backend whose pool is sharded over ranks (pool_layout)."""
        layout = getattr(self.backend, "pool_layout", None)
        return layout(self.cache) if layout is not None else P.pool_leaves(self.cache)

    def _prewarm_pinned(self):
        """Allocate the pinned host buffers of the shadow's copies once, up
        front, and free them: torch's host allocator keeps them, so no
        capture on the served path (max_pending batches in flight) and no
        restore in a crash's recovery window pays a page-locking
        allocation on the scheduler thread. The JAX fleet pre-warms its
        restore program at construction for the same reason."""
        leaves = self._pool_layout()
        bufs = []
        for rows, n in ((self._shadow_gather_w, self._shadow.max_pending),
                        (self._shadow_restore_w, 1)):
            for _ in range(n):
                bufs += [torch.empty((rows, leaf.shape[0], *leaf.shape[2:]),
                                     dtype=leaf.dtype, pin_memory=True) for leaf in leaves]
        del bufs

    def _scatter_shadow(self, blocks: list, per_block_leaves: list):
        """Write shadowed blocks (each its host leaves in pool_leaves order)
        into the pool blocks `blocks` IN PLACE, _shadow_restore_w rows per
        scatter (pad rows repeat the first row into the trash block). The
        operands go up through pinned memory on the launch stream, behind
        every launch in flight, and every captured graph keeps reading the
        same pool. A leaf whose dtype or shape is not the pool's (a
        persisted shadow of another configuration) raises ValueError."""
        W = self._shadow_restore_w
        like = self._pool_layout()
        for off in range(0, len(blocks), W):
            ids = blocks[off: off + W]
            batch = per_block_leaves[off: off + W]
            pad = W - len(ids)
            if len(batch[0]) != len(like):
                raise ValueError(f"shadow blocks of {len(batch[0])} leaves do not "
                                 f"fit the pool's {len(like)}")
            stacked = []
            for j, dst in enumerate(like):
                arr = np.stack([pb[j] for pb in batch])
                if pad:
                    arr = np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)])
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if dst.dtype == torch.bfloat16 and t.dtype == torch.int16:
                    t = t.view(torch.bfloat16)  # the shadow's bit-exact carrier
                if t.dtype != dst.dtype or t.shape[1:] != dst.shape[:1] + dst.shape[2:]:
                    raise ValueError(
                        f"shadow leaf {j}: {tuple(t.shape[1:])} {t.dtype} does not "
                        f"fit the pool's {tuple(dst.shape)} {dst.dtype}")
                if self._cuda:
                    t = t.pin_memory().to(self.device, non_blocking=True)
                stacked.append(t)
            (ids_dev,) = self._upload(np.asarray(ids + [P.TRASH_BLOCK] * pad, np.int32))
            self.backend.restore_shadow_blocks(
                self.cache, P.pool_from_leaves(self.cache, stacked), ids_dev)

    def _restore_shadow(self) -> int:
        """Scatter the shadowed chains into the rebuilt pool and register
        them in the block-prefix index, so the salvage re-admissions (and
        later traffic) hit them. Runs on the worker thread before any
        re-admission, under the supervisor: a crash here is contained, the
        next round's clear() releases a partial registration and the
        restore runs again. Returns the blocks restored."""
        if self._shadow is None or self._bpx is None:
            return 0
        # captures from before the crash land first, so the restore depth
        # is deterministic
        self._shadow.flush(timeout_s=10.0)
        faults.check("shadow_copy", tag="restore")
        # one slot-class of headroom: the first admission must not have to
        # evict just to be placed
        budget = self._alloc.free_blocks - self._max_blocks
        entries, leaf_keys = self._shadow.select(budget)
        if not entries:
            return 0
        blocks = self._alloc.alloc(len(entries))
        if blocks is None:
            return 0
        try:
            self._scatter_shadow(blocks, [e.leaves for _, e in entries])
        except Exception as e:  # noqa: BLE001 - a bad persisted shadow
            # (config drift across a restart) must start cold, not
            # crash-loop the supervisor
            log.warning("shadow_restore_invalid", error=str(e))
            self._alloc.decref(blocks)
            self._shadow.clear()
            return 0
        bs = self.kv_block_size
        assigned = {key: b for (key, _), b in zip(entries, blocks)}
        for leaf in leaf_keys:
            self._bpx.import_chain(list(leaf), [assigned[leaf[: (i + 1) * bs]]
                                                for i in range(len(leaf) // bs)])
        # the index holds its own reference per block now: restored chains
        # end at refcount 1 (index-held, evictable)
        self._alloc.decref(blocks)
        n = len(entries)
        self._shadow.count_pool_promotion(n)
        self.shadow_restored_total += n
        self._m.shadow_restored.inc(n)
        log.info("shadow_restored", blocks=n, chains=len(leaf_keys),
                 free_blocks=self._alloc.free_blocks)
        return n

    def _import_fabric_chain(self, keys: list, per_block_leaves: list) -> int:
        """Scatter a chain of host-resident blocks (a whole-blob fabric
        fetch, or a chain promoted out of the shadow's tiers) into the
        pool, register it in the block-prefix index and keep it in the
        host shadow, so this replica serves it onward through /kv.
        Returns blocks imported (0 when the pool has no headroom: the
        local prefill still works)."""
        # one slot-class of headroom, like _restore_shadow; cold cached
        # chains are reclaimed first, as admission does
        budget = self._alloc.free_blocks - self._max_blocks
        if budget < len(keys) and self._bpx is not None:
            self._bpx.evict(len(keys) - budget)
            budget = self._alloc.free_blocks - self._max_blocks
        if budget <= 0:
            return 0
        keys, per_block_leaves = keys[:budget], per_block_leaves[:budget]
        blocks = self._alloc.alloc(len(keys))
        if blocks is None:
            return 0
        try:
            self._scatter_shadow(blocks, per_block_leaves)
        except Exception as e:  # noqa: BLE001 - a leaf-shape mismatch
            # degrades to a cold prefill, never a scheduler crash
            log.warning("fabric_import_invalid", error=str(e))
            self._alloc.decref(blocks)
            return 0
        self._bpx.import_chain(list(keys[-1]), blocks)
        self._shadow.put_host(keys, per_block_leaves, self._mutation_seq)
        self._shadow.count_pool_promotion(len(keys))
        # imported chains end at refcount 1 (index-held), like restored ones
        self._alloc.decref(blocks)
        log.info("fabric_imported", blocks=len(keys),
                 free_blocks=self._alloc.free_blocks)
        return len(keys)

    # -- the cross-replica KV fabric (serving/kv_fabric.py) ------------------
    def fabric_chain(self, digest: str):
        """Wire bytes of the resident shadow chain ending at `digest`, or
        None (the server's GET /kv/{digest} -> 404). Any thread: the store
        is lock-protected and the encode reads host arrays only, so the
        HTTP handler serves peers without touching the scheduler loop."""
        if not self.fabric_serving:
            return None
        from ..serving.kv_fabric import serve_chain

        return serve_chain(self._shadow, digest)

    def fabric_chain_stream(self, digest: str):
        """(n_chunks, tier, frame iterator) of the resident chain ending at
        `digest`, or None: the streamed GET /kv/{digest} body (X-KV-Stream:
        1). Any thread; frames encode lazily, one block at a time."""
        if not self.fabric_serving:
            return None
        from ..serving.kv_fabric import serve_chain_stream

        return serve_chain_stream(self._shadow, digest)

    def fabric_digest_tier(self, digest: str):
        """The shallowest shadow tier holding `digest` ("host" | "disk" |
        None): the server's X-KV-Tier."""
        if not self.fabric_serving:
            return None
        return self._shadow.digest_tier(digest)

    def fabric_accept_push(self, data: bytes):
        """The POST /kv body (any thread): a peer's pushed chain, validated
        against its OWN content key (the digest is recomputed from its
        tokens) and against this pool's leaf layout, landed in the host
        shadow tier, where the admission's tier promotion scatters it
        without a pull. Returns the response dict, or None (-> 400)."""
        if not self.fabric_serving:
            return None
        from ..serving.kv_fabric import FabricPayloadError, check_layout, decode_push

        try:
            digest, keys, per_block = decode_push(data, self.kv_block_size)
            for leaves in per_block:
                check_layout(leaves, self._wire_layout)
        except FabricPayloadError as e:
            log.warning("fabric_push_rejected", error=str(e))
            return None
        n = self._shadow.put_host(keys, per_block, self._mutation_seq)
        self.engine.flight.record("fabric_push_in", digest=str(digest)[:16], blocks=n)
        return {"accepted": n, "digest": digest}

    def fabric_digests(self, limit: Optional[int] = None) -> list:
        """Resident chain digests, MRU first, host tier before disk (the
        /health field a router's residency bootstrap reads), capped at
        kv_health_digests."""
        if not self.fabric_serving:
            return []
        return self._shadow.resident_digests(
            limit=self._kv_health_digests if limit is None else limit)

    @property
    def _wire_layout(self) -> list:
        """The (numpy dtype, per-block shape) of each of the pool's leaves
        as the shadow and the wire carry them (bf16 as its int16 view): a
        fetched or pushed chain must match it to be imported."""
        out = []
        for leaf in self._pool_layout():
            dt = (np.dtype(np.int16) if leaf.dtype == torch.bfloat16
                  else torch.empty((), dtype=leaf.dtype).numpy().dtype)
            out.append((dt, (leaf.shape[0], *leaf.shape[2:])))
        return out

    def _fabric_prefetch(self, req: _Request, ids: list):
        """Consume req's hint (worker thread, at the admission, BEFORE the
        prefix plan, so an import is just a deeper local hit). The ladder:
        a local chain already covers the prompt -> skip; a 404, a dead or
        wedged peer, a failed recheck or a foreign leaf layout -> a miss
        and the local prefill; a pool too full for the chain -> import
        what fits (a chain prefix is still a valid chain). The fetch
        blocks this thread for at most kv_fabric_timeout_s. Nothing here
        fails the request."""
        hint, req.kv_hint = req.kv_hint, None
        if hint is None or self._fabric is None or req.adapter is not None:
            # the fabric serves base-model chains keyed by token content
            # alone: an adapter request never fetches one
            return
        peer = hint.get("peer") if isinstance(hint, dict) else None
        digest = hint.get("digest") if isinstance(hint, dict) else None
        if not peer or not digest:
            return
        bs = self.kv_block_size
        # the deepest depth the planner could use (it leaves >= 1 tail
        # token): a local chain that deep makes the fetch pure waste
        cap = max(0, (len(ids) - 1) // bs) * bs
        p0_local, _, _ = self._bpx.lookup(ids)
        if cap <= 0 or p0_local >= cap:
            return
        if self._shadow.has_resident(tuple(ids[:cap])):
            # a push (or a demotion) already landed the chain in the local
            # tiers: the promotion below scatters it with no wire trip
            return
        streamed = self._fabric_stream
        tier = ""
        fetched = None
        kw = dict(ctx=req.trace_ctx, request_id=req.trace.request_id,
                  store=self.engine.trace_store, layout=self._wire_layout)
        if streamed:
            res = self._fabric.fetch_stream(peer, digest, bs, **kw)
            hit = False
            if res is not None:
                _, tier, blocks_iter = res
                hit, req.fabric_blocks = self._import_fabric_stream(blocks_iter)
        else:
            fetched = self._fabric.fetch(peer, digest, bs, **kw)
            hit = fetched is not None
            tier = self._fabric.last_tier if hit else ""
        self.engine.flight.record(
            "fabric_fetch", request_id=req.trace.request_id, peer=peer,
            digest=str(digest)[:16], hit=hit, tier=tier, streamed=streamed,
        )
        if fetched is not None:
            keys, leaves = fetched
            req.fabric_blocks = self._import_fabric_chain(keys, leaves)

    def _scatter_stream_batch(self, batch: list, keys: list, leaves_kept: list,
                              blocks: list) -> bool:
        """Scatter one batch of streamed (key, leaves) frames into fresh
        pool blocks in place (_scatter_shadow: on the launch stream,
        behind the launches in flight, so the device works while the next
        frames are on the wire). Appends to the caller's ledgers only on
        success; False = the pool is dry or a scatter failed (the caller
        keeps its scattered prefix: a chain prefix is still a chain)."""
        blk = self._alloc.alloc(len(batch))
        if blk is None:
            # cold cached chains are reclaimable, exactly as at admission
            self._bpx.evict(len(batch) - self._alloc.free_blocks)
            blk = self._alloc.alloc(len(batch))
        if blk is None:
            return False
        try:
            self._scatter_shadow(blk, [leaves for _, leaves in batch])
        except Exception as e:  # noqa: BLE001 - never a scheduler crash
            log.warning("fabric_stream_scatter_invalid", error=str(e))
            self._alloc.decref(blk)
            return False
        for (key, leaves), b in zip(batch, blk):
            keys.append(key)
            leaves_kept.append(leaves)
            blocks.append(b)
        return True

    def _import_fabric_stream(self, blocks_iter) -> tuple:
        """Consume a /kv stream (kv_fabric.fetch_stream's block iterator),
        scattering frames into the pool in restore-width batches AS THEY
        ARRIVE. Nothing is REGISTERED until the stream ends cleanly (the
        iterator's final content-key recheck): on a tamper, a truncation,
        a foreign layout or a died socket the scattered blocks are
        decref'd, unreachable, and the admission prefills locally. Returns
        (verified, blocks imported); a budget-truncated import still
        drains and verifies every frame before registering the prefix
        that fit."""
        # cold refcount-1 cached chains count toward the budget: the batch
        # scatter evicts them on demand, as admission does
        budget = (self._alloc.free_blocks + self._bpx.evictable_blocks()
                  - self._max_blocks)
        if budget <= 0:
            blocks_iter.close()  # settles the client's hit / miss
            return False, 0
        W = self._shadow_restore_w
        keys: list = []  # scattered, parents first
        leaves_kept: list = []
        blocks: list = []  # their pool ids, aligned
        batch: list = []
        pool_dry = False
        verified = False
        try:
            for key, leaves in blocks_iter:
                if pool_dry or len(keys) + len(batch) >= budget:
                    continue  # verify-drain the tail; import what fit
                batch.append((key, leaves))
                if len(batch) == W:
                    pool_dry = not self._scatter_stream_batch(batch, keys,
                                                              leaves_kept, blocks)
                    batch = []
            if batch and not pool_dry:
                self._scatter_stream_batch(batch, keys, leaves_kept, blocks)
            verified = True
        except Exception as e:  # noqa: BLE001 - FabricPayloadError or a
            # socket dying mid-stream: one outcome, the local prefill
            log.warning("fabric_stream_rejected", error=str(e))
        finally:
            blocks_iter.close()
        if not verified or not keys:
            if blocks:
                self._alloc.decref(blocks)
            return verified, 0
        self._bpx.import_chain(list(keys[-1]), blocks)
        self._shadow.put_host(keys, leaves_kept, self._mutation_seq)
        self._shadow.count_pool_promotion(len(keys))
        self._alloc.decref(blocks)
        log.info("fabric_stream_imported", blocks=len(keys),
                 free_blocks=self._alloc.free_blocks)
        return True, len(keys)

    def _fabric_push(self, req: _Request, peer_url: str) -> int:
        """The handoff's phase 1.5: encode this finished request's deepest
        shadow chain and POST it to the decode replica the router picked
        (X-KV-Push-To), so phase 2's admission finds the prefix resident
        there. Runs on submit()'s HTTP thread after the shadow flush,
        never on the scheduler loop. Any failure returns 0: the pull path
        remains the fallback."""
        ds = (req.result or {}).get("kv_digests") or []
        if not ds or self._fabric is None:
            return 0
        digest = ds[-1]  # the deepest chain the decode peer will want
        data = self.fabric_chain(digest)
        if data is None:
            return 0
        accepted = self._fabric.push_chain(peer_url, data, ctx=req.trace_ctx,
                                           request_id=req.trace.request_id,
                                           store=self.engine.trace_store)
        self.engine.flight.record(
            "fabric_push", request_id=req.trace.request_id, peer=peer_url,
            digest=str(digest)[:16], accepted=-1 if accepted is None else accepted,
        )
        return accepted or 0

    def _promote_local_chain(self, req: _Request, ids: list):
        """Tier promotion at admission (worker thread, BEFORE the prefix
        plan): when the shadow's host or disk tier holds a deeper
        contiguous chain for this prompt than the pool's index, load it
        (disk hits promote host-ward, each chunk file content-verified)
        and scatter it in, so the plan sees a deeper hit. A corrupt chunk
        file rejects into a cold prefill; nothing here fails the
        request. Adapter KV is fenced from every token-keyed tier."""
        if self._shadow is None or self._bpx is None or req.adapter is not None:
            return
        bs = self.kv_block_size
        cap = max(0, (len(ids) - 1) // bs) * bs
        if cap <= 0:
            return
        p0_local, _, _ = self._bpx.lookup(ids)
        if p0_local >= cap:
            return
        depth = 0
        for nb in range(cap // bs, p0_local // bs, -1):
            if self._shadow.has_resident(tuple(ids[: nb * bs])):
                depth = nb
                break
        if depth == 0:
            return
        keys = [tuple(ids[: (i + 1) * bs]) for i in range(depth)]
        entries = self._shadow.entries_for(keys)
        if entries is None:
            return  # churned out, or a corrupt chunk file: cold prefill
        imported = self._import_fabric_chain(keys, [e.leaves for e in entries])
        if imported:
            req.promoted_blocks = imported
            self.engine.flight.record("tier_promote", request_id=req.trace.request_id,
                                      blocks=imported, depth=depth * bs)

    def _prepare_resume(self, req: _Request):
        """"swap" preemption's warm half (worker thread, just before the
        resume's re-admission): scatter the victim's shadowed chain into
        fresh pool blocks and register it in the index, so the admission
        below hits it and re-prefills ONLY the tail past the deepest
        restored block. A shortfall (entries gone from the shadow, the
        pool still tight) degrades to a colder re-prefill, never an
        error."""
        seq = req.resume_seq
        if seq is None or self._shadow is None or self._bpx is None:
            req.resume_seq = None
            return
        bs = self.kv_block_size
        # the lookup's reuse cap: at least one tail token remains
        cap_full = max(0, (len(seq) - 1) // bs)
        p0, entry, _ = self._bpx.lookup(seq)
        keys = []
        for i in range(p0 // bs, cap_full):
            key = tuple(seq[: (i + 1) * bs])
            if not self._shadow.has_resident(key):
                break  # a chain with a hole cannot be registered
            keys.append(key)
        if not keys:
            req.resume_seq = None  # nothing restorable, ever
            return
        blocks = self._alloc.alloc(len(keys))
        if blocks is None:
            self._bpx.evict(len(keys) - self._alloc.free_blocks)
            blocks = self._alloc.alloc(len(keys))
        if blocks is None:
            # the pool is still tight (the admission below blocks and
            # requeues): keep resume_seq, so the retry restores warm
            return
        entries = self._shadow.entries_for(keys)
        if entries is None:
            self._alloc.decref(blocks)
            req.resume_seq = None
            return
        try:
            self._scatter_shadow(blocks, [e.leaves for e in entries])
        except BaseException:
            # a crash mid-restore is the supervisor's, but these blocks are
            # tracked nowhere yet: release them before the unwind
            self._alloc.decref(blocks)
            raise
        req.resume_seq = None
        row_blocks = list(entry or []) + blocks
        self._bpx.import_chain(list(seq[: len(row_blocks) * bs]), row_blocks)
        self._alloc.decref(blocks)
        self._m.shadow_restored.inc(len(blocks))
        log.info("preempt_resume_restored", blocks=len(blocks),
                 request_id=req.trace.request_id)

    # -- launch-level attribution (engine_cfg.trace_sample_rate) -------------
    def _prof_note_launch(self, kind: str, t_launch: float, snapshot, **attrs):
        """Open one launch record (worker thread, at the dispatch boundary,
        reached only behind the `self._trace_rate > 0` guard). It closes at
        the matching packed fetch (_prof_close_launch), keyed by the
        launch's own perf_counter stamp: fetches drain the in-flight deque
        in launch order, so a lag-pipelined launch attributes right with no
        device sync and no host read inside a captured launch."""
        targets = [
            (r.trace_ctx.trace_id, r.trace_ctx.span_id)
            for r in snapshot
            if r is not None and r.profiled and r.trace_ctx is not None
        ]
        if not targets:
            return
        self._launch_log.append({
            "t_launch": t_launch,
            "wall": time.time(),
            "kind": kind,
            "targets": targets,
            "attrs": attrs,
        })

    def _prof_close_launch(self, t_launch: float, **attrs):
        """Close the oldest launch record IF it belongs to the fetch being
        processed (exact equality on the launch stamp: unrecorded launches
        between recorded ones do not match), and emit one `launch.<kind>`
        span per profiled tenant into the engine's span store, parented
        under that request's span (router -> replica -> launch)."""
        if not self._launch_log or self._launch_log[0]["t_launch"] != t_launch:
            return
        rec = self._launch_log.popleft()
        t1 = time.time()
        span_attrs = dict(rec["attrs"])
        span_attrs.update(attrs)
        span_attrs["launch_to_fetch_s"] = round(time.perf_counter() - t_launch, 6)
        store = self.engine.trace_store
        for trace_id, parent in rec["targets"]:
            store.add_span(trace_id, f"launch.{rec['kind']}", rec["wall"], t1,
                           parent_id=parent, attrs=span_attrs)

    def _launch_chunk(self):
        """Launch one decode chunk over the fleet; returns the in-flight
        tuple ("chunk", fetch handle, assignment snapshot, launch time,
        mutation seq) or None when no slot is active."""
        if not any(r is not None for r in self._assignment):
            return None
        faults.check("decode_launch", tag=",".join(
            r.prompt for r in self._assignment if r is not None))
        if self.paged:
            self._table_device()
            packed = self._chunk_graph()
        elif self._ctable.any_active:
            # >= 1 constrained tenant: the constrained chunk (two gathers
            # more per step; the free row makes them a no-op for the
            # unconstrained slots), its FSM chained on the device
            packed = self._constrained_chunk_graph()()
            self.constrained_chunk_launches += 1
        else:
            packed = self._chunk_graph()
        self.chunk_launches += 1
        # host position model: every assigned slot advances chunk_steps (a
        # row that dies mid-chunk over-advances, and is finalized), and
        # n-gram drafting waits for this fetch
        self._chunk_unfetched += 1
        for b, r in enumerate(self._assignment):
            if r is not None:
                self._host_pos[b] += self.chunk_steps
        handle = self._to_host(packed)
        snapshot = list(self._assignment)
        t_launch = time.perf_counter()
        if self._trace_rate > 0.0:
            self._prof_note_launch(
                "chunk", t_launch, snapshot, steps=self.chunk_steps,
                rows=sum(1 for r in snapshot if r is not None))
        return ("chunk", handle, snapshot, t_launch, self._mutation_seq)

    def _chunk_body(self):
        """The decode chunk over the static buffers (a LaunchGraph)."""
        return graphs.decode_chunk(
            self.backend, self.state, self.sparams, self.cache,
            self._table_dev if self.paged else None, self._gen, self.chunk_steps,
            pages=self._pages_dev,
        )

    def _constrained_chunk_graph(self) -> graphs.LaunchGraph:
        """The constrained decode chunk's graph for the table's current
        bucket, captured at its first launch. The table's pending row
        writes land in place first, on this (the launch) stream."""
        cmask, ctrans = self._ctable.device_tables(self.device)
        bucket = cmask.shape[0]
        g = self._cchunk_graphs.get(bucket)
        if g is None:
            def body():
                return graphs.decode_chunk_constrained(
                    self.backend, self.state, self.sparams, self.cache, self._fsm,
                    cmask, ctrans, self._gen, self.chunk_steps)

            g = self._cchunk_graphs[bucket] = graphs.LaunchGraph(
                body, "decode_chunk_constrained", self.device, self._gen,
                self._eager)
        return g

    def _mixed_body(self):
        """The mixed launch over the static buffers (a LaunchGraph)."""
        return graphs.mixed_launch(self.backend, self._mixed_in, self.cache,
                                   self._table_dev, self.state, self.sparams,
                                   self._gen, pages=self._pages_dev)

    def _spec_body(self):
        """The mixed launch with verify rows (a LaunchGraph)."""
        return graphs.mixed_spec_launch(
            self.backend, self._mixed_in, self._spec_in, self.cache,
            self._table_dev, self.state, self.sparams, self._gen, self._draft_mode,
            pages=self._pages_dev)

    def _fill_body(self):
        """The mixed launch's tokens into the draft pool (a LaunchGraph)."""
        graphs.draft_fill(self._dcfg, self._dparams, self._mixed_in, self._dpool,
                          self._table_dev, self.state)

    def _propose_body(self):
        """The draft chain into the static proposals (a LaunchGraph)."""
        return graphs.draft_propose(self._dcfg, self._dparams, self.state,
                                    self._dpool, self._table_dev, self._spec_in.toks)

    # -- speculation: host-side planning --------------------------------------
    def _spec_req_ok(self, req: Optional[_Request]) -> bool:
        """Is this tenant a speculation candidate? Greedy only (the verify
        compares the model's own argmax) with every logit-changing knob
        off, so the verify argmax and slot_step's coincide; and the
        request (or the fleet, spec_decode) opted in."""
        if req is None or not (self._spec_auto or req.spec_want):
            return False
        k = req.kwargs
        return (bool(k.get("greedy", False))
                and float(k.get("repetition_penalty", 1.0)) == 1.0
                and float(k.get("frequency_penalty", 0.0)) == 0.0
                and float(k.get("presence_penalty", 0.0)) == 0.0
                and k.get("constraint") is None)

    def _plan_spec(self) -> dict:
        """This step's verify rows: {slot: (n_draft, drafts or None, pred or
        None)} (drafts None: the draft model proposes on the device; pred:
        the optimistic window, drafts + predicted correction, that later
        plans extend the slot's history with).

        Device-meta mode: an unfetched verify row never disqualifies its
        slot; the only gates are the n-gram planner's: no decode chunk
        unfetched, every pending launch carrying the slot a verify launch
        of THIS tenant with a predicted window, and a window of >= 2
        tokens from the optimistic history. Host-planned mode: the
        previous verify row fetched and no row of the slot in flight.

        The scheduler picks the global K (0 under decode TPOT pressure),
        each slot's K follows its acceptance (spec_slot_k, device-meta
        mode) and is clamped to its allocated blocks at the PESSIMISTIC
        frontier (host position + every pending launch's advance bound),
        so a verify write never clamps into a live block."""
        if not self._spec_capable:
            return {}
        from .scheduler import ngram_draft, spec_block_cap

        devmeta = self._spec_devmeta
        cand = []
        for b, req in enumerate(self._assignment):
            if (req is None or b in self._prefilling or req.done.is_set()
                    or req.cancelled or not self._spec_req_ok(req)):
                continue
            if devmeta:
                pending = self._spec_pending.get(b, [])
                if any(e["req"] is not req for e in pending):
                    continue  # the slot's previous tenant's: wait for them
                if not self._draft_mode and (
                        self._chunk_unfetched
                        # a pending PLAIN row adds a token the host cannot
                        # predict: drafting would leave the frontier
                        or self._row_inflight[b] > len(pending)
                        or any(e["pred"] is None for e in pending)):
                    continue
            elif b in self._spec_inflight or self._row_inflight[b] != 0:
                continue
            cand.append(b)
        if not cand:
            return {}
        decoding = [r for b, r in enumerate(self._assignment)
                    if r is not None and b not in self._prefilling]
        k = self._sched.spec_draft_len(
            self._spec_k_max, len(cand), len(decoding) - len(cand),
            active_classes={r.slo for r in decoding}, jobs_pending=bool(self._jobs))
        if k <= 0:
            return {}
        out = {}
        for b in cand:
            req = self._assignment[b]
            pending = self._spec_pending.get(b, []) if devmeta else []
            frontier = int(self._host_pos[b]) + sum(e["adv"] for e in pending)
            kb = min(k, spec_block_cap(len(req.block_ids or ()),
                                       self.kv_block_size, frontier))
            if devmeta:
                kb = min(kb, self._sched.spec_slot_k(b, k))
            if kb < 1:
                continue
            if self._draft_mode:
                out[b] = (kb, None, None)
                continue
            head = ([req.first_id] if req.first_id is not None
                    and req.first_id not in self.cfg.all_stop_ids else [])
            hist = (req.ids or []) + head + req.tokens
            if devmeta:
                # the optimistic frontier: every pending verify row fully
                # accepts its predicted window (a wrong guess only rejects);
                # draft kb tokens and predict the correction too, so the
                # next back-to-back plan stays aligned under full accept
                for e in pending:
                    hist = hist + e["pred"]
                window = ngram_draft(hist, kb + 1)
                if len(window) >= 2:
                    out[b] = (len(window) - 1, window[:-1], window)
            else:
                drafts = ngram_draft(hist, kb)
                if drafts:
                    out[b] = (len(drafts), drafts, None)
        return out

    def _launch_mixed(self, spec_rows: Optional[dict] = None):
        """ONE scheduler step: every decoding slot's token (or, for slots in
        `spec_rows` ({slot: (n_draft, drafts or None, pred or None)}), a
        [current + drafts] verify row) plus the budget slice of pending
        prompt chunks in one mixed launch. Decode rows' positions, and in
        device-meta mode verify rows', are substituted on the device
        (DeviceMeta). Returns the in-flight tuple ("mixed", fetch handle,
        decode snapshot, {slot: req} completions, launch time, mutation
        seq, {slot: (req, n_draft)} of the verify rows or None for the
        plain launch) or None."""
        spec_rows = spec_rows or {}
        devmeta = self._spec_devmeta
        assigned = [b for b, r in enumerate(self._assignment)
                    if r is not None and b not in self._prefilling]
        # host-planned: a slot with an unfetched verify row gets no row (its
        # position is unknown to the host until the fetch resyncs it)
        active = [b for b in assigned if devmeta or b not in self._spec_inflight]
        # a verify row debits the step budget like prefill tokens do
        tile = self._ragged_tile
        plan = self._sched.plan(
            sum(-(-(1 + spec_rows[b][0]) // tile) if b in spec_rows else 1
                for b in active),
            self._jobs,
            active_classes={self._assignment[b].slo for b in assigned},
        )
        if not active and not plan:
            return None
        faults.check("decode_launch", tag=",".join(
            r.prompt for r in self._assignment if r is not None))
        if plan:
            faults.check("prefill", tag=",".join(job.req.prompt for job, _ in plan))
        W, B = self._sched_width, self.n_slots
        # device-derived rows first: plain decode rows and, in device-meta
        # mode, verify rows; a host-planned verify row follows them with its
        # exact host position (the row had nothing in flight)
        rows = [b for b in active if devmeta or b not in spec_rows]
        n_derived = len(rows)
        rows += [b for b in active if b not in rows]
        entries = []
        for b in rows:
            if b in spec_rows:
                start = int(self._host_pos[b]) if not devmeta else 0
                entries.append((b, start, 1 + spec_rows[b][0], P.RAGGED_PREFILL))
            else:
                entries.append((b, 0, 1, P.RAGGED_DECODE))
        chunk_list = []
        for job, n in plan:
            start = job.p0 + job.done
            entries.append((job.slot, start, n, P.RAGGED_PREFILL))
            chunk_list.append((job, n, start))
        meta, tok_row, tok_pos, offsets, stats = P.build_ragged_meta(
            entries, width=W, tile=tile)
        n_dec = len(rows)
        dev_np = P.build_device_meta(entries, offsets, n_derived, width=W, tile=tile)
        toks = np.zeros((W,), np.int32)
        dec_flag = np.zeros((W,), bool)
        dec_idx = np.zeros((B,), np.int32)
        K1 = self._spec_k_max + 1 if self._spec_capable else 1
        sp_on = np.zeros((B,), bool)
        sp_idx = np.zeros((B, K1), np.int32)
        sp_nd = np.zeros((B,), np.int32)
        dec_on = np.zeros((B,), bool)
        for b, off in zip(rows, offsets[:n_dec]):
            # a row's FIRST flat slot takes the slot's token and position
            # from the device state, decode and verify rows alike
            dec_flag[off] = True
            if b in spec_rows:
                kb, drafts, _ = spec_rows[b]
                sp_on[b] = True
                sp_nd[b] = kb
                idxs = off + np.arange(K1, dtype=np.int32)
                idxs[kb + 1:] = off + kb  # repeat the last valid index
                sp_idx[b] = idxs
                if drafts is not None:  # n-gram drafts ride the host plan
                    toks[off + 1: off + 1 + kb] = drafts
            else:
                dec_on[b] = True
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
        # the verify launch runs only with a verify row or a frozen slot:
        # every other launch is the plain mixed launch
        use_spec = bool(spec_rows) or any(b in self._spec_inflight for b in assigned)
        if self._draft_mode:
            # keep the draft pool tracking the stream: every mixed launch
            # lands its prompt chunks and each row's current token there
            # (decode chunks leave holes that cost draft quality only)
            self._fill_graph()
        if use_spec:
            self._upload_into(self._spec_in.plan, (dec_on, sp_on, sp_idx, sp_nd))
            if self._draft_mode and spec_rows:
                self._propose_graph()  # the proposals, on the device
            packed = self._spec_graph()
        else:
            packed = self._mixed_graph()
        handle = self._to_host(packed)
        # host bookkeeping after the launch is enqueued: a verify row's
        # advance is data-dependent, so the host learns it from the fetch
        spec_meta = {}
        for b in rows:
            self._row_inflight[b] += 1
            if b not in spec_rows:
                self._host_pos[b] += 1
                continue
            nd, _, pred = spec_rows[b]
            req = self._assignment[b]
            spec_meta[b] = (req, nd)
            if devmeta:
                pending = self._spec_pending.setdefault(b, [])
                if pending:
                    self.spec_pipelined += 1
                pending.append({"req": req, "nd": nd, "pred": pred, "adv": nd + 1})
            else:
                self._spec_inflight[b] = (req, nd)
        if spec_rows:
            drafted = sum(nd for nd, _, _ in spec_rows.values())
            self._m.spec_launches.labels(
                mode="draft_model" if self._draft_mode else "ngram").inc(len(spec_rows))
            self._m.spec_drafted.inc(drafted)
            self.spec_launches += len(spec_rows)
            self.spec_drafted += drafted
            for b, (nd, _, _) in spec_rows.items():
                self._sched.count_spec_plan(nd)
                req = self._assignment[b]
                req.spec_launches += 1
                req.spec_drafted += nd
        for slot, req in completions.items():
            job = self._prefilling.pop(slot)
            self._jobs.remove(job)
            self._host_pos[slot] = job.prompt_len
            if self._bpx is not None:
                # the prompt's full blocks are complete and immutable once
                # this launch lands; later reads serialize behind it. An
                # adapter's chains hang under its own root
                self._bpx.register(job.ids, job.prompt_len, req.block_ids,
                                   adapter=req.adapter)
        if self._shadow is not None:
            # blocks this launch filled: the capture's gather runs behind it
            for job, _, _ in chunk_list:
                self._shadow_capture(job.req, written=job.p0 + job.done)
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
        # the decode snapshot: rows decoding or verifying at launch (a
        # host-planned slot frozen behind an unfetched verify row carries
        # no row and emits nothing here)
        snapshot = [self._assignment[b] if b in active else None for b in range(B)]
        t_launch = time.perf_counter()
        if self._trace_rate > 0.0:
            self._prof_note_launch(
                "mixed", t_launch, snapshot, seq=self._mutation_seq,
                decode_rows=n_dec, prefill_chunks=len(chunk_list),
                prefill_tokens=n_pf_tokens,
                spec_drafted=sum(nd for nd, _, _ in spec_rows.values()))
        return ("mixed", handle, snapshot, completions, t_launch,
                self._mutation_seq, spec_meta if use_spec else None)

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
        _, handle, snapshot, completions, t_launch, seq, spec_meta = step
        faults.check("fetch", tag=",".join(r.prompt for r in snapshot if r is not None))
        packed = self._fetch(handle)  # [5, B], or [5 + 2(K+1) + 1, B] with verify rows
        self._m.step.observe(max(0.0, time.perf_counter() - t_launch))
        emitted, mask, active, firsts = packed[:4]
        now = time.time()
        for slot, req in completions.items():
            if req.done.is_set() or req.drop_seq > seq:
                # drop_seq: preempted after this launch; its resume
                # regenerates the first token
                continue
            req.first_id = int(firsts[slot])
            if not req.ttft:
                req.ttft = now - req.t_start
            self._count_admission(req)
            self._post_admit(req)
        em, mk = emitted[None, :], mask[None, :].astype(bool)
        prof_acc = 0
        if spec_meta:
            # one emission matrix: decode rows keep their token in row 0,
            # verify rows splice their whole stream, and _distribute applies
            # the same stop / deadline / finalize discipline to both
            K1 = self._spec_k_max + 1
            sp_emit = packed[5: 5 + K1]
            sp_mask = packed[5 + K1: 5 + 2 * K1].astype(bool)
            sp_adv = packed[5 + 2 * K1]
            em = np.zeros((K1, self.n_slots), emitted.dtype)
            mk = np.zeros((K1, self.n_slots), bool)
            em[0], mk[0] = emitted, mask.astype(bool)
            for slot, (req, nd) in spec_meta.items():
                em[:, slot] = sp_emit[:, slot]
                mk[:, slot] = sp_mask[:, slot]
                self._spec_inflight.pop(slot, None)
                pending = self._spec_pending.get(slot)
                if pending:
                    # fetches come in launch order: this one confirms the
                    # slot's OLDEST pending verify launch
                    pending.pop(0)
                    if not pending:
                        del self._spec_pending[slot]
                n_emit = int(sp_mask[:, slot].sum())
                acc = max(0, n_emit - 1)
                if (self._assignment[slot] is req and not req.done.is_set()
                        and req.drop_seq <= seq):
                    # the host position resyncs by the verify's advance, and
                    # the slot's acceptance sizes its next draft
                    self._host_pos[slot] += int(sp_adv[slot])
                    self._sched.observe_spec(slot, nd, acc)
                self._m.spec_accepted.inc(acc)
                self._m.spec_rejected.inc(max(0, nd - acc))
                self._m.spec_tokens.observe(n_emit)
                self.spec_accepted += acc
                req.spec_accepted += acc
                prof_acc += acc
        self._distribute(em, mk, active.astype(bool), snapshot, seq=seq)
        for b, r in enumerate(snapshot):
            if r is not None and self._row_inflight[b] > 0:
                self._row_inflight[b] -= 1
        if self._launch_log:  # empty at rate 0: one truthiness check
            self._prof_close_launch(t_launch, spec_accepted=prof_acc)
        self._healthy_fetch(seq)

    def _healthy_fetch(self, seq: int):
        """A launch fetched clean: reset the supervisor's consecutive-crash
        window, and vindicate the suspects when nothing was admitted after
        this launch (an older launch says nothing of a newer tenant)."""
        self._consecutive_crashes = 0
        if seq >= self._mutation_seq:
            self._suspects.clear()

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
        """Prefill and arm every parked, then queued, request a free slot
        (and, paged, pool blocks) can take. The wave's first tokens come
        back in ONE stacked copy at the end: the stop / budget decision
        already ran on the device when each slot was armed."""
        wave = []  # (req, first token [1] on the device)
        while True:
            with self._cv:
                # preempted requests resume FIRST: a victim must not also
                # lose its place behind the queue that evicted it
                from_resume = bool(self._resume)
                if not from_resume and not self._queue:
                    break
                free = [b for b, r in enumerate(self._assignment) if r is None]
                if not free:
                    break
                if (not from_resume and self.paged
                        and self._queue[0].need is not None
                        and self._queue[0].need > self._placeable()):
                    break  # a sized head that still cannot get blocks waits
                if from_resume:
                    req = self._resume.pop(0)
                else:
                    req = self._queue.pop(0)
                    self._note_queue_locked()
            if from_resume and req.cancelled:
                req.result = self._cancel_env(req)
                self._push_final(req)
                continue
            if (from_resume and req.allowed is not None
                    and len(req.salvaged) >= req.allowed):
                self._finalize(req)  # its budget was spent before the eviction
                continue
            try:
                # suspect-set bookkeeping: this request mutates the fleet
                # now; until a launch made after this point fetches clean,
                # a crash implicates it (_supervise)
                self._suspects.add(req)
                self._mutation_seq += 1
                # _admitting survives an exception unwind ON PURPOSE: the
                # supervisor salvages the request a crash cut mid-admission
                self._admitting = req
                if from_resume:
                    # "swap": restore the victim's shadowed chain first, so
                    # _admit_one's prefix plan hits it
                    self._prepare_resume(req)
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
            # any other exception escapes to the supervisor
            if first is _BLOCKED:
                # the pool cannot take it now: back to the front, and the
                # fleet keeps decoding until a release frees blocks
                with self._cv:
                    if from_resume:
                        self._resume.insert(0, req)
                    else:
                        self._queue.insert(0, req)
                        self._note_queue_locked()
                break
            if first is not None:  # None: failed fast, its result is set
                if from_resume and req.preempted_at:
                    self._m.resume_s.observe(time.time() - req.preempted_at)
                wave.append((req, first))
        if not wave:
            return
        firsts = torch.cat([f.reshape(1) for _, f in wave]).tolist()
        now = time.time()
        for (req, _), first_id in zip(wave, firsts):
            req.first_id = int(first_id)
            if not req.ttft:  # a resumed victim keeps its first TTFT
                req.ttft = now - req.t_start
            self._post_admit(req)

    def _admit_one(self, req: _Request, slot: int):
        """Prefill req's whole prompt (plus its salvaged continuation) past
        any block-prefix hit and arm `slot` (an adapter request holds its
        page from here, a constrained one its rows of the fleet's
        constraint table). Returns its first token ([1], on the device),
        None when it failed fast (its result is set), or _BLOCKED when the
        pool, the adapter pool or the constraint table cannot take it
        now."""
        eng, cfg = self.engine, self.cfg
        faults.check("admission", tag=req.prompt)
        if self._expired_in_queue(req):
            return None
        if not self._acquire_adapter(req):
            return _BLOCKED
        k = req.kwargs
        ids = self._admission_ids(req)
        prompt_len = len(ids)
        # a router's hint, then tier promotion: the plan below then sees
        # the deeper hit
        self._fabric_prefetch(req, ids)
        self._promote_local_chain(req, ids)
        # the ragged ingest reuses the deepest chain at EXACT depth; the
        # bucketed fallback degrades it to a depth its tail bucket fits
        p0, entry, plan = eng._prefix_plan(self._bpx if self.paged else self._prefix,
                                           ids, capacity=self.slot_max_seq,
                                           ragged=self._ragged, adapter=req.adapter)
        if plan is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the slot capacity "
                f"(slot_max_seq {self.slot_max_seq})"
            )
        max_tokens = self._admission_budget(req, prompt_len, p0)
        table_row = insert_row = None
        if self.paged:
            faults.check("alloc", tag=req.prompt)
            need_total = P.blocks_needed(prompt_len, max_tokens, self.kv_block_size)
            if self._grant_blocks(req, need_total, p0, entry) is None:
                self._release_adapter(req)
                return _BLOCKED
            table_row = np.zeros((self._max_blocks,), np.int32)
            table_row[:need_total] = req.block_ids  # the tail stays at the trash block
            # the bucketed insert scatters the WHOLE scratch row: its view
            # of the shared head goes to the trash block, so blocks other
            # tables read are never rewritten (the decode table keeps the
            # real row)
            insert_row = table_row.copy()
            insert_row[: p0 // self.kv_block_size] = P.TRASH_BLOCK
        if k.get("constraint") is not None:
            # the compiled artifact from the engine's LRU, then its rows in
            # the fleet's combined table; a full table backpressures as the
            # pool does, after giving back what this attempt was granted
            cart = eng._compile_constraint(k["constraint"])
            req.trace.checkpoint("constraint_compile")
            off = self._ctable.acquire(cart)
            if off is None:
                if req.block_ids is not None:
                    self._alloc.decref(req.block_ids)
                    req.block_ids = None
                self._release_adapter(req)
                return _BLOCKED
            req.cart = (cart, off)
        req.prefix_hit_tokens = p0
        try:
            faults.check("prefill", tag=req.prompt)
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
            # the first token's mask: the DFA state the salvaged
            # continuation reaches (the start state on a cold admission)
            bias = (eng._constraint_bias(req.cart[0], None, state=self._dfa_state(req))
                    if req.cart is not None else None)
            if self._ragged:
                # a hit's mapped head is attended in place, through the table
                if p0:
                    self._m.ragged_exact.inc()
                first = self._ragged_ingest(ids, p0, table_row, sampling, presence,
                                            page=req.adapter_page)
                req.prefill_chunks = -(-(prompt_len - p0) // self._ragged_width)
            elif self.paged:
                # the scratch is written in place and scattered below: a
                # failed ingest leaves it usable for the next admission. A
                # hit first gathers the shared head into it, so the tail
                # prefill attends real KV
                if p0:
                    (row_d,) = self._upload(table_row)
                    self.backend.fill_scratch_paged(self.cache, row_d, self._scratch)
                first, _, _ = eng._ingest(ids, p0, plan, self._scratch, self._gen,
                                          sampling, presence=presence)
                req.prefill_chunks = plan[0] + 1
            else:
                # a hit splices its snapshot into the scratch, the tail
                # prefills, the whole prompt's snapshot is stored
                first, _, _ = eng._ingest_with_prefix(
                    self._prefix, ids, p0, entry, plan, self._scratch, self._gen,
                    sampling, presence=presence, bias=bias,
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
                (row_d,) = self._upload(insert_row)
                self._commit(*self.backend.insert_slot_paged(
                    self.cache, self._scratch, self.state, self.sparams, slot,
                    row_d, *arm)[1:])
            else:
                self._commit(*self.backend.insert_slot(
                    self.cache, self._scratch, self.state, self.sparams,
                    slot, *arm)[1:])
        except BaseException:
            if req.block_ids is not None:
                # the admission died after its block grant: give them back
                self._alloc.decref(req.block_ids)
                req.block_ids = None
            if req.cart is not None:  # and the constraint table's refcount
                self._ctable.release(req.cart[0].key)
                req.cart = None
            self._release_adapter(req)  # and the adapter page
            raise
        if self.paged:
            self._table[slot] = table_row
            self._table_stale = True  # copied in before the next launch
            self._set_slot_page(slot, req.adapter_page)
        # the host position model of a slot armed here (whole-prefill
        # admission, and the chunked fleet's recovery re-admissions)
        self._host_pos[slot] = prompt_len
        self._sched.spec_reset(slot)
        if self._bpx is not None:
            # index the prompt's full blocks (complete and immutable once
            # the ingest lands; decode and tail writes land past them),
            # an adapter's under its own root
            self._bpx.register(ids, prompt_len, req.block_ids, adapter=req.adapter)
        req.ids = ids
        req.shadow_depth = 0
        if self._shadow is not None:
            # the capture's gather rides the launch stream behind the prefill
            self._shadow_capture(req, written=prompt_len)
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

    def _ragged_ingest(self, ids, p0, table_row, sampling, presence, page=None):
        """Prefill ids[p0:] straight into the pool: whole-width extend
        launches for the body of the tail, then ONE width-padded prefill
        launch that samples the first token off the last prompt token, all
        over the one-row table [1, MB] of this admission (a hit's mapped
        head is attended in place through it). `page`: the admission's
        adapter page, the [1] pages operand of every target launch (the
        draft model's stay base-only). Returns the first token [1]."""
        be, W = self.backend, self._ragged_width
        tail = ids[p0:]
        n_full = max(0, (len(tail) - 1) // W)  # leaves >= 1 sampling token
        (table1,) = self._upload(table_row[None, :])
        pages1 = (self._upload(np.asarray([page or 0], np.int32))[0]
                  if self._adapters is not None else None)
        for c in range(n_full):  # the pool is written in place
            args = self._ragged_launch_args(tail[c * W:(c + 1) * W], p0 + c * W)
            be.extend_ragged_paged(*args, self.cache, table1, pages=pages1)
            self._draft_extend(args, table1)
            self._m.ragged_launches.labels(phase="extend").inc()
        rem = tail[n_full * W:]
        args = self._ragged_launch_args(rem, p0 + n_full * W)
        self._draft_extend(args, table1)
        first, _, _ = be.prefill_ragged_paged(
            *args, self.cache, table1, len(rem) - 1, self._gen, sampling,
            presence=presence, pages=pages1)
        self._m.ragged_launches.labels(phase="prefill").inc()
        return first

    def _draft_extend(self, args, table1):
        """Draft-model speculation: the prompt lands in the draft pool too,
        through the same launch plan with the draft's weights."""
        if self._draft_mode:
            P.extend_ragged_paged(self._dcfg, self._dparams, *args, self._dpool,
                                  table1)

    def _post_admit(self, req: _Request):
        """A stop token first, or a zero budget, finishes the request at
        once (mirroring the on-device arming decision). A constrained slot
        arms its row of the FSM vector, IN PLACE on the launch stream
        before the next launch: the DFA advanced over the salvaged
        continuation, then the first token."""
        self.engine.flight.record(
            "admit", request_id=req.trace.request_id, slot=req.slot,
            prompt_tokens=req.prompt_tokens, budget=req.budget, slo_class=req.slo,
            **(self._alloc.span_attrs() if self.paged else {}))
        if req.first_id in self.cfg.all_stop_ids or req.budget == 0:
            self._finalize(req)
            return
        if req.cart is not None:
            cart, off = req.cart
            self._fsm[req.slot] = off + cart.advance(self._dfa_state(req), req.first_id)
        if req.stream_q is not None:
            self._stream_tokens(req)

    @staticmethod
    def _dfa_state(req: _Request) -> int:
        """The DFA state of req's constraint after its salvaged tokens."""
        art = req.cart[0]
        st = art.start
        for t in req.salvaged:
            st = art.advance(st, t)
        return st

    def _process(self, step):
        """Fetch one decode chunk's packed results and distribute them."""
        _, handle, snapshot, t_launch, seq = step
        faults.check("fetch", tag=",".join(r.prompt for r in snapshot if r is not None))
        packed = self._fetch(handle)  # [2K+1, B] — ONE copy per chunk
        self._m.step.observe(
            max(0.0, time.perf_counter() - t_launch) / self.chunk_steps)
        K = self.chunk_steps
        self._distribute(packed[:K], packed[K: 2 * K].astype(bool),
                         packed[2 * K].astype(bool), snapshot, seq=seq)
        if self._launch_log:
            self._prof_close_launch(t_launch)
        if self._chunk_unfetched > 0:
            self._chunk_unfetched -= 1
        self._healthy_fetch(seq)

    def _distribute(self, emitted, mask, active, snapshot, seq=None):
        """Attribute one fetched launch's emissions ([K, B] + final active
        row) to the snapshot's tenants, stream them, and handle stop /
        cancel / deadline / finalize. `seq` is the launch's mutation seq:
        a victim preempted after the launch drops its emissions (they are
        regenerated after the resume; appending them would corrupt the
        salvage order)."""
        deadline = self.engine.engine_cfg.request_deadline_s
        now = time.time()
        for b, req in enumerate(snapshot):
            if req is None or req.done.is_set():
                continue  # a freed tenant's masked leftovers
            if seq is not None and req.drop_seq > seq:
                continue  # preempted after this launch
            new = emitted[mask[:, b], b]
            req.tokens.extend(int(t) for t in new)
            if len(new) and self._shadow is not None:
                # decode crossed a block boundary? shadow the newly filled
                # blocks (the launch that filled them was fetched)
                self._shadow_capture(req)
            gen = None
            if len(new) and req.kwargs.get("stop"):
                gen = self._gen_text(req)
                if gen[2]:  # a textual stop sequence fired: free the slot now
                    if self._assignment[b] is req:
                        self._commit(G.kill_slot(self.state, b))
                        self._m.preempt.labels(reason="stop").inc()
                    self._finalize(req, pre=gen)
                    continue
                if req.stream_q is not None:
                    self._stream_tokens(req, pre=gen)
            elif req.stream_q is not None and len(new):
                self._stream_tokens(req)
            if self._assignment[b] is req and not active[b]:
                self._finalize(req, pre=gen)
            elif req.cancelled and self._assignment[b] is req:
                # the client went away: free the slot for queued work
                # instead of decoding to the request's full budget
                self._commit(G.kill_slot(self.state, b))
                self._m.preempt.labels(reason="cancelled").inc()
                log.info("request_cancelled", slot=b, cause=req.cancel_cause)
                req.result = self._cancel_env(req)
                self._release(req)
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
        """(generated ids — the salvaged continuation first — then the
        stop-truncated text, stop hit) for req."""
        head = ([req.first_id] if req.first_id is not None
                and req.first_id not in self.cfg.all_stop_ids else [])
        gen_ids = list(req.salvaged) + head + req.tokens
        text = self.engine.tokenizer.decode(gen_ids, skip_special_tokens=True)
        cut, hit = self.engine._truncate_at_stop(text, req.kwargs.get("stop"))
        return gen_ids, cut, hit

    def _finalize(self, req: _Request, pre=None):
        req.trace.checkpoint("decode")
        gen_ids, response, stopped = pre if pre is not None else self._gen_text(req)
        req.trace.checkpoint("detokenize")
        if req.stream_q is not None:
            # flush the held-back tail, exactly up to the response
            self._stream_tokens(req, final=True, pre=(gen_ids, response, stopped))
        elapsed = time.time() - req.t_start
        n = len(gen_ids)
        tps = n / elapsed if elapsed > 0 else 0.0
        tpot = max(0.0, elapsed - req.ttft) / (n - 1) if n > 1 else None
        if req.record:
            self.engine._record_sample(
                req.ttft, tps, n, elapsed=elapsed, engine="continuous",
                trace_id=req.trace_ctx.trace_id if req.trace_ctx is not None else None)
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
            # allowed: the total cap fixed at the first admission
            "finish_reason": "stop" if stopped or n < (
                req.allowed if req.allowed is not None else req.budget + 1
            ) else "length",
            "prefill_chunks": req.prefill_chunks,
            "token_ids": gen_ids,
        }
        if req.slo is not None:
            req.result["slo_class"] = req.slo
        if req.adapter is not None:
            req.result["adapter"] = req.adapter
        if req.tenant is not None:
            req.result["tenant"] = req.tenant
        if req.salvaged:
            # served across a restart or a preemption (continuation prefill)
            req.result["recovered"] = True
        if req.preemptions:
            req.result["preempted"] = req.preemptions
        if req.spec_launches or (req.spec_want and self._spec_req_ok(req)):
            # the path that served it and its draft / accept counts (a
            # non-greedy or penalized "speculative" request decodes plainly
            # and carries no marker)
            req.result["speculative"] = True
            req.result["spec_path"] = "fleet"
            req.result["spec_drafted"] = req.spec_drafted
            req.result["spec_accepted"] = req.spec_accepted
        if req.prefix_hit_tokens:
            req.result["prefix_cached_tokens"] = req.prefix_hit_tokens
        if req.cart is not None:
            req.result["constrained"] = True
        if req.fabric_blocks:
            # prefix blocks pulled over the KV fabric instead of prefilled
            req.result["kv_fabric_blocks"] = req.fabric_blocks
        if req.promoted_blocks:
            # prefix blocks promoted out of the shadow's host or disk tier
            req.result["kv_promoted_blocks"] = req.promoted_blocks
        if self.fabric_serving and req.ids is not None and req.adapter is None:
            # the prompt chain's parent-chained digests (deepest last): a
            # router learns residency from them, and a handoff's phase-2
            # hint carries the deepest. An adapter request exports none: its
            # KV was never shadowed
            ds = chunk_digests(req.ids, self.kv_block_size,
                               max_chunks=len(req.ids) // self.kv_block_size)
            if ds:
                req.result["kv_digests"] = ds[-8:]
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
        if req.cart is not None:
            # refcount down, and the slot's FSM row back to the free state
            # (in place, before the next launch): inert under any later
            # constrained chunk, and every live row is at 0 once none is
            # constrained, so the plain chunk may take over
            self._ctable.release(req.cart[0].key)
            if req.slot is not None:
                self._fsm[req.slot] = 0
            req.cart = None
        if req.block_ids is not None:
            # freed blocks may be re-granted before in-flight launches
            # drain: safe, device execution is serialized in launch order
            # and this slot's table row reverts to trash for later launches
            self._alloc.decref(req.block_ids)
            req.block_ids = None
            if req.slot is not None:
                self._table[req.slot] = 0
                self._table_stale = True
        if req.slot is not None:
            # the slot reverts to the base page: a frozen row that later
            # launches carry reads the all-zero page
            self._set_slot_page(req.slot, None)
        self._release_adapter(req)
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
        request (warmup excluded), put the final envelope (with "done":
        true) on a stream's queue, then wake submit()."""
        if req.result is not None:
            self.engine._finish_request(req.result, req.trace,
                                        engine="continuous", record=req.record)
            if req.stream_q is not None:
                req.stream_q.put({**req.result, "done": True})
        req.done.set()
