"""The dp x pp x tp x ep pipeline backend of the port (the JAX package's
parallel/pipeline.py: SPMDBackendBase and PipelineBackend).

One controller, many ranks. The JAX backend is one shard_map program that
one process drives over every device. Here each rank is a process
(parallel/mesh.py), and the caller's process is rank 0, the DRIVER. Every
engine-facing method of the backend is one PROGRAM: the driver sends its
name and its inputs to every worker (device tensors as host copies, each
generator as its state, each KV cache or block pool as a reference to the
rank's own shard), then runs its own shard of the program; every rank runs
the same code with its collectives in the same order, and the driver
returns what the JAX program returns. A worker that raises sends its error
back, and the driver re-raises it; a worker that dies is seen within the
group timeout, and the next program raises MeshError.

Inside a rank a program is the single device's own function from
engine/generate.py or engine/paged.py, run on a StageParams tree: its
embed, forward_layers and unembed (models/api.py) go to the rank's Stage,
which holds the rank's shard (parallel/partition.py) and runs the
recv-driven pipeline:

  1. the vocab-sharded embedding, summed over the pp group (every pp
     rank has the chunk's activation; parallel/vocab.py);
  2. stage s receives its activation from stage s - 1 (stage 0 keeps the
     embedding), runs its layers once, with the tp sums (and, on an MoE
     model over ep, the expert shares' sum) inside each layer, and sends
     the result to stage s + 1;
  3. at each unembed, the last stage's window reaches every pp rank (the
     JAX `_bcast`, pipeline.py:301), each rank computes its vocab shard of
     the logits and the shards are gathered, so every rank samples the
     same token from its copy of the generator and advances the same
     slot state.

The JAX microstep loop computes on every microstep and gates the cache
write to the owning microstep; the recv-driven form writes each stage's
cache once, with the same values and no gate. Under pp_wire_quant="int8"
each stage hand-off and each broadcast ship int8 rows plus fp32 scales
(ops/wire_quant.py), and the last stage round-trips its output once
where the JAX ring's last hop carries it home: the JAX program's
numerics, which `proxy_stage_generate` replays on one device.

dp: each dp index is an independent pipeline over its share of the batch
rows (the solo programs; the fleet needs dp = 1, as in the JAX package),
with its own generator (the JAX `_dp_key`); the rows are gathered for the
driver at the end of the program.

A mesh program spans processes, so it cannot be captured as one CUDA
graph: `supports_graphs` is False and the fleet launches it eagerly.

The other mesh backends (parallel/schedule.py's 1F1B schedule,
parallel/context.py's sequence ring) reuse this runner: their rank-side
bodies are module functions named "module:function" (a module of this
package's parallel/), called with the rank's RankPrograms first.
"""

from __future__ import annotations

import bisect
import collections
import functools
import hashlib
import importlib
import itertools
import os
import pickle
import threading
import time
import traceback
import weakref
from typing import Optional

import torch

from ..config import MeshConfig, ModelConfig, stage_layer_range
from ..engine import generate as G
from ..engine import paged as P
from ..models import api as M
from ..models.bridge import params_to
from ..ops.kv_quant import KVQuant
from ..ops.quant import Q4Tensor, QTensor, quantize_params
from ..ops.wire_quant import masked_psum, wire_recv, wire_roundtrip, wire_send
from .mesh import (
    AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, Mesh, MeshError, abort_groups, rank_coords,
)
from .partition import (
    init_sharded_cache, init_sharded_pool, padded_layers_per_stage, pool_layer_slice,
    pool_spec, shadow_block_spec, shard_params, validate_mesh,
)
from .vocab import embed_sharded, unembed_sharded


class StageLayers(dict):
    """A rank's stacked layer leaves; `stage` routes forward_layers."""

    stage = None


class StageParams(dict):
    """A rank's parameter tree: its shared leaves (vocab shards and
    replicated norms) and its StageLayers; models/api.py routes embed and
    unembed through `stage`."""

    def __init__(self, stage, shared: dict, layers: dict):
        super().__init__(shared)
        self.stage = stage
        self["layers"] = StageLayers(layers)
        self["layers"].stage = stage


class Stage:
    """One rank's shard of the model: its stage's layers between the pp
    neighbours, its tp share of each layer (its ep share of each expert
    bank), its vocab shard."""

    def __init__(self, cfg: ModelConfig, shared: dict, layers: dict, groups: dict,
                 wire_quant: Optional[str]):
        self.cfg = cfg
        self.shared = shared
        self.layers = layers
        self.pp = groups[AXIS_PP]
        tp, ep = groups[AXIS_TP], groups[AXIS_EP]
        self.tp = tp if tp.size > 1 else None
        self.ep = ep if ep.size > 1 else None
        self.sp = groups[AXIS_SP]
        self.s, self.S = self.pp.rank, self.pp.size
        # no wire on a singleton pp axis: a round trip there would break
        # the pp == 1 exactness
        self.wire_quant = wire_quant
        self.quant = wire_quant is not None and self.S > 1
        self.params = StageParams(self, shared, layers)

    def embed(self, tokens, pos):
        return embed_sharded(self.cfg, self.shared, tokens, pos, self.pp)

    def forward_layers(self, x, cache, pos, **kw):
        if self.s > 0:
            x = wire_recv(x, self.pp, self.s - 1, quant=self.quant)
        x, cache = M.family(self.cfg).forward_layers(
            self.cfg, self.layers, x, cache, pos, tp_group=self.tp, ep_axis=self.ep, **kw)
        if self.s < self.S - 1:
            wire_send(x, self.pp, self.s + 1, quant=self.quant)
        elif self.quant:
            x = wire_roundtrip(x)  # the JAX ring's hop home to stage 0
        return x, cache

    def unembed(self, x):
        x = masked_psum(x, self.pp, self.S - 1, quant=self.quant)
        return unembed_sharded(self.cfg, self.shared, x, self.pp)


# -- what crosses the control pipe ----------------------------------------------


class _Ref:
    """A KV cache or block pool, by the id every rank stores its shard under."""

    __slots__ = ("id",)

    def __init__(self, ref_id: int):
        self.id = ref_id


class _Gen:
    """A generator, by its state (every rank draws the same numbers)."""

    __slots__ = ("state",)

    def __init__(self, state: torch.Tensor):
        self.state = state


class MeshCache(dict):
    """The driver's handle on a KV cache or block pool of the mesh: the
    driver's own shard, and the id under which every rank holds its own."""

    mesh_ref = None


def _walk(obj, leaf):
    """obj with `leaf` applied to every tensor, generator and handle inside
    its dicts, lists, tuples, NamedTuples and quantized leaves."""
    out = leaf(obj)
    if out is not obj:
        return out
    if isinstance(obj, (QTensor, KVQuant)):
        return type(obj)(_walk(obj.q, leaf), _walk(obj.s, leaf))
    if isinstance(obj, Q4Tensor):
        return Q4Tensor(_walk(obj.q, leaf), _walk(obj.s, leaf), obj.g)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(o, leaf) for o in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(o, leaf) for o in obj)
    if isinstance(obj, dict):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    return obj


def _pack_leaf(obj):
    if isinstance(obj, MeshCache):
        return _Ref(obj.mesh_ref)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu") if obj.device.type != "cpu" else obj
    if isinstance(obj, torch.Generator):
        return _Gen(obj.get_state())
    return obj


def pack(args):
    """A program's inputs for the control pipe (host tensors, refs,
    generator states)."""
    return _walk(args, _pack_leaf)


# -- the rank side -----------------------------------------------------------------

# the programs whose body is the single device's own function on the rank's
# config (and, where True, its shard of the parameters), called as
# SingleDeviceBackend (engine/engine.py) calls it
_DIRECT = {
    "decode_slots": (G.decode_slots, True),
    "decode_slots_constrained": (G.decode_slots_constrained, True),
    "insert_slot": (G.insert_slot, False),
    "insert_slot_paged": (P.insert_slot_paged, False),
    "decode_slots_paged": (P.decode_slots_paged, True),
    "extend_ragged_paged": (P.extend_ragged_paged, True),
    "prefill_ragged_paged": (P.prefill_ragged_paged, True),
    "mixed_step_ragged": (P.mixed_step_ragged, True),
}


class RankPrograms:
    """Every program's body on one rank. `objs` holds this rank's caches
    and pools by ref id (the driver's are the handles it returned)."""

    def __init__(self, mesh_cfg: MeshConfig, rank: int, device, groups: dict):
        self.mesh_cfg = mesh_cfg
        self.rank = rank
        self.coords = rank_coords(mesh_cfg, rank)
        self.device = torch.device(device)
        self.groups = groups
        self.dpg = groups[AXIS_DP]
        self.wire = groups["wire_bytes"]
        self.comm_s = groups["comm_s"]
        self.objs: dict = {}
        self.stage: Optional[Stage] = None
        self.cfg: Optional[ModelConfig] = None
        self.layer_range = (0, 0)
        self._prof = None
        self._prof_t0 = 0.0

    def program(self, name: str):
        """The body of program `name` on this rank: a _DIRECT function on
        the rank's config and shard, a "module:function" of parallel/
        called with this RankPrograms first, or the method of that name."""
        if name in _DIRECT:
            fn, with_params = _DIRECT[name]
            return functools.partial(fn, self.cfg, *((self._params,) if with_params else ()))
        if ":" in name:
            mod, fn = name.split(":")
            module = importlib.import_module(f"{__package__}.{mod}")
            return functools.partial(getattr(module, fn), self)
        return getattr(self, name)

    # -- inputs ----------------------------------------------------------------------

    def unpack(self, args):
        """The driver's packed inputs as this rank's operands."""
        def leaf(obj):
            if isinstance(obj, torch.Tensor):
                return obj.to(self.device)
            if isinstance(obj, _Ref):
                return self.objs[obj.id]
            if isinstance(obj, _Gen):
                return self._generator(obj.state)
            return obj

        return _walk(args, leaf)

    def _generator(self, state: torch.Tensor) -> torch.Generator:
        """The driver's generator copied; a dp index > 0 draws its own
        stream (the JAX _dp_key: dp index 0 keeps the driver's)."""
        g = torch.Generator(device=self.device)
        g.set_state(state)
        d = self.coords[AXIS_DP]
        if d:
            h = hashlib.blake2b(state.numpy().tobytes() + d.to_bytes(4, "little"),
                                digest_size=8).digest()
            g.manual_seed(int.from_bytes(h, "little") >> 1)
        return g

    def take_wire(self) -> dict:
        out = dict(self.wire)
        self.wire.clear()
        return out

    # -- dp rows -----------------------------------------------------------------------

    def _rows(self, t, batch: int):
        """This dp index's rows of a [batch, ...] operand (others as they are)."""
        dp = self.dpg.size
        if t is None or dp == 1 or not isinstance(t, torch.Tensor) \
                or t.dim() == 0 or t.shape[0] != batch:
            return t
        b = batch // dp
        d = self.coords[AXIS_DP]
        return t[d * b:(d + 1) * b]

    def _cat(self, t):
        return self.dpg.all_gather(t, dim=0) if self.dpg.size > 1 else t

    # -- the model -----------------------------------------------------------------------

    def load(self, cfg: ModelConfig, params, seed: int, wire_quant):
        """Cut this rank's shard out of `params` (the whole tree), or out of
        random weights drawn from `seed` on this rank's device (quantized
        when cfg.quant asks, as runtime.create_engine does)."""
        pp, tp, ep = self.mesh_cfg.pp, self.mesh_cfg.tp, self.mesh_cfg.ep
        s, t, e = self.coords[AXIS_PP], self.coords[AXIS_TP], self.coords[AXIS_EP]
        if params is None:
            params = M.init_params(cfg, torch.Generator(device=self.device).manual_seed(seed))
            if cfg.quant is not None:
                params = quantize_params(cfg, params)
        shared, layers = shard_params(cfg, params, s, pp, t, tp, e, ep)
        del params
        shared, layers = params_to(shared, self.device), params_to(layers, self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the whole tree's segments, now unused
        self.cfg = cfg
        self.layer_range = stage_layer_range(cfg.n_layers, pp, s)
        self.stage = Stage(cfg, shared, layers, self.groups, wire_quant)

    @property
    def _params(self) -> StageParams:
        return self.stage.params

    @property
    def _n_layers(self) -> int:
        lo, hi = self.layer_range
        return hi - lo

    # -- the solo engine's programs -------------------------------------------------------

    def init_cache(self, ref: int, batch: int, max_seq: int):
        cache = init_sharded_cache(self.cfg, batch // self.dpg.size, max_seq,
                                   self._n_layers, self.mesh_cfg.tp, self.device)
        if self.rank:
            self.objs[ref] = cache
        return cache

    def prefill(self, tokens, pos, valid_len, cache, generator, sampling,
                valid_start=None, presence=None, bias=None):
        B = tokens.shape[0]
        first, logits, _ = G.prefill(
            self.cfg, self._params, self._rows(tokens, B), valid_len, cache,
            generator, sampling, self._rows(valid_start, B), pos,
            self._rows(presence, B), self._rows(bias, B))
        return self._cat(first), self._cat(logits), cache

    def extend(self, tokens, pos, cache):
        G.extend(self.cfg, self._params, self._rows(tokens, tokens.shape[0]), pos, cache)
        return cache

    def decode(self, first_token, cache, start_pos, limit, generator, sampling,
               valid_start=None, presence=None, counts=None, bias=None,
               constraint=None, *, max_steps, with_logprobs=False):
        B = first_token.shape[0]
        r = self._rows
        if constraint is not None:
            constraint = (r(constraint[0], B),) + tuple(constraint[1:])
        out = G.decode(
            self.cfg, self._params, r(first_token, B), cache, start_pos, limit,
            generator, sampling, r(valid_start, B), r(presence, B), r(counts, B),
            r(bias, B), constraint, max_steps=max_steps, with_logprobs=with_logprobs)
        gathered = tuple(self._cat(t) for t in out[:2])
        if with_logprobs:
            return gathered + (cache, self._cat(out[3]))
        return gathered + (cache,)

    # -- the fleets' programs (the rest are _DIRECT's) -------------------------------------

    def init_paged_pool(self, ref: int, n_blocks: int, block_size: int):
        pool = init_sharded_pool(self.cfg, n_blocks, block_size, self._n_layers,
                                 self.mesh_cfg.tp, self.device)
        if self.rank:
            self.objs[ref] = pool
        return pool

    def fill_scratch_paged(self, pool, table_row, scratch=None):
        return P.gather_scratch_blocks(pool, table_row, out=scratch)

    def gather_shadow_blocks(self, pool, block_ids):
        """The requested blocks with EVERY layer and kv head (the single
        device's [N, L, KV, bs(, Dh)] leaves): this rank's slice gathered
        over tp (heads), then over pp (layers; an uneven split's shorter
        stages padded to the JAX mesh's padded_layers_per_stage for the
        gather and cut after), on the axes of shadow_block_spec."""
        local = P.gather_shadow_blocks(pool, block_ids)
        return {n: (KVQuant(self._gather_blocks(l.q), self._gather_blocks(l.s))
                    if isinstance(l, KVQuant) else self._gather_blocks(l))
                for n, l in local.items()}

    def _gather_blocks(self, t: torch.Tensor) -> torch.Tensor:
        spec = shadow_block_spec(self.cfg)["k"]
        # an int8 pool's spec is (data, scales): the scales share the data's
        # leading axes
        spec = spec[0] if isinstance(spec[0], tuple) else spec
        l_ax, h_ax = spec.index(AXIS_PP), spec.index(AXIS_TP)
        tpg, ppg = self.groups[AXIS_TP], self.groups[AXIS_PP]
        if tpg.size > 1:
            t = tpg.all_gather(t, dim=h_ax)
        L, pp = self.cfg.n_layers, ppg.size
        per = padded_layers_per_stage(L, pp)
        if t.shape[l_ax] < per:
            pad = list(t.shape)
            pad[l_ax] = per - t.shape[l_ax]
            t = torch.cat([t, t.new_zeros(pad)], dim=l_ax)
        full = ppg.all_gather(t, dim=l_ax)
        keep = [full.narrow(l_ax, s * per, hi - lo)
                for s, (lo, hi) in enumerate(stage_layer_range(L, pp, s)
                                             for s in range(pp))]
        return torch.cat(keep, dim=l_ax).contiguous()

    def restore_shadow_blocks(self, pool, blocks, block_ids):
        lo, hi = self.layer_range
        local = pool_layer_slice(blocks, lo, hi, self.coords[AXIS_TP],
                                 self.mesh_cfg.tp)
        return P.restore_shadow_blocks(pool, local, block_ids)

    # -- observation ----------------------------------------------------------------------

    def health(self) -> dict:
        """This rank's line: a timed device probe, its layers and memory."""
        from ..utils.probe import probe_device

        dev = self.device
        line = {"rank": self.rank, "stage": self.coords[AXIS_PP],
                "tp_rank": self.coords[AXIS_TP], "dp_rank": self.coords[AXIS_DP],
                "sp_rank": self.coords[AXIS_SP], "ep_rank": self.coords[AXIS_EP],
                "devices": [str(dev)], "layers": list(range(*self.layer_range)),
                "pid": os.getpid(), **probe_device(dev)}
        if dev.type == "cuda":
            line["memory_allocated_bytes"] = int(torch.cuda.memory_allocated(dev))
        return line

    def launch_counts(self, reset: bool = False) -> dict:
        """Every kernel wrapper's launch count on this rank (engine/graphs
        COUNTERS); reset=True sets them to 0 first."""
        from ..engine import graphs

        if reset:
            for _, w, attr in graphs.COUNTERS:
                setattr(w, attr, 0)
        return graphs.launch_counts()

    def profile(self, start: bool) -> Optional[dict]:
        """Start this rank's torch.profiler and its collectives' clocks
        (start=True), or stop them and return, from the window between:
        "kernels" {name: launches} of the trace's device kernels,
        "busy_ms" the union of their intervals, "nccl_ms" the union of the
        NCCL kernels' (on the card they run while a peer is awaited, 0 over
        gloo), "wall_ms" the window, "comm_s" the host seconds inside each
        kind of collective (parallel/comm.py), and "experts_ms" the union
        of the kernel intervals inside the MoE FFN's expert range (its bank
        products; None where the trace holds no such range)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if start:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.comm_s.clear()
            # every thread's ops: on the driver the fleet's scheduler thread
            # runs the programs, not the thread that starts the profiler
            self._prof = profile(activities=acts, experimental_config=_all_threads())
            self._prof.__enter__()
            self._prof_t0 = time.perf_counter()
            return None
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self._prof_t0) * 1e3
        prof.__exit__(None, None, None)
        from ..models.llama import EXPERTS_RANGE

        # the raw kineto events: prof.events() would first build a tree of
        # every host op. The device events are the kernels and copies, and
        # the device spans of user annotations (the expert range)
        device = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()]
        kernels = [e for e in device if not e.is_user_annotation()]
        spans = [(e.start_ns(), e.end_ns()) for e in device
                 if e.is_user_annotation() and e.name() == EXPERTS_RANGE]
        ivs = [(e.start_ns(), e.end_ns()) for e in kernels]
        return {"kernels": dict(collections.Counter(e.name() for e in kernels)),
                "busy_ms": _union_ns(ivs) / 1e6,
                "nccl_ms": _union_ns((e.start_ns(), e.end_ns()) for e in kernels
                                     if "nccl" in e.name().lower()) / 1e6,
                "wall_ms": wall_ms, "comm_s": dict(self.comm_s),
                "experts_ms": _union_ns(_clip_ns(ivs, spans)) / 1e6 if spans else None}


def _clip_ns(intervals, spans):
    """The parts of the (start, end) intervals that fall inside spans."""
    merged = []
    for c, d in sorted(spans):
        if merged and c <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], d)
        else:
            merged.append([c, d])
    starts = [c for c, _ in merged]
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            c, d = merged[i]
            if d > a:
                yield max(a, c), min(b, d)
            i += 1


def _union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def _all_threads():
    """The profiler's config that records every thread's ops (None where
    this torch has no such option)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def serve_rank(mesh_cfg: MeshConfig, rank: int, device, groups: dict, conn):
    """A worker's loop: receive a program, run this rank's shard, answer
    ("ok" | "error", wire bytes sent, the result of a gathering program or
    the error's (type, message, traceback)); "close" ends it."""
    progs = RankPrograms(mesh_cfg, rank, device, groups)
    while True:
        try:
            name, args, kwargs, frees = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            name = "close"  # the driver is gone
        if name == "close":
            abort_groups(groups)
            return
        for ref in frees:
            progs.objs.pop(ref, None)
        gather = kwargs.pop("_gather", False)
        try:
            out = progs.program(name)(*progs.unpack(args), **progs.unpack(kwargs))
            reply = ("ok", progs.take_wire(), pack(out) if gather else None)
        except Exception as e:  # the driver re-raises it
            reply = ("error", progs.take_wire(),
                     (type(e).__name__, str(e), traceback.format_exc()))
        conn.send_bytes(pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL))


# -- the driver side ------------------------------------------------------------------


class SPMDBackendBase:
    """The driver's half of a mesh backend: the program runner, the rank-0
    shard, the wire accounting, health per rank, and close()."""

    name = "spmd-base"
    # a program spans processes: the fleet captures no CUDA graph of it
    supports_graphs = False

    def __init__(self, cfg: ModelConfig, params, mesh: Mesh, *,
                 wire_quant: Optional[str] = None, seed: int = 0):
        if wire_quant not in (None, "int8"):
            raise ValueError(
                f"pp_wire_quant must be None or 'int8', got {wire_quant!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.dp, self.pp, self.tp = mesh.cfg.dp, mesh.cfg.pp, mesh.cfg.tp
        self.sp, self.ep = mesh.cfg.sp, mesh.cfg.ep
        self.n_stages = self.pp
        self.wire_quant = wire_quant
        self.device = mesh.devices[0]
        validate_mesh(cfg, self.pp, self.tp, mesh.cfg.ep, params)
        # every program holds the lock for its whole run: one at a time
        self._lock = threading.RLock()
        self._refs = itertools.count(1)
        self._frees: list = []
        # bytes every rank sent on the wire, by path (what
        # dli_pp_wire_bytes_total counts once attach_wire_metrics ran)
        self.wire_bytes = collections.Counter()
        self._wire_metrics = None
        # the driver's side of every program: "programs" run, "input_bytes"
        # pickled down each worker's pipe, and the seconds spent packing and
        # sending them ("send_s"), in the driver's own shard ("shard_s") and
        # waiting for the workers' answers after it ("wait_s")
        self.program_stats = collections.Counter()
        self._rank = RankPrograms(mesh.cfg, 0, self.device, mesh.groups)
        self._run("load", cfg, params, seed, wire_quant)

    # -- the program runner ----------------------------------------------------------

    def _run(self, name: str, *args, _gather: bool = False, **kwargs):
        """Run program `name` on every rank; the driver's result (with
        _gather, every rank's, in rank order)."""
        with self._lock:
            self.mesh.check()
            t0 = time.perf_counter()
            frees, self._frees = self._frees, []
            msg = pickle.dumps((name, pack(args), {**pack(kwargs), "_gather": _gather},
                                frees), protocol=pickle.HIGHEST_PROTOCOL)
            self.mesh.send(msg)
            t1 = time.perf_counter()
            err = out = None
            try:
                out = self._rank.program(name)(*args, **kwargs)
            except Exception as e:  # re-raised below, once the workers answered
                err = e
            except BaseException:
                # interrupted: the workers' answers stay unread in the pipes
                self.mesh.broken = f"program {name!r} interrupted on the driver"
                raise
            t2 = time.perf_counter()
            try:
                replies = self.mesh.collect()
            except MeshError as me:
                raise me from err
            self.program_stats.update(programs=1, input_bytes=len(msg), send_s=t1 - t0,
                                      shard_s=t2 - t1, wait_s=time.perf_counter() - t2)
            sent = collections.Counter(self._rank.take_wire())
            for _, wire, _ in replies:
                sent.update(wire)
            self._account(sent)
            failed = [(r, p) for r, (status, _, p) in enumerate(replies, start=1)
                      if status == "error"]
            if err is None and not failed:
                return [out] + [p for _, _, p in replies] if _gather else out
            alike = err is not None and len(failed) == len(replies) and all(
                p[:2] == (type(err).__name__, str(err)) for _, p in failed)
            if alike:  # every rank refused the same input: the mesh is fine
                raise err
            first = failed[0] if failed else None
            self.mesh.broken = (f"program {name!r} failed on rank {first[0]}: "
                                f"{first[1][0]}: {first[1][1]}" if first else
                                f"program {name!r} failed on the driver: {err!r}")
            detail = f"\n{first[1][2]}" if first else ""
            raise MeshError(f"the mesh is unusable: {self.mesh.broken}{detail}") from err

    def _handle(self, local: dict, ref: int) -> MeshCache:
        """The driver's handle on a cache or pool all ranks hold under ref;
        when it is dropped the workers drop their shards at the next program."""
        h = MeshCache(local)
        h.mesh_ref = ref
        weakref.finalize(h, self._frees.append, ref)
        return h

    # -- wire accounting ----------------------------------------------------------------

    def attach_wire_metrics(self, registry):
        """Count every rank's wire bytes into the registry's
        dli_pp_wire_bytes_total{path} (path "microstep": a stage's
        hand-off, "broadcast": the last stage's window)."""
        self._wire_metrics = registry.counter(
            "dli_pp_wire_bytes_total",
            "inter-stage activation bytes shipped on the pp/sp wire, by "
            "transfer family", ("path",),
        )

    def _account(self, sent: collections.Counter):
        self.wire_bytes.update(sent)
        if self._wire_metrics is not None:
            for path, n in sent.items():
                self._wire_metrics.labels(path=path).inc(n)

    # -- observation and lifetime ----------------------------------------------------------

    # the rank coordinate /workers lists one line per value of: the stage
    # (the context backend's sp-only mesh lists its context shards)
    _worker_axis = AXIS_PP

    def health(self) -> list[dict]:
        """One line per stage (the worst of its ranks' statuses) holding
        every rank's line under "ranks". A program in flight answers "busy"
        after a short wait; a broken mesh answers without running one."""
        axis = self._worker_axis
        key = "stage" if axis == AXIS_PP else f"{axis}_rank"

        def lines(ranks: list) -> list:
            out = []
            for s in range(getattr(self.mesh.cfg, axis)):
                mine = [r for r in ranks if r[key] == s]
                worst = max(mine, key=lambda r: _STATUS_RANK.get(r.get("status"), 2))
                out.append({"stage": s, "devices": [d for r in mine for d in r["devices"]],
                            "layers": mine[0]["layers"], "status": worst["status"],
                            **({"error": worst["error"]} if "error" in worst else {}),
                            "ranks": mine})
            return out

        def placeholder(status: str, error: str) -> list:
            return lines([{"rank": r, "stage": c[AXIS_PP], "sp_rank": c[AXIS_SP],
                           "devices": [str(self.mesh.devices[r])],
                           "layers": list(range(*stage_layer_range(self.cfg.n_layers, self.pp,
                                                                   c[AXIS_PP]))),
                           "status": "online" if r == 0 and status != "error" else status,
                           "error": error}
                          for r, c in ((r, self.mesh.coords(r)) for r in range(self.mesh.world))])

        if self.mesh.broken is not None or self.mesh.closed:
            return placeholder("offline", self.mesh.broken or "the mesh is closed")
        if not self._lock.acquire(timeout=1.0):
            return placeholder("busy", "probe queued behind an in-flight program")
        try:
            return lines(self._run("health", _gather=True))
        except MeshError as e:
            return placeholder("offline", str(e))
        finally:
            self._lock.release()

    def launch_counts(self, reset: bool = False) -> list[dict]:
        """Every rank's kernel launch counts (reset=True: set to 0 first)."""
        return self._run("launch_counts", reset, _gather=True)

    def profile(self, start: bool):
        """Start every rank's torch.profiler and clear program_stats, or stop
        them and return {"ranks": each rank's RankPrograms.profile line,
        "driver": program_stats since the start}."""
        if start:
            self._run("profile", True, _gather=True)
            # the window starts once every rank's profiler is on: the
            # driver's shard ran before the workers' answers arrived
            self._rank._prof_t0 = time.perf_counter()
            self.program_stats.clear()
            return None
        driver = dict(self.program_stats)
        return {"ranks": self._run("profile", False, _gather=True), "driver": driver}

    def close(self):
        """Stop and join every worker rank."""
        self.mesh.close()


_STATUS_RANK = {"online": 0, "busy": 2, "error": 3, "offline": 4}


def _program(name: str):
    """A backend method that runs program `name` on every rank with the
    caller's arguments (the single device's method of that name, on the
    mesh)."""
    def run(self, *args, **kwargs):
        return self._run(name, *args, **kwargs)

    run.__name__ = run.__qualname__ = name
    run.__doc__ = f"Program {name!r} on every rank."
    return run


class PipelineBackend(SPMDBackendBase):
    """Engine-facing dp x pp x tp backend: the interface of the single
    device's backend (engine/engine.py), each method one program."""

    name = "pipeline"
    supports_ragged = True
    supports_constrain = True
    # scoring, beams (which reorder every rank's cache) and the solo
    # speculation loops are not served on a mesh yet
    supports_score = False
    supports_beam = False
    supports_speculative = False
    supports_draft = False

    # -- the solo engine -----------------------------------------------------------------

    def _check_rows(self, batch: int):
        if batch % self.dp:
            raise ValueError(f"batch={batch} not divisible by dp={self.dp}")

    def init_cache(self, batch: int, max_seq: int):
        self._check_rows(batch)
        ref = next(self._refs)
        return self._handle(self._run("init_cache", ref, batch, max_seq), ref)

    def prefill(self, tokens, prompt_len, cache, generator, sampling,
                valid_start=None, presence=None, bias=None):
        self._check_rows(tokens.shape[0])
        return self._run("prefill", tokens, 0, prompt_len, cache, generator,
                         sampling, valid_start, presence, bias)

    def prefill_at(self, tokens, pos, valid_len, cache, generator, sampling,
                   presence=None, bias=None):
        self._check_rows(tokens.shape[0])
        return self._run("prefill", tokens, pos, valid_len, cache, generator,
                         sampling, None, presence, bias)

    def extend(self, tokens, pos, cache):
        self._check_rows(tokens.shape[0])
        return self._run("extend", tokens, pos, cache)

    def decode(self, first_token, cache, start_pos, limit, generator, sampling,
               valid_start=None, presence=None, counts=None, bias=None,
               constraint=None, *, max_steps, with_logprobs=False):
        self._check_rows(first_token.shape[0])
        return self._run("decode", first_token, cache, start_pos, limit, generator,
                         sampling, valid_start, presence, counts, bias, constraint,
                         max_steps=max_steps, with_logprobs=with_logprobs)

    # -- the fleets (slot rows are slots, not data shards: dp == 1) ---------------------------

    @property
    def supports_slots(self) -> bool:
        return self.dp == 1 and self.cfg.arch in ("llama", "gpt2")

    supports_constrained_slots = supports_slots
    supports_paged = supports_slots
    supports_ragged_fill = supports_slots
    supports_mixed_step = supports_slots

    decode_slots = _program("decode_slots")
    decode_slots_constrained = _program("decode_slots_constrained")
    insert_slot = _program("insert_slot")

    def init_paged_pool(self, n_blocks, block_size):
        ref = next(self._refs)
        return self._handle(self._run("init_paged_pool", ref, n_blocks, block_size), ref)

    insert_slot_paged = _program("insert_slot_paged")
    fill_scratch_paged = _program("fill_scratch_paged")
    gather_shadow_blocks = _program("gather_shadow_blocks")
    restore_shadow_blocks = _program("restore_shadow_blocks")
    decode_slots_paged = _program("decode_slots_paged")
    extend_ragged_paged = _program("extend_ragged_paged")
    prefill_ragged_paged = _program("prefill_ragged_paged")
    mixed_step_ragged = _program("mixed_step_ragged")

    def pool_layout(self, pool) -> list:
        """The whole pool's leaves as shape-and-dtype stand-ins (the driver
        holds only its shard): what the shadow and the fabric check a
        chain's layout against: each axis of pool_spec that the pp or the
        tp group shards, whole."""
        spec = pool_spec(self.cfg)["k"]
        # an int8 pool's spec is (data, scales): the scales share the data's
        # leading axes
        spec = spec[0] if isinstance(spec[0], tuple) else spec
        out = []
        for leaf in P.pool_leaves(pool):
            shape = list(leaf.shape)
            shape[spec.index(AXIS_PP)] = self.cfg.n_layers
            shape[spec.index(AXIS_TP)] *= self.tp
            out.append(torch.empty(shape, dtype=leaf.dtype, device="meta"))
        return out

    def arm_slot_paged(self, state, sparams, slot, *arm):
        # the slot state is the driver's and reaches every rank with each
        # program: arming moves no cache, so it runs on the driver alone
        return P.arm_slot_only(self.cfg, state, sparams, slot, *arm)
