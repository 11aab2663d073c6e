"""CUDA graphs for the continuous fleet's device launches: the port's
counterpart of the JAX package's jitted programs (engine/paged.py
`decode_slots_paged` :499-501, `mixed_step_ragged` :1130 without and with
its speculation operands, `mixed_fill_draft` :1225 and
`draft_propose_paged` :1256, and the dense engine/generate.py
`decode_slots` and `decode_slots_constrained`).

A launch kind is a function of no arguments over the fleet's STATIC
buffers: the slot state and knobs, the block table, the mixed launch's
inputs and the KV pool or cache. It reads them, writes the new slot state
back into them in place (`commit`) and returns one packed int32 result.
`LaunchGraph` runs it:

  * on the CPU, eagerly, on every call: the CPU has no graphs, and the
    caller chose it;
  * on CUDA, the first call runs it eagerly on a side stream (the warm
    launch: it loads the kernels' libraries, sets their shared-memory
    attributes and initialises cuBLAS on that stream, and its results are
    the call's), then captures it on that stream into one graph, with the
    fleet's generator registered so that every replay draws fresh numbers
    in turn with the eager draws. Every later call replays the graph on
    the current stream and returns the graph's static output.

A capture that fails raises GraphCaptureError with its cause: a CUDA fleet
never carries on with eager launches.

The dense fleet's constrained decode chunk (`decode_chunk_constrained`)
also reads the static FSM vector `fsm` [n_slots] int32 and the views of
the fleet's constraint table for one bucket (constrain/fleet.py): the
table's rows are rewritten in place on the launch stream, and the fleet
captures one graph per bucket it crosses (the JAX package recompiles its
constrained program at a bucket).

A fleet with an adapter pool (engine/adapters.py) hands its target
launch kinds a static `pages` [n_slots] int32 input, copied in place from
the host before each launch like the block table; the lora leaves the
graphs read are written in place on a page load. A fleet without a pool
passes pages=None and captures exactly the graphs it did before.

The static output is overwritten by the next replay, so a caller copies it
to the host on the same stream before it launches again (the fleet's
`_to_host`); every copy into a static input goes on that stream too, so a
launch in flight never sees the next launch's operands.

The kernel wrappers count their launches in Python, so their counters move
at capture and never at replay. LaunchGraph records each counter's delta
over the capture, takes it back (a capture launches nothing), and adds it
on every replay, so a count means kernel launches on the card either way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import flash_attention as _fa
from ..ops import paged_attention as _pa
from ..ops import quant as _q
from . import generate as G
from . import paged as P

# every kernel wrapper's launch counter: (name, wrapper, attribute)
COUNTERS = (
    ("flash_attend", _fa.flash_attend, "launches"),
    ("flash_attend[int8]", _fa.flash_attend, "launches_int8"),
    ("ragged_paged_attend", _pa.ragged_paged_attend, "launches"),
    ("ragged_paged_attend[int8]", _pa.ragged_paged_attend, "launches_int8"),
    ("paged_flash_attend", _pa.paged_flash_attend, "launches"),
    ("paged_flash_attend[int8]", _pa.paged_flash_attend, "launches_int8"),
    ("flash_attend_slots", _pa.flash_attend_slots, "launches"),
    ("q4_matmul_rows", _q.q4_matmul_rows, "launches"),
)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(w, attr) for name, w, attr in COUNTERS}


def _add_counts(deltas: dict, sign: int = 1):
    for name, w, attr in COUNTERS:
        setattr(w, attr, getattr(w, attr) + sign * deltas[name])


class GraphCaptureError(RuntimeError):
    """A launch kind could not be captured as a CUDA graph."""


def commit(dst, src):
    """Copy src's tensors into dst's in place: NamedTuples of tensors
    (SlotState, SlotParams, MixedArm), nested ones field by field. A
    field that already is its destination is left alone."""
    for d, s in zip(dst, src):
        if isinstance(d, tuple):
            commit(d, s)
        elif d is not s:
            d.copy_(s)


class LaunchGraph:
    """One launch kind of a fleet, captured once and replayed (see the
    module docstring); `generator` is the one its launch draws from.
    `calls`, `captures` and `replays` count what it did; `deltas` holds
    each kernel counter's launches per replay. eager=True runs the launch
    as it is on every call, on any device: a backend whose launches span
    processes (parallel/pipeline.py) declares that, and no capture is
    tried."""

    def __init__(self, fn: Callable[[], torch.Tensor], name: str, device,
                 generator: torch.Generator, eager: bool = False):
        self.fn = fn
        self.eager = eager
        self.name = name
        self.device = torch.device(device)
        self.generator = generator
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.deltas: Optional[dict] = None
        self.calls = 0
        self.captures = 0
        self.replays = 0

    def __call__(self) -> Optional[torch.Tensor]:
        self.calls += 1
        if self.eager or self.device.type != "cuda":
            return self.fn()
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        _add_counts(self.deltas)
        self.replays += 1
        return self.out

    def _warm_and_capture(self) -> torch.Tensor:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn()  # the warm launch: eager, and its results are real
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = self.fn()
            except Exception as e:
                try:
                    graph.capture_end()  # leave capture mode; it reports the same fault
                except RuntimeError:
                    pass
                raise GraphCaptureError(
                    f"capturing the fleet's {self.name} as a CUDA graph failed: {e}"
                ) from e
            finally:
                after = launch_counts()
                _add_counts({k: after[k] - before[k] for k in after}, -1)
            graph.capture_end()
        current.wait_stream(side)
        if out is not None:  # a kind that only writes buffers returns None
            out.record_stream(current)
        self.graph, self.out = graph, static_out
        self.deltas = {k: after[k] - before[k] for k in after}
        self.captures += 1
        return out

    def close(self):
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None


# -- the fleet's launch kinds -----------------------------------------------------


class MixedInputs(NamedTuple):
    """The mixed launch's operands as static device buffers
    (engine/paged.mixed_step_ragged's), refilled in place before every
    launch."""

    tokens: torch.Tensor  # i32 [W]
    tok_row: torch.Tensor  # i32 [W]
    tok_pos: torch.Tensor  # i32 [W]
    dec_flag: torch.Tensor  # bool [W]
    meta: torch.Tensor  # i32 [G, 4]
    dec_idx: torch.Tensor  # i32 [B]
    arm: P.MixedArm
    dev: P.DeviceMeta


def mixed_inputs(width: int, tile: int, n_slots: int, vocab_size: int,
                 device=None) -> MixedInputs:
    """Zeroed static inputs of a mixed launch at a fixed width."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MixedInputs(
        z(width), z(width), z(width), z(width, dtype=torch.bool),
        z(width // tile, 4), z(n_slots),
        P.idle_mixed_arm(n_slots, vocab_size, device=device),
        P.idle_device_meta(width, tile, device=device),
    )


def decode_chunk(backend, state: G.SlotState, sparams: G.SlotParams, cache,
                 table: Optional[torch.Tensor], generator, num_steps: int,
                 pages: Optional[torch.Tensor] = None):
    """One decode chunk of the fleet over its static buffers: the paged
    decode (block table `table`, adapter `pages` per slot or None) or,
    with no table, the dense one. The state is written back in place;
    returns the packed [2K+1, B]."""
    if table is not None:
        emitted, mask, new, _ = backend.decode_slots_paged(
            state, cache, table, generator, sparams, num_steps=num_steps,
            pages=pages)
    else:
        emitted, mask, new, _ = backend.decode_slots(
            state, cache, generator, sparams, num_steps=num_steps)
    commit(state, new)
    return G.pack_chunk(emitted, mask, state.active)


def decode_chunk_constrained(backend, state: G.SlotState, sparams: G.SlotParams,
                             cache, fsm: torch.Tensor, cmask: torch.Tensor,
                             ctrans: torch.Tensor, generator, num_steps: int):
    """One constrained decode chunk of the dense fleet over its static
    buffers: the FSM states `fsm` [B] index the fleet table (cmask [S, V]
    bool, ctrans [S, V] int32; row 0 the free state). The state and the
    FSM states are written back in place; returns the packed [2K+1, B]."""
    emitted, mask, new, _, new_fsm = backend.decode_slots_constrained(
        state, cache, generator, sparams, fsm, cmask, ctrans, num_steps=num_steps)
    commit(state, new)
    fsm.copy_(new_fsm)
    return G.pack_chunk(emitted, mask, state.active)


def mixed_launch(backend, inputs: MixedInputs, cache, table: torch.Tensor,
                 state: G.SlotState, sparams: G.SlotParams, generator,
                 pages: Optional[torch.Tensor] = None):
    """One mixed launch of the fleet over its static buffers (adapter
    `pages` per slot or None). The state and knobs are written back in
    place; returns the packed [5, B]."""
    i = inputs
    packed, new_state, new_sparams, _ = backend.mixed_step_ragged(
        i.tokens, i.tok_row, i.tok_pos, i.dec_flag, i.meta, cache, table,
        state, sparams, generator, i.dec_idx, i.arm, dev=i.dev, pages=pages,
    )
    commit(state, new_state)
    commit(sparams, new_sparams)
    return packed


# -- speculation: the verify launch and the draft model's launches -----------


class SpecInputs(NamedTuple):
    """The speculative mixed launch's extra static buffers: its SpecPlan
    and the draft model's proposals (written by the propose launch; an
    n-gram fleet's drafts ride MixedInputs.tokens)."""

    plan: P.SpecPlan  # dec_on / on [B], idx [B, K+1], n_draft [B]
    toks: torch.Tensor  # i32 [B, K]


def spec_inputs(n_slots: int, draft_len: int, device=None) -> SpecInputs:
    """Static spec buffers: an idle plan and zero proposals."""
    return SpecInputs(
        P.idle_spec_plan(n_slots, draft_len, device=device),
        torch.zeros((n_slots, draft_len), dtype=torch.int32, device=device),
    )


def mixed_spec_launch(backend, inputs: MixedInputs, spec: SpecInputs, cache,
                      table: torch.Tensor, state: G.SlotState,
                      sparams: G.SlotParams, generator, draft_toks: bool,
                      pages: Optional[torch.Tensor] = None):
    """One mixed launch with verify rows over the static buffers (the
    proposals scattered in when `draft_toks`; adapter `pages` per slot or
    None). The state and knobs are written back in place; returns the
    packed [5 + 2(K+1) + 1, B]."""
    i = inputs
    packed, new_state, new_sparams, _ = backend.mixed_step_ragged(
        i.tokens, i.tok_row, i.tok_pos, i.dec_flag, i.meta, cache, table,
        state, sparams, generator, i.dec_idx, i.arm, spec=spec.plan,
        spec_toks=spec.toks if draft_toks else None, dev=i.dev, pages=pages,
    )
    commit(state, new_state)
    commit(sparams, new_sparams)
    return packed


def draft_fill(dcfg, dparams, inputs: MixedInputs, dpool, table: torch.Tensor,
               state: G.SlotState):
    """Land a mixed launch's tokens in the draft pool (in place), reading
    the slot state before the launch."""
    i = inputs
    P.mixed_fill_draft(dcfg, dparams, i.tokens, i.tok_row, i.tok_pos,
                       i.dec_flag, i.meta, dpool, table, state.token, state.pos,
                       dev=i.dev)


def draft_propose(dcfg, dparams, state: G.SlotState, dpool, table: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The draft chain from every slot's current token and position; the
    proposals go into the static `out` [B, K] in place, which it
    returns."""
    props, _ = P.draft_propose_paged(dcfg, dparams, state.token, state.pos, dpool,
                                     table, draft_len=out.shape[1])
    out.copy_(props)
    return out
