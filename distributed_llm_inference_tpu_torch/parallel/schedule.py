"""Pipeline planning for the multi-process MPMD runtime
(serving/stage_runtime.py).

The pure, host-side half of the JAX package's parallel/schedule.py
(`plan_stages`, `mpmd_1f1b_order`), copied: each stage process owns a
contiguous layer slice and the controller drives microbatches through
them over the stage transport. The shard_map 1F1B backend of that file
(`MicrobatchPipelineBackend`) belongs to the meshes, which are not ported.
"""

from __future__ import annotations


def plan_stages(n_layers: int, n_stages: int) -> list:
    """Contiguous [lo, hi) layer ranges for each of `n_stages` stages.

    Remainder layers go to the EARLIEST stages (stage 0 also pays the
    embed, but the alternative — loading the tail stage, which already
    owns final_norm + lm_head — is strictly worse)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"need 1 <= n_stages ({n_stages}) <= n_layers ({n_layers})"
        )
    base, rem = divmod(n_layers, n_stages)
    ranges, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def mpmd_1f1b_order(n_stages: int, n_microbatches: int) -> list:
    """The 1F1B wavefront as an explicit event list: [(tick, stage,
    microbatch), ...] such that microbatch m hits stage s at tick m + s.

    Properties the runtime (and tests) rely on:
      * per-stage order is FIFO in microbatch id — so a stage worker
        draining a queue in arrival order IS this schedule;
      * stage s+1 sees microbatch m strictly after stage s does — the
        dependency chain is the tick ordering;
      * makespan is n_microbatches + n_stages - 1 ticks (the classic
        fill-drain trapezoid)."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("n_stages and n_microbatches must be >= 1")
    events = [
        (m + s, s, m)
        for m in range(n_microbatches)
        for s in range(n_stages)
    ]
    events.sort()
    return events
