"""Per-fleet combined constraint tables for the continuous engine.

The slot fleet decodes in lock-step with ONE pair of (mask, transition)
tables shared by every row, so slots running DIFFERENT constraints need
their states to index one combined table. Row 0 is the FREE state (every
token allowed, self-loop): unconstrained slots simply sit at state 0 and
the constrained decode program is a uniform two-gather no-op for them.
Each resident constraint's artifact occupies rows [offset, offset + S) with
its transitions rebased by +offset; a slot's absolute FSM state is
offset + local state.

Residency is refcounted by constraint hash: admission `acquire`s (reusing
a resident entry or appending its rows), release `release`s. Appending
never moves resident rows — active slots hold absolute indices on device —
so zero-ref entries are reclaimed lazily: the next acquire that finds NO
active references resets the whole table. `acquire` returns None when the
capacity cannot take the artifact right now (same backpressure contract as
the paged block pool: requeue, retry after a release).

Table capacity is padded up a bucket ladder so the decode program only
recompiles when the fleet crosses a bucket, not on every admission.

Device side (`device_tables`): the fleet's constrained decode chunk is a
captured CUDA graph, which reads fixed addresses, so the tables are ONE
static pair of device buffers of `max_states` rows, allocated at the first
call, and a bucket's tables are the views of its first rows (the fleet
captures its constrained chunk once per bucket it crosses, over that
bucket's views). Rows change only IN PLACE, in the order they changed on
the host, on the stream current at the call (the fleet's launch stream):
an acquire writes its artifact's rows, a compaction returns the rows it
reclaims to the free state. The buffers live as long as the table, so no
captured graph ever reads freed memory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .tables import CompiledConstraint

STATE_BUCKETS = (32, 64, 128, 256, 512, 1024)


class FleetConstraintTable:
    def __init__(self, vocab_size: int, max_states: int = STATE_BUCKETS[-1],
                 registry=None):
        self.vocab_size = int(vocab_size)
        self.max_states = int(max_states)
        self._entries: dict = {}  # key -> {"art", "offset", "refs"}
        self._total = 1  # row 0 = the free state
        self._np: Optional[tuple] = None  # (mask, trans) padded to bucket
        # the static device pair [max_states, V] and the row writes not
        # yet applied to it: ("rows", offset, art) or ("free", lo, hi)
        self._dev: Optional[tuple] = None
        self._pending: list = []
        self.uploads = 0  # row writes applied to the device pair
        self.upload_bytes = 0
        # /metrics residency + backpressure (utils/metrics.py): gauges
        # track resident artifacts / occupied state rows, the counter
        # counts acquire() refusals (the requeue-and-retry backpressure
        # events the paged pool also reports)
        self._m_resident = self._m_states = self._m_backpressure = None
        if registry is not None:
            self._m_resident = registry.gauge(
                "dli_constraint_entries_resident",
                "constraint artifacts resident in the fleet table",
            ).labels()
            self._m_states = registry.gauge(
                "dli_constraint_states_resident",
                "fleet-table state rows occupied (row 0 = free state)",
            ).labels()
            self._m_states.set(self._total)
            self._m_backpressure = registry.counter(
                "dli_constraint_backpressure_total",
                "admissions refused because the fleet table was full",
            ).labels()

    def _update_gauges(self):
        if self._m_resident is not None:
            self._m_resident.set(len(self._entries))
            self._m_states.set(self._total)

    @property
    def any_active(self) -> bool:
        return any(e["refs"] > 0 for e in self._entries.values())

    def fits(self, art: CompiledConstraint) -> bool:
        """Could `art` EVER be admitted (even into an empty table)? False
        means route the request to the solo engine instead of queueing it
        behind a release that will never help."""
        return 1 + art.num_states <= self.max_states

    def acquire(self, art: CompiledConstraint) -> Optional[int]:
        """Resident offset for `art` (refcount bumped), or None when the
        table is full right now (backpressure: retry after a release)."""
        e = self._entries.get(art.key)
        if e is not None:
            e["refs"] += 1
            return e["offset"]
        if not self.any_active and self._entries:
            # no slot references any resident rows: safe to compact
            self._pending.append(("free", 1, self._total))
            self._entries.clear()
            self._total = 1
            self._np = None
        if self._total + art.num_states > self.max_states:
            self._update_gauges()
            if self._m_backpressure is not None:
                self._m_backpressure.inc()
            return None
        offset = self._total
        self._entries[art.key] = {"art": art, "offset": offset, "refs": 1}
        self._total += art.num_states
        self._np = None
        self._pending.append(("rows", offset, art))
        self._update_gauges()
        return offset

    def release(self, key: str):
        e = self._entries.get(key)
        if e is not None and e["refs"] > 0:
            e["refs"] -= 1

    def _bucket(self) -> int:
        for b in STATE_BUCKETS:
            if self._total <= b <= self.max_states:
                return b
        return self.max_states

    def numpy_tables(self) -> tuple:
        """(mask [B, V] bool, trans [B, V] int32) padded to the bucket.
        Padding rows are free rows — unreachable, but a garbage gather
        through one must never produce NaN logits."""
        if self._np is None:
            B = self._bucket()
            mask = np.ones((B, self.vocab_size), bool)
            trans = np.zeros((B, self.vocab_size), np.int32)
            for e in self._entries.values():
                art, off = e["art"], e["offset"]
                S = art.num_states
                mask[off: off + S] = art.mask
                trans[off: off + S] = art.next_state + off
                # EOS self-loops were absolute-local; rebase is uniform +off
            self._np = (mask, trans)
        return self._np

    def device_tables(self, device) -> tuple:
        """(mask [bucket, V] bool, trans [bucket, V] int32): the current
        bucket's views of the static device pair, equal to numpy_tables()
        once the pending row writes are applied, which this call does IN
        PLACE on the current stream (pinned host memory, non_blocking on
        the card), so they land after every launch already in flight and
        before the next one."""
        import torch

        dev = torch.device(device)
        if self._dev is None:
            self._dev = (
                torch.ones((self.max_states, self.vocab_size), dtype=torch.bool,
                           device=dev),
                torch.zeros((self.max_states, self.vocab_size),
                            dtype=torch.int32, device=dev),
            )
        mask, trans = self._dev
        cuda = dev.type == "cuda"

        def put(dst, a):
            src = torch.from_numpy(np.ascontiguousarray(a))
            if cuda:
                src = src.pin_memory()
            dst.copy_(src, non_blocking=cuda)
            self.upload_bytes += src.numel() * src.element_size()

        for op in self._pending:
            if op[0] == "free":
                _, lo, hi = op
                mask[lo:hi].fill_(True)
                trans[lo:hi].zero_()
            else:
                _, off, art = op
                S = art.num_states
                put(mask[off: off + S], art.mask)
                # EOS self-loops were absolute-local; rebase is uniform +off
                put(trans[off: off + S], art.next_state + np.int32(off))
            self.uploads += 1
        self._pending.clear()
        B = self._bucket()
        return mask[:B], trans[:B]

    def device_bytes(self) -> int:
        """Bytes of the static device pair (0 before the first upload)."""
        if self._dev is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._dev)

    def stats(self) -> dict:
        return {
            "resident": len(self._entries),
            "active": sum(e["refs"] > 0 for e in self._entries.values()),
            "states": self._total,
            "bucket": self._bucket(),
            "max_states": self.max_states,
        }
