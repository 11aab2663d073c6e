"""Prefix KV cache of the solo engine and the dense fleet: chunk-aligned
prompt-prefix snapshots (the JAX package's engine/prefix.py in PyTorch).

After a prefill, the KV of the prompt's chunk-aligned prefix is copied out
of the cache (a snapshot); a later request whose prompt starts with the
same tokens splices the snapshot back into its cache, in place, and
prefills only the tail from the cached offset through the chunked-prefill
machinery (the tail's T > 1 chunks run the flash kernel on the card).
TTFT then scales with the new tokens, not the whole prompt.

Causal correctness: KV at slot i depends only on tokens[:i+1], so the
first P slots of a snapshot are valid for any prompt whose first P tokens
match the snapshot's. Lookup reuses the longest common token prefix,
floored to the chunk, and splices only those slots.

Store discipline: a snapshot is a copy ([L, 1, KV, P, Dh] per leaf; an
int8 cache's KVQuant leaves copy their scales [L, 1, KV, P] too, which
share the sequence axis 3), never a view of the live cache, which the
next request rewrites. A splice writes into the live cache in place, so
a cache that must keep its address (the dense fleet's admission scratch)
keeps it. LRU-bounded by entry count. Only the plain {"k", "v"} cache
layout participates.

The paged fleet shares prefixes by block instead (engine/block_prefix.py).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from ..ops.kv_quant import KVQuant
from .generate import map_cache


def _leaves(cache):
    """(name, tensor) of every tensor of a {"k", "v"} cache, an int8
    leaf's data and scales alike (both carry the sequence on axis 3)."""
    for name, x in cache.items():
        if isinstance(x, KVQuant):
            yield (name, "q"), x.q
            yield (name, "s"), x.s
        else:
            yield (name, None), x


def _extract(cache, p: int) -> dict:
    """A copy of slots [0, p) of every leaf (a snapshot, not a view)."""
    return map_cache(cache, lambda x: x[:, :, :, :p].clone())


def _splice(cache, entry: dict, p: int):
    """Write the snapshot's first p slots into slots [0, p) of the cache,
    in place. Returns the cache."""
    src = dict(_leaves(entry))
    for key, big in _leaves(cache):
        big[:, :, :, :p].copy_(src[key][:, :, :, :p])
    return cache


def snapshot_bytes(entry: dict) -> int:
    """Device bytes one snapshot holds."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(entry))


class PrefixCache:
    """LRU store of chunk-aligned prompt-prefix KV snapshots.

    registry (utils/metrics.MetricsRegistry, optional): hit / miss /
    eviction counters and an entry gauge, labelled by `scope`: the solo
    engine ("solo") and the dense fleet ("continuous") own separate
    instances."""

    def __init__(self, max_entries: int, chunk: int, registry=None,
                 scope: str = "solo"):
        if max_entries < 1:
            raise ValueError("prefix cache needs max_entries >= 1")
        if chunk < 1:
            raise ValueError("prefix cache needs chunk >= 1")
        self.max_entries = int(max_entries)
        self.chunk = int(chunk)
        self._entries: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
        # guards _entries and the counters: lookup / mark / store run under
        # the engine's lock (or on the fleet's worker), stats() on others
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._m_hits = self._m_misses = self._m_evictions = None
        self._m_entries = None
        if registry is not None:
            self._m_hits = registry.counter(
                "dli_prefix_cache_hits_total",
                "prefix-cache hits (tail actually planned and spliced)",
                ("scope",),
            ).labels(scope=scope)
            self._m_misses = registry.counter(
                "dli_prefix_cache_misses_total", "prefix-cache misses",
                ("scope",),
            ).labels(scope=scope)
            self._m_evictions = registry.counter(
                "dli_prefix_cache_evictions_total",
                "prefix snapshots evicted by the LRU bound", ("scope",),
            ).labels(scope=scope)
            self._m_entries = registry.gauge(
                "dli_prefix_cache_entries", "resident prefix snapshots",
                ("scope",),
            ).labels(scope=scope)

    @staticmethod
    def compatible(cache) -> bool:
        """Only plain {k, v} cache layouts can snapshot and splice (a
        mesh's cache handle holds one rank's shard only)."""
        return type(cache) is dict and set(cache) == {"k", "v"}

    def lookup(self, ids: list) -> tuple[int, Optional[dict], Optional[tuple]]:
        """(P, entry, key) for the deepest reusable snapshot; (0, None,
        None) on a miss. Pure: no counters or LRU promotion; the engine
        calls mark() once it knows whether the reuse planned.

        Reuse depth = the longest common token prefix between a stored
        snapshot's ids and the request, compared a chunk at a time and
        capped to leave at least one tail token to prefill."""
        ids_t = tuple(ids)
        cap = ((len(ids_t) - 1) // self.chunk) * self.chunk
        best_p, best_key, best = 0, None, None
        with self._lock:
            for key, entry in self._entries.items():
                limit = min(len(key), cap)
                p = 0
                while (p < limit
                       and key[p:p + self.chunk] == ids_t[p:p + self.chunk]):
                    p += self.chunk
                p = min(p, limit)
                if p > best_p:
                    best_p, best_key, best = p, key, entry
        if best is None or best_p < self.chunk:
            return 0, None, None
        return best_p, best, best_key

    def mark(self, key: Optional[tuple], hit: bool, depth: int = 0) -> None:
        """Record the request's outcome; a real hit (its tail planned and
        spliced) promotes the entry. depth is part of the planner protocol
        (engine._prefix_plan) and unused here."""
        del depth
        with self._lock:
            if hit:
                self.hits += 1
                if key in self._entries:
                    self._entries.move_to_end(key)
            else:
                self.misses += 1
        m = self._m_hits if hit else self._m_misses
        if m is not None:
            m.inc()

    def splice(self, entry: dict, cache, p: int):
        """Write the snapshot's first p slots into the cache, in place."""
        return _splice(cache, entry, p)

    def store(self, ids: list, prompt_len: int, cache) -> int:
        """Snapshot the chunk-aligned prefix of a just-prefilled prompt.
        Returns the stored length (0 below one chunk or already stored)."""
        p = (prompt_len // self.chunk) * self.chunk
        if p < self.chunk:
            return 0
        key = tuple(ids[:p])
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return 0
        snapshot = _extract(cache, p)
        evicted = 0
        with self._lock:
            if key in self._entries:
                # two threads raced past the first check and both copied
                # (the copy runs outside the lock): keep the first
                self._entries.move_to_end(key)
                return 0
            self._entries[key] = snapshot
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
            n_entries = len(self._entries)
        if self._m_evictions is not None:
            if evicted:
                self._m_evictions.inc(evicted)
            self._m_entries.set(n_entries)
        return p

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "cached_tokens": sum(len(k) for k in self._entries),
            }
