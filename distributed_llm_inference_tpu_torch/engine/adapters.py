"""Paged runtime LoRA adapter pool: many adapters over one resident base
model (the JAX package's engine/adapters.py in PyTorch).

Merge-at-load (models/lora.merge_lora) bakes ONE adapter into the dense
weights. The pool serves many: the base model's layer stack grows
fourteen `lora_{leaf}_{a,b}` leaves, each a PAGED stack of low-rank
factors in the model dtype,

    lora_wq_a [L, P, D, r]     lora_wq_b [L, P, r, H*Dh]   (etc.)

with P = adapter_slots + 1 pages. Page 0 is the reserved BASE page:
all-zero, never written, never evicted; a row on page 0 computes the
base output bit for bit (models/llama.decoder_layer SELECTS the base
product there instead of adding a zero delta). Registered adapters
(models/lora.load_lora_stacked: rank-padded, scale folded into b) are
copied into pages 1..P-1 IN PLACE (the backend's write_adapter_page), so
every captured CUDA graph keeps reading the same leaves; each launch
takes the per-row page ids as a device operand, and one graph serves any
adapter mix.

The pool's discipline is engine/paged.BlockAllocator's: a page is
refcounted (one holder per slot serving the adapter), a refcount-0
resident parks in an LRU instead of being dropped (the next request for
it loads nothing), and a load under pressure evicts the LRU resident,
never a referenced page. acquire() with every page referenced returns
None: backpressure, as block exhaustion is (the admission requeues at
the front and retries after a release).

Threading: acquire / release / reset_refs run only on the continuous
engine's worker thread; the lock is there because stats() and the
metrics render from serving threads. register() runs at startup and on
the admin path and takes the lock for the registry.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.logging import get_logger
from ..utils.metrics import register_adapter_metrics

log = get_logger("adapters")


def adapter_leaf_dims(cfg: ModelConfig) -> dict:
    """{base leaf: (in_dim, out_dim)} of every projection the adapter delta
    can target on this config (the mm sites of models/llama.decoder_layer;
    the stacked leaves hold W.T [in, out]). MoE configs carry no dense mlp
    leaves, so mlp-targeting adapters are rejected at registration."""
    D, Dh = cfg.dim, cfg.head_dim
    H, KV, F = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    dims = {
        "wq": (D, H * Dh),
        "wk": (D, KV * Dh),
        "wv": (D, KV * Dh),
        "wo": (H * Dh, D),
    }
    if not cfg.n_experts:
        dims.update({"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)})
    return dims


def lora_leaves(cfg: ModelConfig, slots: int, rank: int, device="cpu") -> dict:
    """The zeroed paged lora_* leaves of a whole model (page 0 = the base
    page), in the model dtype on `device`: {lora_{leaf}_a: [L, P, in, r],
    lora_{leaf}_b: [L, P, r, out]} for every projection an adapter can
    target."""
    if cfg.arch != "llama":
        raise ValueError(
            f"runtime adapters are wired for the llama family; got {cfg.arch!r}"
        )
    if slots < 1:
        raise ValueError(f"adapter_slots must be >= 1, got {slots}")
    if rank < 1:
        raise ValueError(f"adapter_rank must be >= 1, got {rank}")
    L, P, dt = cfg.n_layers, slots + 1, cfg.torch_dtype
    out = {}
    for leaf, (d_in, d_out) in adapter_leaf_dims(cfg).items():
        out[f"lora_{leaf}_a"] = torch.zeros((L, P, d_in, rank), dtype=dt, device=device)
        out[f"lora_{leaf}_b"] = torch.zeros((L, P, rank, d_out), dtype=dt, device=device)
    return out


def install_adapter_leaves(cfg: ModelConfig, params: dict, slots: int,
                           rank: int) -> dict:
    """Add the zeroed paged lora_* leaves (lora_leaves) to params["layers"],
    on the device of the params' embedding. Runs at engine build AFTER
    quantization: the lora leaves stay dense. Returns new dicts; the input
    is not modified."""
    leaves = lora_leaves(cfg, slots, rank, params["embed"].device)
    return {**params, "layers": {**params["layers"], **leaves}}


def write_lora_page(layers: dict, device, page: int, updates: dict):
    """Write one adapter into page `page` of the paged lora leaves in
    `layers`, IN PLACE: updates = {base leaf: (a [L, in, r], b [L, r, out])
    float32 host arrays} (a mesh rank's: its layers and tp columns), cast
    to the model dtype on the host. Every lora leaf the adapter does not
    target is zeroed on the page, so the page holds this adapter alone
    whatever it held before. A new tensor would leave every captured CUDA
    graph reading the old leaf. On the card each copy goes up through
    pinned memory on the current stream, the one the fleet's worker
    launches on, so it lands after every launch already in flight and
    before the first launch that reads the page."""
    cuda = torch.device(device).type == "cuda"
    for name, dst in layers.items():
        if name.startswith("lora_") and name[len("lora_"):-len("_a")] not in updates:
            dst[:, page].zero_()
    for leaf, (a, b) in updates.items():
        for suffix, val in (("a", a), ("b", b)):
            dst = layers[f"lora_{leaf}_{suffix}"]
            src = torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(dst.dtype)
            if cuda:
                src = src.pin_memory()
            dst[:, page].copy_(src, non_blocking=cuda)


class AdapterPool:
    """Refcounted LRU pool of device-resident LoRA adapters.

    backend must expose write_adapter_page(page, updates) (engine/
    engine.SingleDeviceBackend does); updates = {base leaf: (a [L, in, r],
    b [L, r, out]) host arrays}.

    registry (utils/metrics.MetricsRegistry, optional): the dli_adapter_*
    families, pre-registered by engine/engine.py.
    merged_source: the --lora merge-at-load directory, if any: registering
    the SAME adapter as a runtime adapter would apply its delta twice.
    """

    def __init__(self, cfg: ModelConfig, backend: Any, slots: int, rank: int,
                 registry=None, merged_source: Optional[str] = None):
        self.cfg = cfg
        self.backend = backend
        self.slots = int(slots)
        self.rank = int(rank)
        self.merged_source = os.path.abspath(merged_source) if merged_source else None
        self._dims = adapter_leaf_dims(cfg)
        # name -> host stacked tensors ({leaf: (a, b)} np.float32)
        self._registry: dict = {}  # guarded-by: _lock
        self._page_of: dict = {}  # name -> page (resident)
        self._name_of: dict = {}  # page -> name
        self._refs: dict = {}  # page -> holder count
        self._free = list(range(1, self.slots + 1))
        # refcount-0 residents, insertion order == LRU order
        self._lru: dict = {}  # name -> page (ordered)
        self._lock = threading.Lock()
        self.loads = 0
        self.evictions = 0
        self.swaps = 0
        self._m = None
        if registry is not None:
            self._m = register_adapter_metrics(registry)
            self._m.bytes.set(self.pool_bytes)

    # -- sizing --------------------------------------------------------------
    @property
    def pool_bytes(self) -> int:
        """Reserved device bytes of the paged lora leaves (fixed at install)."""
        per_page = sum((d_in * self.rank + self.rank * d_out) * self.cfg.n_layers
                       for d_in, d_out in self._dims.values())
        return per_page * (self.slots + 1) * self.cfg.torch_dtype.itemsize

    @property
    def total(self) -> int:
        return self.slots

    @property
    def free(self) -> int:
        """Pages acquirable now without backpressure: never-written free
        pages plus refcount-0 LRU residents."""
        with self._lock:
            return len(self._free) + len(self._lru)

    # -- registration (startup / admin path) ----------------------------------
    def register(self, name: str, source) -> None:
        """Register `name` -> host adapter tensors. `source` is a PEFT
        adapter directory (models/lora.load_lora_stacked) or a preloaded
        {leaf: (a, b)} dict. Rejects adapters targeting projections this
        config has no lora leaves for (MoE mlp), rank overflow (inside
        load_lora_stacked), empty or reserved names, double registration
        and the --lora merge-at-load directory."""
        if not name or not isinstance(name, str):
            raise ValueError("adapter name must be a non-empty string")
        if name == self.cfg.name:
            raise ValueError(
                f"adapter name {name!r} collides with the base model name "
                f"— `model: {name!r}` must keep meaning the base"
            )
        if isinstance(source, str):
            if (self.merged_source is not None
                    and os.path.abspath(source) == self.merged_source):
                raise ValueError(
                    f"adapter {name!r} points at {source!r}, which is "
                    f"already merged into the base weights (--lora "
                    f"merge-at-load, the single-adapter path); its output "
                    f"IS the base output — registering it again would "
                    f"apply the delta twice"
                )
            from ..models.lora import load_lora_stacked

            tensors = load_lora_stacked(self.cfg, source, self.rank)
        else:
            tensors = dict(source)
        bad = sorted(set(tensors) - set(self._dims))
        if bad:
            raise ValueError(
                f"adapter {name!r} targets projections with no adapter "
                f"leaves on this config: {bad} (MoE configs carry "
                f"attention adapters only)"
            )
        L = self.cfg.n_layers
        for leaf, (a, b) in tensors.items():
            d_in, d_out = self._dims[leaf]
            if a.shape != (L, d_in, self.rank) or b.shape != (L, self.rank, d_out):
                raise ValueError(
                    f"adapter {name!r} {leaf}: stacked shapes "
                    f"{a.shape}/{b.shape} do not match "
                    f"[L={L}, {d_in}|{d_out}, rank={self.rank}]"
                )
        with self._lock:
            if name in self._registry:
                raise ValueError(f"adapter {name!r} is already registered")
            self._registry[name] = tensors
        log.info("adapter_registered", name=name, leaves=sorted(tensors))

    def names(self) -> list:
        with self._lock:
            return sorted(self._registry)

    def is_registered(self, name: str) -> bool:
        with self._lock:
            return name in self._registry

    # -- page lifecycle (worker thread) ----------------------------------------
    def acquire(self, name: str) -> Optional[int]:
        """One holder on `name`'s device page, loading (and evicting) as
        needed. Returns the page id, or None when every page is referenced
        (the caller backpressures as on block exhaustion). KeyError for an
        unregistered name: the serving edge 400s those first."""
        with self._lock:
            if name not in self._registry:
                raise KeyError(f"unknown adapter {name!r}")
            page = self._page_of.get(name)
            if page is not None:
                self._refs[page] = self._refs.get(page, 0) + 1
                self._lru.pop(name, None)  # referenced: out of the LRU
                return page
            if self._free:
                page = self._free.pop()
                swapped = False
            elif self._lru:
                # evict the LRU refcount-0 resident; referenced pages are
                # untouchable
                victim, page = next(iter(self._lru.items()))
                self._lru.pop(victim)
                self._page_of.pop(victim, None)
                self._name_of.pop(page, None)
                self.evictions += 1
                swapped = True
            else:
                return None  # every page referenced: backpressure
            tensors = self._registry[name]
        # the device write runs OUTSIDE the lock: it is serialized on the
        # worker thread anyway, and a multi-MB host->device copy must not
        # block a /metrics render
        self.backend.write_adapter_page(page, tensors)
        with self._lock:
            self._page_of[name] = page
            self._name_of[page] = name
            self._refs[page] = 1
            self.loads += 1
            if swapped:
                self.swaps += 1
            n_resident = len(self._page_of)
        if self._m is not None:
            self._m.loads.inc()
            if swapped:
                self._m.swaps.inc()
                self._m.evictions.inc()
            self._m.resident.set(n_resident)
        log.info("adapter_loaded", name=name, page=page, swapped=swapped)
        return page

    def release(self, name: str) -> None:
        """Drop one holder; at refcount 0 the adapter PARKS in the LRU
        (still resident: the next acquire is free) instead of freeing its
        page."""
        with self._lock:
            page = self._page_of.get(name)
            if page is None:
                return
            refs = self._refs.get(page, 0) - 1
            if refs < 0:
                # an over-release is an accounting bug: surfaced, then
                # clamped so the pool keeps serving
                log.error("adapter_over_release", name=name, page=page)
                refs = 0
            self._refs[page] = refs
            if refs == 0:
                self._lru[name] = page

    def reset_refs(self) -> None:
        """The crash rebuild: every live holder died with the fleet and its
        re-admission re-acquires. The pages' CONTENT survives (the leaves
        live in the params, which the rebuild never touches), so every
        resident parks in the LRU and a recovered request loads nothing."""
        with self._lock:
            for name, page in self._page_of.items():
                self._refs[page] = 0
                self._lru.setdefault(name, page)

    def referenced(self) -> int:
        """Pages with live holders (0 once the fleet drained)."""
        with self._lock:
            return sum(1 for r in self._refs.values() if r > 0)

    def page_name(self, page: int) -> Optional[str]:
        with self._lock:
            return self._name_of.get(page)

    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": len(self._registry),
                "resident": len(self._page_of),
                "referenced": sum(1 for r in self._refs.values() if r > 0),
                "free": len(self._free) + len(self._lru),
                "total": self.slots,
                "loads": self.loads,
                "evictions": self.evictions,
                "swaps": self.swaps,
                "pool_bytes": self.pool_bytes,
            }


def attach_adapter_pool(engine, slots: int, rank: int) -> AdapterPool:
    """Install the paged lora leaves into a built engine's backend and hang
    an AdapterPool off it (engine.adapters), before a fleet is built over
    the engine (its graphs capture the leaves). runtime.create_engine
    does this itself for EngineConfig.adapter_slots > 0; this is for
    engines built directly (the tests)."""
    be = engine.backend
    be.params = install_adapter_leaves(engine.cfg, be.params, slots, rank)
    engine.adapters = AdapterPool(engine.cfg, be, slots, rank, registry=engine.metrics)
    return engine.adapters
