"""Block-paged KV cache for the continuous fleet: the main-path half of the
JAX package's engine/paged.py in PyTorch.

KV lives in a shared pool of fixed-size blocks, stacked on the layer axis
like the dense cache:

    pool k/v [L, n_blocks, KV, block_size, Dh]

and each slot's logical sequence is a block table row: logical block j of
the slot lives in physical block table[slot, j]. Admission allocates
ceil((prompt_len + max_tokens) / block_size) blocks from a host-side
refcounted free list; release decrefs them. Block 0 is the TRASH block:
table tails, launch padding and idle rows write there, and nothing ever
attends it.

Two programs carry every served token:

  * `mixed_step_ragged`: one scheduler step — every active slot's decode
    token plus budget-sliced prompt chunks on one flat token axis
    (engine/scheduler.py plans it, `build_ragged_meta` lays it out). Each
    token's K/V is scattered into its row's pool block and attention runs
    over the pool through ops/paged_attention.ragged_paged_attend. Decode
    tokens and positions come from the slot state on the device, and an
    admission whose last chunk rides the launch samples its first token
    and arms its slot on the device, so the host plans the next step
    without reading anything back.
  * `decode_slots_paged`: `num_steps` T=1 steps of the whole fleet when no
    prefill is pending; attention through
    ops/paged_attention.paged_flash_attend.

Where the JAX programs return an updated (donated) pool, these write the
pool IN PLACE and return the same tensors: the pool is the one buffer
worth not copying. Slot state is rebuilt functionally, so a packed result
already launched never sees a later step's writes.

Under cfg.kv_quant="int8" the pool leaves are ops/kv_quant.KVQuant: int8
blocks plus per-(token, head) fp32 scales [L, N, KV, bs]. Each token's
K/V is quantized on write (data and scale scattered into its block), and
the kernels dequantize in their prologues; the plain path gathers, then
dequantizes.

Whole-prefill admission (the fleet with `chunked_prefill` or
`ragged_prefill` False) lands a prompt before its slot decodes: ragged,
through `extend_ragged_paged` / `prefill_ragged_paged` (whole-width
launches of the prompt alone over a one-row table), or bucketed, on a
contiguous batch-1 scratch cache that `insert_slot_paged` scatters into
the slot's blocks.

The block-prefix cache and the KV shadow move whole blocks with plain
PyTorch indexing (no Pallas kernel in the JAX package either):
`gather_scratch_blocks` hands a bucketed admission's tail prefill the
shared head of a prefix hit, `gather_shadow_blocks` copies filled blocks
out for the host shadow store (engine/shadow.py) and
`restore_shadow_blocks` writes shadowed blocks back into the pool in
place.

Speculation rides the mixed launch: a speculating slot's entry is a
[current + K drafts] VERIFY row, a short prefill-kind row over its block
table whose first flat slot is substituted from the slot state like a
decode row (`SpecPlan`). `spec_verify` accepts the longest draft prefix
that matches the model's own argmax plus its correction token, on the
device, and the emissions grow the launch's packed fetch. Drafts come
from the host (n-gram lookup, in `tokens`) or from a draft model: its
pool shares the target's block tables, `mixed_fill_draft` lands each
mixed launch's tokens in it and `draft_propose_paged` runs its greedy
chain of K+1 decode steps, argmax on the device, nothing read back.

Runtime LoRA adapters (engine/adapters.py) ride every target launch as
a `pages` operand: one adapter-pool page per fleet row (0 = the base
page), each flat token of a ragged launch on its row's page
(`_token_pages`). The draft model's launches stay base-only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import api as M
from ..models.llama import kernel_window
from ..ops.kv_quant import KVQuant, init_quant_cache, quantize_chunk
from ..ops.paged_attention import (  # the RAGGED_* kinds: re-exported
    RAGGED_DECODE,
    RAGGED_PREFILL,  # noqa: F401
    paged_flash_attend,
    paged_flash_attend_plain,
    ragged_paged_attend,
    ragged_paged_attend_plain,
)
from ..ops.sampling import sample_token
from . import generate as G

TRASH_BLOCK = 0  # reserved pool block: write-only spill for table tails


def init_pool(cfg: ModelConfig, n_blocks: int, block_size: int,
              n_layers: Optional[int] = None, device=None) -> dict:
    """Zeroed block pool, stacked on the layer axis like the dense cache
    (KVQuant leaves, int8 blocks + fp32 scales [L, N, KV, bs], under
    cfg.kv_quant="int8"). Block 0 is the reserved trash block (never
    allocated to a slot)."""
    shape = (n_layers or cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size,
             cfg.head_dim)
    if cfg.kv_quant == "int8":  # the cache's layout, blocks for batch rows
        return init_quant_cache(*shape, device=device)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


class BlockAllocator:
    """Host-side REFCOUNTED free list over pool blocks 1..n_blocks-1 (0 is
    trash), in the JAX package's order: alloc() hands out the lowest free
    ids at refcount 1, incref() adds a holder, decref() drops one and a
    block returns to the END of the free list when its last holder lets
    go. Not thread-safe by itself: the continuous engine calls it only
    from its worker thread.

    registry (utils/metrics.MetricsRegistry, optional): pool-occupancy
    gauges, a shared-block gauge and an exhaustion counter for /metrics.
    """

    def __init__(self, n_blocks: int, registry=None):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is the trash block)")
        self.n_blocks = n_blocks
        self._free = list(range(1, n_blocks))
        self._ref: dict = {}  # block id -> holders (allocated blocks only)
        self._shared = 0  # blocks at refcount >= 2
        self._m_free = self._m_exhausted = self._m_shared = None
        if registry is not None:
            registry.gauge(
                "dli_kv_pool_blocks_total",
                "paged-KV pool size (excluding the trash block)",
            ).labels().set(n_blocks - 1)
            self._m_free = registry.gauge(
                "dli_kv_pool_blocks_free", "unallocated paged-KV blocks"
            ).labels()
            self._m_free.set(len(self._free))
            self._m_exhausted = registry.counter(
                "dli_kv_pool_exhausted_total",
                "admissions refused because the pool had too few blocks",
            ).labels()
            self._m_shared = registry.gauge(
                "dli_kv_pool_shared_blocks",
                "pool blocks held by more than one referencer",
            ).labels()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        """Blocks held by anyone: 0 once every holder released."""
        return len(self._ref)

    @property
    def shared_blocks(self) -> int:
        return self._shared

    def reset(self):
        """Forget every allocation and rebuild the full free list. The
        fleet supervisor's defensive path only: after a crash it releases
        every holder explicitly and calls this solely when the books
        still disagree, so a rebuilt pool never starts with phantom
        holders."""
        self._free = list(range(1, self.n_blocks))
        self._ref.clear()
        self._shared = 0
        if self._m_free is not None:
            self._m_free.set(len(self._free))
            self._m_shared.set(0)

    def span_attrs(self) -> dict:
        """Pool occupancy as flat flight-event attributes."""
        return {
            "pool_free": len(self._free),
            "pool_outstanding": len(self._ref),
            "pool_shared": self._shared,
        }

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> Optional[list]:
        """n blocks at refcount 1, or None (the caller keeps the request
        queued until a release)."""
        if n > len(self._free):
            if self._m_exhausted is not None:
                self._m_exhausted.inc()
            return None
        out = self._free[:n]
        del self._free[:n]
        for b in out:
            self._ref[b] = 1
        if self._m_free is not None:
            self._m_free.set(len(self._free))
        return out

    def incref(self, ids: list):
        for b in ids:
            c = self._ref[b]  # KeyError on a free block = caller bug
            self._ref[b] = c + 1
            if c == 1:
                self._shared += 1
        if self._m_shared is not None:
            self._m_shared.set(self._shared)

    def decref(self, ids: list):
        for b in ids:
            c = self._ref[b] - 1
            if c == 0:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = c
                if c == 1:
                    self._shared -= 1
        if self._m_free is not None:
            self._m_free.set(len(self._free))
            self._m_shared.set(self._shared)


def blocks_needed(prompt_len: int, max_tokens: int, block_size: int) -> int:
    """Physical blocks a request occupies: prompt positions plus decode
    writes (bound by prompt_len + max_tokens)."""
    return -(-(prompt_len + max_tokens) // block_size)


def _scatter_tokens(cache_k, cache_v, k, v, blk, off):
    """Write token w's K/V ([W, KV, Dh]) into pool[blk[w], :, off[w]] in
    place (colliding writes only ever target the trash block); an int8
    pool takes each token's quantized data and its per-head scales."""
    blk, off = blk.long(), off.long()
    for leaf, x in ((cache_k, k), (cache_v, v)):
        if isinstance(leaf, KVQuant):
            q, s = quantize_chunk(x)  # [W, KV, Dh], [W, KV]
            leaf.q[blk, :, off, :] = q
            leaf.s[blk, :, off] = s
        else:
            leaf[blk, :, off, :] = x


def make_paged_hook(table: torch.Tensor):
    """attn_hook for T=1 decode over the pool (the JAX make_paged_hook).

    table: [B, max_blocks] int32 physical ids. The hook sees one layer's
    pool slice [N, KV, bs, Dh] and per-row positions pos [B]; it writes
    each row's token K/V at pool[table[b, pos_b // bs], :, pos_b % bs]
    (the block index clamped to the row's last logical block, the JAX
    overrun guard), then attends through the decode kernel
    (attn_impl="kernel") or its plain twin."""

    def hook(cfg, q, k, v, cache_k, cache_v, pos, mask, update_gate,
             valid_start, window_flag=None):
        del mask, valid_start  # the kernel derives its mask from pos
        if q.shape[1] != 1:
            raise ValueError("the paged hook serves decode steps (T=1) only")
        bs = cache_k.shape[2]
        MB = table.shape[1]
        lblk = torch.clamp(pos // bs, max=MB - 1).long()
        blk = table.gather(1, lblk[:, None])[:, 0]
        _scatter_tokens(cache_k, cache_v, k[:, 0], v[:, 0], blk, pos % bs)
        w, wd = kernel_window(cfg, window_flag)
        attend = paged_flash_attend if cfg.attn_impl == "kernel" \
            else paged_flash_attend_plain
        attn = attend(q, cache_k, cache_v, table, pos, wd, window=w,
                      scale=cfg.query_scale, softcap=cfg.attn_softcap)
        return attn, cache_k, cache_v

    return hook


def _forward_step_paged(cfg, params, tokens, pool, table, pos, pages=None):
    """One decode step through the stack over the paged pool. pages:
    optional [B] int32 adapter-pool page per row (0 = base)."""
    bs = pool["k"].shape[3]
    MB = table.shape[1]
    x = M.embed(cfg, params, tokens, pos)
    x, pool = M.forward_layers(
        cfg, params["layers"], x, pool, pos,
        attn_hook=make_paged_hook(table), attn_seq_len=MB * bs,
        lora_pages=pages,
    )
    logits = M.unembed(cfg, params, x[:, -1:, :])
    return logits[:, 0, :], pool


@torch.no_grad()
def decode_slots_paged(cfg: ModelConfig, params, state: G.SlotState, pool,
                       table: torch.Tensor, generator, sparams: G.SlotParams,
                       *, num_steps: int, pages=None):
    """Advance every slot num_steps tokens over the block pool (the JAX
    scan becomes a Python loop). Inactive rows ride along, masked. pages:
    optional [B] int32 per-slot adapter pages (0 = base), a device operand
    like the table. Returns (emitted [num_steps, B] int32, emit_mask
    [num_steps, B] bool, state, pool)."""
    emitted, masks = [], []
    for _ in range(num_steps):
        logits, pool = _forward_step_paged(
            cfg, params, state.token[:, None], pool, table, state.pos, pages,
        )
        state, emit, can_emit = G.slot_step(cfg, state, sparams, logits,
                                            generator)
        emitted.append(emit)
        masks.append(can_emit)
    return torch.stack(emitted), torch.stack(masks), state, pool


# -- ragged launches: prefill straight into the pool ---------------------------


def build_ragged_meta(entries, *, width: int, tile: int):
    """HOST-side launch planner (the JAX build_ragged_meta, numpy only).

    entries: [(row, start, length, kind)] — each fleet row's contribution
    to this launch, in flat-token order; a decode row is (row, pos, 1,
    RAGGED_DECODE), a prefill chunk (row, chunk_start, chunk_len,
    RAGGED_PREFILL). Every entry starts on a query-tile boundary.

    Returns (meta [G, 4] int32, tok_row [W] int32, tok_pos [W] int32,
    offsets, stats): meta is the per-tile (row, q_start, q_len, kind)
    array the kernel reads; tok_row / tok_pos are each flat slot's row
    (-1 = launch padding, written to the trash block) and absolute
    position; offsets[i] is entry i's first flat slot; stats counts
    tiles / pad_tiles / rows by kind. Padding tiles copy their
    predecessor's (row, q_start) with q_len 0."""
    if width % tile != 0:
        raise ValueError(f"ragged width {width} must be a multiple of the "
                         f"query tile {tile}")
    G_ = width // tile
    meta = np.zeros((G_, 4), np.int32)
    tok_row = np.full((width,), -1, np.int32)
    tok_pos = np.zeros((width,), np.int32)
    offsets = []
    stats = {"tiles": G_, "pad_tiles": 0, "prefill_rows": 0, "decode_rows": 0}
    g = 0
    for row, start, length, kind in entries:
        if length < 1:
            raise ValueError("ragged launch entries need length >= 1")
        need = -(-length // tile)
        if g + need > G_:
            raise ValueError(
                f"launch overflow: {length} tokens need {need} tiles, "
                f"{G_ - g} left of {G_}"
            )
        offsets.append(g * tile)
        stats["decode_rows" if kind == RAGGED_DECODE else "prefill_rows"] += 1
        for t in range(need):
            q_len = min(tile, length - t * tile)
            q_start = start + t * tile
            meta[g] = (row, q_start, q_len, kind)
            w = g * tile
            tok_row[w: w + q_len] = row
            tok_pos[w: w + q_len] = q_start + np.arange(q_len)
            g += 1
    stats["pad_tiles"] = G_ - g
    while g < G_:
        if g > 0:
            meta[g] = meta[g - 1]
            meta[g, 2] = 0
        g += 1
    return meta, tok_row, tok_pos, offsets, stats


def make_ragged_fill_hook(table, meta, tok_row):
    """attn_hook for the ragged launches: the flat-token layout ([W, 1]
    chunks — each token a batch row at its own position), each token's
    K/V scattered into its row's pool block (launch padding, row -1, to
    the trash block), attention over the pool through the ragged kernel
    (attn_impl="kernel") or its plain twin.

    table [R, MB]: the fleet rows' block tables; meta [G, 4]: the launch
    plan (build_ragged_meta, possibly rewritten on the device by
    apply_device_meta); tok_row [W]: each flat slot's row."""

    def hook(cfg, q, k, v, cache_k, cache_v, pos, mask, update_gate,
             valid_start, window_flag=None):
        del mask, valid_start  # mask derived from meta in the kernel
        if q.shape[1] != 1:
            raise ValueError("the ragged hook runs the flat token layout (T=1 rows)")
        bs = cache_k.shape[2]
        MB = table.shape[1]
        rows_ix = tok_row.clamp(min=0).long()
        lblk = torch.clamp(pos // bs, max=MB - 1).long()
        blk = table[rows_ix, lblk]
        blk = torch.where(tok_row >= 0, blk, TRASH_BLOCK)
        _scatter_tokens(cache_k, cache_v, k[:, 0], v[:, 0], blk, pos % bs)
        w, wd = kernel_window(cfg, window_flag)
        attend = ragged_paged_attend if cfg.attn_impl == "kernel" \
            else ragged_paged_attend_plain
        attn = attend(q[:, 0], cache_k, cache_v, table, meta, wd, window=w,
                      scale=cfg.query_scale, softcap=cfg.attn_softcap)
        return attn[:, None], cache_k, cache_v

    return hook


def _token_pages(pages, tok_row):
    """Per-flat-token adapter pages from a per-row page vector: token w
    rides pages[tok_row[w]]; launch padding (row -1) rides the base page
    (0). None passes through: a launch without a pages operand is the
    program without adapters."""
    if pages is None:
        return None
    return torch.where(tok_row >= 0, pages[tok_row.clamp(min=0).long()], 0)


def _ragged_forward(cfg, params, tokens, tok_row, tok_pos, meta, pool, table,
                    pages=None):
    """One ragged launch of the flat tokens [W] through the stack; pages:
    optional [R] int32 adapter page per table row."""
    x = M.embed(cfg, params, tokens[:, None].long(), tok_pos)
    return M.forward_layers(
        cfg, params["layers"], x, pool, tok_pos,
        attn_hook=make_ragged_fill_hook(table, meta, tok_row), attn_seq_len=1,
        lora_pages=_token_pages(pages, tok_row),
    )


@torch.no_grad()
def extend_ragged_paged(cfg: ModelConfig, params, tokens, tok_row, tok_pos,
                        meta, pool, table, pages=None):
    """One full ragged launch with no sampling (the chunked extend() over
    the pool): tokens / tok_row / tok_pos [W], meta [G, 4] from
    build_ragged_meta, table [R, MB], pages: optional [R] int32 adapter
    page per table row. The pool is written in place and returned."""
    _, pool = _ragged_forward(cfg, params, tokens, tok_row, tok_pos, meta,
                              pool, table, pages)
    return pool


@torch.no_grad()
def prefill_ragged_paged(cfg: ModelConfig, params, tokens, tok_row, tok_pos,
                         meta, pool, table, sample_at: int, generator,
                         sampling, presence=None, bias=None, pages=None):
    """The final ragged launch of a whole-prefill admission: run the tail
    chunk, unembed flat position `sample_at` (its last valid token) and
    sample the first token (pages: as in extend_ragged_paged). Returns
    (first [1], logits [1, V], pool), the generate.prefill contract."""
    x, pool = _ragged_forward(cfg, params, tokens, tok_row, tok_pos, meta,
                              pool, table, pages)
    logits = M.unembed(cfg, params, x[sample_at:sample_at + 1])[:, 0, :]
    first = sample_token(generator, logits, *sampling, presence=presence,
                         bias=bias)
    return first, logits, pool


def scatter_scratch(pool, scratch, table_row):
    """Scatter a contiguous batch-1 scratch cache ([L, 1, KV, S, Dh], S a
    whole number of blocks; an int8 cache's scales [L, 1, KV, S]) into
    `table_row`'s pool blocks ([MB] int32 tensor), in place. Tail entries
    pointing at the trash block collide there, write-only garbage."""
    idx = table_row.long()

    def scatter(pl, sc):
        L, _, KV, S = sc.shape[:4]
        bs = pl.shape[3]
        blocks = sc[:, 0].reshape(L, KV, S // bs, bs, *sc.shape[4:])
        pl[:, idx] = blocks.transpose(1, 2)

    for name in ("k", "v"):
        pl, sc = pool[name], scratch[name]
        if isinstance(pl, KVQuant):
            scatter(pl.q, sc.q)
            scatter(pl.s, sc.s)
        else:
            scatter(pl, sc)
    return pool


def pool_leaves(tree) -> list:
    """A pool-structured tree's tensors in the JAX package's tree order
    ("k" then "v", each raw or KVQuant's q then s): the shadow store's
    leaf order."""
    out = []
    for name in ("k", "v"):
        leaf = tree[name]
        out.extend((leaf.q, leaf.s) if isinstance(leaf, KVQuant) else (leaf,))
    return out


def pool_from_leaves(like, leaves: list) -> dict:
    """The inverse of pool_leaves: leaves in that order, structured as
    the pool `like` (raw or KVQuant leaves)."""
    it = iter(leaves)
    return {name: (KVQuant(next(it), next(it)) if isinstance(like[name], KVQuant)
                   else next(it)) for name in ("k", "v")}


@torch.no_grad()
def gather_scratch_blocks(pool, table_row, out=None):
    """The contiguous batch-1 scratch cache ([L, 1, KV, MB*bs(, Dh)]) of
    `table_row`'s pool blocks ([MB] int32 tensor): the exact inverse of
    scatter_scratch (the JAX gather_scratch_blocks). A block-prefix hit
    of the bucketed admission uses it to hand the tail prefill the shared
    head; entries past the head gather stale bytes that the tail
    overwrites or the slot mask never reads. `out` (a scratch tree of
    that layout) is written in place and returned; else a new tree. The
    pool is only read."""
    idx = table_row.long()

    def gather(pl, dst):
        blocks = pl[:, idx]  # [L, MB, KV, bs(, Dh)]
        L, MB, KV, bs = blocks.shape[:4]
        flat = blocks.transpose(1, 2).reshape(L, KV, MB * bs, *blocks.shape[4:])
        if dst is None:
            return flat[:, None]
        dst[:, 0].copy_(flat)
        return dst

    res = {}
    for name in ("k", "v"):
        pl, dst = pool[name], None if out is None else out[name]
        if isinstance(pl, KVQuant):
            res[name] = KVQuant(gather(pl.q, None if dst is None else dst.q),
                                gather(pl.s, None if dst is None else dst.s))
        else:
            res[name] = gather(pl, dst)
    return res if out is None else out


@torch.no_grad()
def gather_shadow_blocks(pool, block_ids):
    """`block_ids`' pool blocks ([N] int tensor) copied out for the
    shadow store (engine/shadow.py): each leaf [N, L, KV, bs(, Dh)], one
    row per block with the whole layer axis (the JAX
    gather_shadow_blocks). Dispatched on the launch stream right after
    the launch that filled the blocks, so it reads their final bytes;
    the pool is only read."""
    idx = block_ids.long()

    def gather(pl):
        return pl[:, idx].transpose(0, 1).contiguous()

    return {name: (KVQuant(gather(pool[name].q), gather(pool[name].s))
                   if isinstance(pool[name], KVQuant) else gather(pool[name]))
            for name in ("k", "v")}


@torch.no_grad()
def restore_shadow_blocks(pool, blocks, block_ids):
    """Scatter shadowed blocks (a pool-structured tree of [N, L, KV,
    bs(, Dh)] leaves) into `block_ids` ([N] int tensor): the inverse of
    gather_shadow_blocks. The pool is written IN PLACE (index_copy_ on
    each leaf, an int8 pool's fp32 scales with its data), so every CUDA
    graph captured over it keeps reading the restored bytes. Pad rows
    aimed at the trash block collide there, write-only. Returns the
    pool."""
    idx = block_ids.long()
    for name in ("k", "v"):
        pl, bl = pool[name], blocks[name]
        pairs = ((pl.q, bl.q), (pl.s, bl.s)) if isinstance(pl, KVQuant) else ((pl, bl),)
        for dst, src in pairs:
            dst.index_copy_(1, idx, src.transpose(0, 1))
    return pool


@torch.no_grad()
def insert_slot_paged(cfg: ModelConfig, pool, scratch, state: G.SlotState,
                      sparams: G.SlotParams, slot: int, table_row, *arm):
    """Scatter a freshly prefilled contiguous scratch cache (batch 1,
    max_blocks * bs positions) into the slot's pool blocks (table_row [MB]
    int32; the whole row, stale high blocks are never attended) and arm
    its state (generate.arm_slot's arguments after `slot`). Returns
    (pool, state, sparams)."""
    pool = scatter_scratch(pool, scratch, table_row)
    state, sparams = G.arm_slot(cfg, state, sparams, int(slot), *arm)
    return pool, state, sparams


def arm_slot_only(cfg: ModelConfig, state: G.SlotState,
                  sparams: G.SlotParams, slot: int, *arm):
    """Arm a slot with no cache movement (its prompt K/V is already in
    the pool): the state half of the JAX insert_slot_paged."""
    return G.arm_slot(cfg, state, sparams, int(slot), *arm)


# -- the mixed launch ------------------------------------------------------------


class MixedArm(NamedTuple):
    """Per-slot arming operands for prefills COMPLETING in a mixed launch
    (all [B]-shaped; rows with on=False are untouched)."""

    on: torch.Tensor  # bool [B]: slot completes its prefill this launch
    idx: torch.Tensor  # int [B]: flat index of its last prompt token
    prompt_len: torch.Tensor  # i32 [B]
    max_tokens: torch.Tensor  # i32 [B]
    params: G.SlotParams  # [B]-shaped sampling knobs
    presence: torch.Tensor  # bool [B, V]: prompt token sets


def idle_mixed_arm(n_slots: int, vocab_size: int, device=None) -> MixedArm:
    """An all-off MixedArm (no admission completes this launch), every
    field its own tensor, so that it can serve as a static buffer."""
    z = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    _, sp = G.init_slots(n_slots, 1, device=device)
    return MixedArm(
        torch.zeros((n_slots,), dtype=torch.bool, device=device), z, z.clone(),
        z.clone(), sp,
        torch.zeros((n_slots, vocab_size), dtype=torch.bool, device=device),
    )


class SpecPlan(NamedTuple):
    """Per-slot speculation operands of one mixed launch. A speculating
    slot's entry is a [current + K-draft] VERIFY row: a short prefill-kind
    row over its block table whose first flat slot is substituted from the
    slot state (token and position) like a decode row. The shapes follow
    the fleet's largest draft length, so one launch kind serves every
    accept pattern and every per-slot draft length."""

    dec_on: torch.Tensor  # bool [B]: slot has a PLAIN decode row this
    # launch; slot_step advances exactly these rows, verify rows advance
    # through spec_verify, and (host-planned mode) a slot frozen behind an
    # unfetched verify row not at all
    on: torch.Tensor  # bool [B]: slot carries a verify row this launch
    idx: torch.Tensor  # i32 [B, K+1]: flat indices of the row's [current,
    # drafts...] slots (past the slot's own draft length the last valid
    # index repeats: duplicate gathers, never read)
    n_draft: torch.Tensor  # i32 [B]: drafted tokens in the row (<= K)


def idle_spec_plan(n_slots: int, draft_len: int, device=None) -> SpecPlan:
    """An all-off SpecPlan with every slot a plain decode row, every field
    its own tensor (a static buffer)."""
    return SpecPlan(
        torch.ones((n_slots,), dtype=torch.bool, device=device),
        torch.zeros((n_slots,), dtype=torch.bool, device=device),
        torch.zeros((n_slots, draft_len + 1), dtype=torch.int32, device=device),
        torch.zeros((n_slots,), dtype=torch.int32, device=device),
    )


class DeviceMeta(NamedTuple):
    """Device-derivation masks for one mixed launch: which tiles / flat
    slots read their POSITIONS from the device-resident slot state
    (state.pos[row] + offset) instead of the host plan. The host keeps the
    structural half (rows, widths); the positional half of decode rows is
    substituted on the card (apply_device_meta), so planning launch N+1
    never waits for launch N's fetch."""

    tile_on: torch.Tensor  # bool [G]
    tile_off: torch.Tensor  # i32 [G]
    tok_on: torch.Tensor  # bool [W]
    tok_off: torch.Tensor  # i32 [W]


def idle_device_meta(width: int, tile: int, device=None) -> DeviceMeta:
    """An all-off DeviceMeta (every position host-planned)."""
    G_ = width // tile
    return DeviceMeta(
        torch.zeros((G_,), dtype=torch.bool, device=device),
        torch.zeros((G_,), dtype=torch.int32, device=device),
        torch.zeros((width,), dtype=torch.bool, device=device),
        torch.zeros((width,), dtype=torch.int32, device=device),
    )


def build_device_meta(entries, offsets, n_dev: int, *, width: int, tile: int):
    """HOST-side companion to build_ragged_meta: mark the first `n_dev`
    entries' tiles and flat slots for on-device position substitution.
    Padding tiles inherit their predecessor's flags, as build_ragged_meta
    copies its (row, q_start). Returns numpy (tile_on [G] bool, tile_off
    [G] i32, tok_on [W] bool, tok_off [W] i32)."""
    G_ = width // tile
    tile_on = np.zeros((G_,), bool)
    tile_off = np.zeros((G_,), np.int32)
    tok_on = np.zeros((width,), bool)
    tok_off = np.zeros((width,), np.int32)
    g = 0
    for i, ((row, start, length, kind), off) in enumerate(zip(entries, offsets)):
        need = -(-length // tile)
        if i < n_dev:
            for t in range(need):
                tile_on[g + t] = True
                tile_off[g + t] = t * tile
            tok_on[off: off + length] = True
            tok_off[off: off + length] = np.arange(length, dtype=np.int32)
        g += need
    while g < G_:
        if g > 0:
            tile_on[g] = tile_on[g - 1]
            tile_off[g] = tile_off[g - 1]
        g += 1
    return tile_on, tile_off, tok_on, tok_off


def apply_device_meta(meta, tok_row, tok_pos, dev: DeviceMeta, pos):
    """Substitute `pos[row] + offset` into the marked tiles' q_start
    column and the marked flat slots' positions, on the device. Unmarked
    tiles / slots keep the host plan. Returns new (meta, tok_pos)."""
    rows = meta[:, 0].clamp(min=0).long()
    q_dev = pos[rows].to(torch.int32) + dev.tile_off
    meta = meta.clone()
    meta[:, 1] = torch.where(dev.tile_on, q_dev, meta[:, 1])
    rix = tok_row.clamp(min=0).long()
    p_dev = pos[rix].to(torch.int32) + dev.tok_off
    return meta, torch.where(dev.tok_on, p_dev, tok_pos)


def spec_verify(cfg: ModelConfig, state: G.SlotState, window, draft, n_draft,
                live):
    """Accept / reject for the mixed launch's verify rows, on the device.

    window [B, K+1] i32: the greedy argmax at the verify row's positions
    (position j's argmax is the model's next token after [current,
    draft[:j]]); draft [B, K] i32; n_draft [B]: drafts planned per row;
    live [B]: rows carrying a verify row AND active on the device.

    Emits the longest draft prefix matching the model's own argmax plus
    the correction token, with generate.slot_step's greedy bookkeeping
    token for token, so the state after a verify equals decoding the same
    tokens one by one: break-before-append EOS (the EOS step still
    advances pos by one), the remaining-budget clamp (a spent budget
    deactivates without the EOS step's position), the pad token on
    deactivation, presence over every token plain decode would have
    sampled and counts over the emitted ones. A rejected draft position's
    K/V is rewritten before anything attends it.

    Returns (state, spec_emit [B, K+1] i32, spec_mask [B, K+1] bool, adv
    [B] i32: each row's position advance)."""
    i32 = torch.int32
    pad = cfg.pad_token_id
    K1 = window.shape[1]
    j = torch.arange(K1, dtype=i32, device=window.device)[None, :]
    jk = j[:, :K1 - 1]
    match = (draft == window[:, :K1 - 1]) & (jk < n_draft[:, None])
    n_acc = torch.cumprod(match.to(i32), dim=1).sum(dim=1).to(i32)
    valid = j <= n_acc[:, None]  # accepted drafts + the correction token
    cum_eos = torch.cumsum(G.stop_mask(cfg, window).to(i32), dim=1) > 0
    emit_pre = valid & ~cum_eos  # break BEFORE appending a stop token
    n_pre = emit_pre.sum(dim=1).to(i32)
    room = state.remaining
    n_emit = torch.where(live, torch.minimum(n_pre, room), 0).to(i32)
    # the EOS step happens only where plain decode would reach it: a
    # budget spent first means no EOS step (and no extra position)
    saw_eos = live & (valid & cum_eos).any(dim=1) & (n_pre < room)
    emit_ok = emit_pre & (j < n_emit[:, None]) & live[:, None]
    spec_emit = torch.where(emit_ok, window, pad).to(i32)
    adv = (n_emit + saw_eos.to(i32)).to(i32)
    last = window.gather(1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
    new_token = torch.where(saw_eos | (n_emit <= 0), pad, last).to(i32)
    new_rem = (state.remaining - n_emit).to(i32)
    new_active = live & ~saw_eos & (new_rem > 0)
    mark = emit_ok | (saw_eos[:, None] & (j == n_emit[:, None]))
    vocab = torch.arange(state.presence.shape[-1], dtype=i32, device=window.device)
    onehot = window[:, :, None] == vocab[None, None, :]  # [B, K+1, V]
    pres_add = (onehot & mark[:, :, None]).any(dim=1)
    cnt_add = (onehot & emit_ok[:, :, None]).sum(dim=1).to(i32)
    state = G.SlotState(
        token=torch.where(live, new_token, state.token),
        pos=state.pos + torch.where(live, adv, 0).to(i32),
        active=torch.where(live, new_active, state.active),
        remaining=torch.where(live, new_rem, state.remaining),
        presence=state.presence | pres_add,
        counts=state.counts + cnt_add,
    )
    return state, spec_emit, emit_ok, adv


@torch.no_grad()
def mixed_step_ragged(cfg: ModelConfig, params, tokens, tok_row, tok_pos,
                      dec_flag, meta, pool, table, state: G.SlotState,
                      sparams: G.SlotParams, generator, dec_idx, arm: MixedArm,
                      spec=None, spec_toks=None, dev: Optional[DeviceMeta] = None,
                      pages=None):
    """One scheduler step: advance every active slot one decode token AND
    write the launch's prefill chunks into the pool, in one launch.

    tokens / tok_pos [W]: the host-planned flat launch (prefill chunk
    contents; decode slots hold placeholders). dec_flag [W]: True where
    the flat slot is a decode row's token — its token and position are
    REPLACED by the owning slot's device state. meta [G, 4] / tok_row [W]:
    the build_ragged_meta plan; with `dev` the decode tiles' q_start and
    positions are derived on the device (apply_device_meta). dec_idx [B]:
    each slot's decode token's flat index (0 for slots without one: their
    sampled garbage is gated by state.active). arm: completing-prefill
    operands (MixedArm). Every operand is a device tensor; nothing is read
    back to the host.

    spec (SpecPlan, optional): verify rows for speculating slots, each a
    [current + drafts] prefill-kind row whose first flat slot is
    substituted like a decode row; accept / reject runs on the device
    (spec_verify) and the emissions extend the packed fetch. spec_toks
    ([B, K] i32, optional): a draft model's proposals, scattered into each
    verify row's draft slots (n-gram drafts arrive in `tokens` instead).
    pages ([B] i32, optional): per-slot adapter-pool pages (engine/
    adapters.py, 0 = base); every flat token rides its row's page, verify
    rows included.

    Returns (packed int32 — [5, B] plain, [5 + 2(K+1) + 1, B] with spec:
    emitted / emit_mask / active / firsts / armed [/ spec_emit / spec_mask
    / position advance], ONE fetch per step — state, sparams, pool)."""
    if dev is not None:
        meta, tok_pos = apply_device_meta(meta, tok_row, tok_pos, dev, state.pos)
    rows_ix = tok_row.clamp(min=0).long()
    toks = torch.where(dec_flag, state.token[rows_ix], tokens)
    if spec is not None and spec_toks is not None:
        # each verify row's drafts into its flat slots; rows without one,
        # and draft slots past a row's own length, aim at a spill slot
        # past the launch that is cut off again
        W, K = toks.shape[0], spec_toks.shape[1]
        jk = torch.arange(K, device=toks.device)[None, :]
        want = spec.on[:, None] & (jk < spec.n_draft[:, None])
        tgt = torch.where(want, spec.idx[:, 1:], W).reshape(-1).long()
        ext = torch.cat([toks, toks.new_zeros(1)])
        ext[tgt] = spec_toks.reshape(-1).to(ext.dtype)
        toks = ext[:W]
    pos = torch.where(dec_flag, state.pos[rows_ix], tok_pos)
    x, pool = _ragged_forward(cfg, params, toks, tok_row, pos, meta, pool, table,
                              pages)
    logits = M.unembed(cfg, params, x[dec_idx.long()])[:, 0, :]  # [B, V]
    pf_logits = M.unembed(cfg, params, x[arm.idx.long()])[:, 0, :]
    sp_logits = sp_draft = None
    if spec is not None:
        B, K1 = spec.idx.shape
        flat = spec.idx.reshape(-1).long()
        sp_logits = M.unembed(cfg, params, x[flat])[:, 0, :].reshape(B, K1, -1)
        sp_draft = toks[spec.idx[:, 1:].long()]  # [B, K] the verified drafts
    packed, state, sparams = mixed_epilogue(
        cfg, state, sparams, logits, pf_logits, generator, arm,
        spec=spec, sp_logits=sp_logits, sp_draft=sp_draft,
    )
    return packed, state, sparams, pool


@torch.no_grad()
def mixed_fill_draft(dcfg: ModelConfig, dparams, tokens, tok_row, tok_pos,
                     dec_flag, meta, dpool, table, token, pos_state,
                     dev: Optional[DeviceMeta] = None):
    """The draft pool's twin of the mixed launch's forward (no sampling):
    land the launch's prompt chunks and every decode row's current token
    in the DRAFT model's pool (`dpool`, written in place), with the same
    substitution from the slot state (`token`, `pos_state` [B]) and the
    same DeviceMeta, so the draft chain's context tracks the stream
    position by position. A verify row's draft slots carry placeholders
    here; the propose chain rewrites exactly those positions before
    anything attends them. Returns dpool."""
    if dev is not None:
        meta, tok_pos = apply_device_meta(meta, tok_row, tok_pos, dev, pos_state)
    rows_ix = tok_row.clamp(min=0).long()
    toks = torch.where(dec_flag, token[rows_ix], tokens)
    pos = torch.where(dec_flag, pos_state[rows_ix], tok_pos)
    _, dpool = _ragged_forward(dcfg, dparams, toks, tok_row, pos, meta, dpool,
                               table)
    return dpool


@torch.no_grad()
def draft_propose_paged(dcfg: ModelConfig, dparams, token, pos, dpool, table,
                        *, draft_len: int):
    """The draft model's greedy chain over the fleet: `draft_len` + 1 T=1
    steps from every slot's current (token [B], pos [B]) over the draft
    pool (written in place) through the SAME block tables, each step's
    argmax taken on the device (the JAX lax.scan as a loop; nothing is
    read back). The last step writes the last proposal's K/V, so a full
    accept leaves no hole; its own proposal is dropped. Rows not
    speculating ride along: they write their current token's K/V and
    proposals past their frontier that later writes overwrite (in the
    draft pool a stale entry could only cost draft quality).

    Returns (proposals [B, draft_len] i32, dpool)."""
    tok, p, props = token, pos, []
    for _ in range(draft_len + 1):
        logits, dpool = _forward_step_paged(dcfg, dparams, tok[:, None], dpool,
                                            table, p)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        p = p + 1
        props.append(tok)
    return torch.stack(props[:draft_len], dim=1), dpool


def mixed_epilogue(cfg: ModelConfig, state: G.SlotState,
                   sparams: G.SlotParams, logits, pf_logits, generator,
                   arm: MixedArm, spec: Optional[SpecPlan] = None,
                   sp_logits=None, sp_draft=None):
    """Sampling / arming tail of the mixed step: slot_step advances the
    decoding rows; completing prefills sample their first token with their
    own knobs and arm their slot (the vectorized arm_slot: budget,
    EOS-on-first, presence and counts decided on the device). With a
    SpecPlan, slot_step's advance is kept only on the rows that carried a
    plain decode row (spec.dec_on), verify rows advance through
    spec_verify, and the packed fetch grows the verify block. Returns
    (packed int32, state, sparams)."""
    prev = state
    state, emit, can_emit = G.slot_step(cfg, state, sparams, logits, generator)
    if spec is not None:
        # rows without a plain decode row (verify rows, and rows frozen
        # behind an unfetched verify row) go back to the pre-step state
        # before the verify: slot_step ran on garbage logits there
        dec_on = spec.dec_on
        state = G.SlotState(*(
            torch.where(dec_on[:, None] if n.dim() > 1 else dec_on, n, o)
            for n, o in zip(state, prev)
        ))
        emit = torch.where(dec_on, emit, cfg.pad_token_id).to(torch.int32)
        can_emit = can_emit & dec_on
        # the greedy argmax over the verify positions, as slot_step's
        # greedy bypass takes it (speculation requires the penalties off)
        window = torch.argmax(sp_logits.float(), dim=-1).to(torch.int32)
        live = spec.on & prev.active
        state, spec_emit, spec_mask, spec_adv = spec_verify(
            cfg, state, window, sp_draft, spec.n_draft, live)
    ap = arm.params
    firsts = sample_token(
        generator, pf_logits, ap.temperature[:, None], ap.top_k[:, None],
        ap.top_p[:, None], ap.greedy | ~arm.on, ap.min_p[:, None],
        ap.rep_penalty[:, None], ap.freq_penalty[:, None],
        ap.pres_penalty[:, None], presence=arm.presence,
    ).to(torch.int32)
    budget = torch.where(
        G.stop_mask(cfg, firsts), 0, torch.clamp(arm.max_tokens - 1, min=0)
    ).to(torch.int32)
    vocab = torch.arange(cfg.vocab_size, device=firsts.device)
    first_onehot = vocab[None, :] == firsts[:, None]  # [B, V]
    on, on_col = arm.on, arm.on[:, None]
    state = G.SlotState(
        token=torch.where(on, firsts, state.token),
        pos=torch.where(on, arm.prompt_len, state.pos),
        active=torch.where(on, budget > 0, state.active),
        remaining=torch.where(on, budget, state.remaining),
        presence=torch.where(on_col, arm.presence | first_onehot,
                             state.presence),
        counts=torch.where(on_col, first_onehot.to(torch.int32), state.counts),
    )
    sparams = G.SlotParams(*(
        torch.where(on, new, old) for new, old in zip(arm.params, sparams)
    ))
    packed = torch.stack([
        emit, can_emit.to(torch.int32), state.active.to(torch.int32), firsts,
        on.to(torch.int32),
    ])
    if spec is not None:
        # the verify results ride the SAME fetch: emissions, their mask
        # and each row's position advance
        packed = torch.cat([packed, spec_emit.T, spec_mask.to(torch.int32).T,
                            spec_adv[None]])
    return packed, state, sparams
