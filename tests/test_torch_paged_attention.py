"""PyTorch port vs JAX package: attention over the block-paged KV pool.

The port's plain twins of `ragged_paged_attend` and `paged_flash_attend`
(what the wrappers run on CPU tensors) against the Pallas kernels in
interpret mode, on the same numpy inputs: shuffled block tables, decode
rows, multi-tile and short prefill chunks, launch padding, static and
per-layer windows, softcap and scale. fp32, atol 1e-5 (the two sum in
another order). The host-side launch planners (`build_ragged_meta`,
`build_device_meta`) and the device substitution (`apply_device_meta`)
must equal the JAX package's exactly.

The CUDA decode kernel shares each row's live key range among
`_paged_splits` blocks, walks each share in 64-key tiles on the 64-key
grid through the block table, one 16-key slice per warp, with a base-2
online softmax, and merges the warps, then the splits, in a fixed order:
that arithmetic, emulated here in fp32 torch (`_paged_walk`), matches the
Pallas kernel in interpret mode within atol 2e-6 (raw; the int8 pool in
test_torch_kv_quant.py at 1e-5), with 1, 2, 3 and 9 splits, positions on
block, tile and split edges and past the table, every window, softcap and
scale variant; and the twin's, with table ids outside the pool that
read block 0, the trash block."""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.ops import paged_attention as JA  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as PA  # noqa: E402

ATOL = 1e-5
H, KV, DH, BS, MB, N = 8, 2, 16, 4, 8, 48
TQ = 4

# (kwargs, per-layer window operand): full causal, a static window, a
# per-layer width, a per-layer "no window" (<= 0), softcap, scale
VARIANTS = [({}, None), ({"window": 5}, None), ({}, 3), ({}, -1),
            ({"softcap": 3.0}, None), ({"scale": 0.2}, None)]
VARIANT_IDS = ["causal", "window", "window_dyn", "window_dyn_off", "softcap",
               "scale"]

# per-tile (row, q_start, q_len, kind): two decode rows (one at 0, one deep
# in its table), a 10-token chunk at 13 over three tiles (the last short),
# a 3-token prefill row, then two pad tiles that repeat their predecessor
META = np.array([
    (0, 0, 1, PA.RAGGED_DECODE), (1, 29, 1, PA.RAGGED_DECODE),
    (2, 13, 4, PA.RAGGED_PREFILL), (2, 17, 4, PA.RAGGED_PREFILL),
    (2, 21, 2, PA.RAGGED_PREFILL), (3, 0, 3, PA.RAGGED_PREFILL),
    (3, 0, 0, PA.RAGGED_PREFILL), (3, 0, 0, PA.RAGGED_PREFILL),
], np.int32)


def _pool(seed, rows):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((N, KV, BS, DH)).astype(np.float32)
    pv = rng.standard_normal((N, KV, BS, DH)).astype(np.float32)
    # shuffled physical blocks 1..N-1 (0 is the trash block)
    table = (rng.permutation(N - 1)[: rows * MB] + 1).reshape(rows, MB)
    return rng, pk, pv, table.astype(np.int32)


def _window(wd):
    if wd is None:
        return None, None
    return jnp.array([wd], jnp.int32), torch.tensor([wd], dtype=torch.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_ragged_twin_matches_pallas_kernel(kw, wd):
    rng, pk, pv, table = _pool(0, 4)
    q = rng.standard_normal((META.shape[0] * TQ, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(JA.ragged_paged_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(META), wdj, interpret=True, **kw))
    got = PA.ragged_paged_attend(*_t(q, pk, pv, table, META), wdt, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # launch padding and the rows past a tile's q_len are zeros, as the
    # Pallas kernel writes them
    out = got.numpy().reshape(META.shape[0], TQ, H, DH)
    for g, (_, _, q_len, _) in enumerate(META):
        assert not out[g, q_len:].any()


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_paged_decode_twin_matches_pallas_kernel(kw, wd):
    rng, pk, pv, table = _pool(1, 5)
    # positions at a block's first and last slot, mid-table and at the end
    pos = np.array([0, 3, 4, 17, MB * BS - 1], np.int32)
    q = rng.standard_normal((5, 1, H, DH)).astype(np.float32)
    wdj, wdt = _window(wd)
    want = np.asarray(JA.paged_flash_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(pos), wdj, interpret=True, **kw))
    got = PA.paged_flash_attend(*_t(q, pk, pv, table, pos), wdt, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_wrappers_on_cpu_run_the_twins_and_count_no_launch():
    rng, pk, pv, table = _pool(2, 4)
    q = rng.standard_normal((META.shape[0] * TQ, H, DH)).astype(np.float32)
    r0, p0 = PA.ragged_paged_attend.launches, PA.paged_flash_attend.launches
    a = PA.ragged_paged_attend(*_t(q, pk, pv, table, META))
    b = PA.ragged_paged_attend_plain(*_t(q, pk, pv, table, META))
    assert torch.equal(a, b)
    pos = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    qd = torch.from_numpy(q[:4, None])
    assert torch.equal(
        PA.paged_flash_attend(qd, *_t(pk, pv, table), pos),
        PA.paged_flash_attend_plain(qd, *_t(pk, pv, table), pos))
    assert (PA.ragged_paged_attend.launches, PA.paged_flash_attend.launches) == (r0, p0)


@pytest.mark.parametrize("fn", ["ragged_paged_attend", "paged_flash_attend"])
def test_int8_pool_raises_not_implemented(fn):
    """An int8 pool is ops/kv_quant.KVQuant leaves (data and scales; held
    to the JAX kernels in test_torch_kv_quant.py): a bare int8 tensor,
    which has no scales, is refused by the wrapper and its twin."""
    pool = torch.zeros((N, KV, BS, DH), dtype=torch.int8)
    table = torch.ones((4, MB), dtype=torch.int32)
    if fn == "ragged_paged_attend":
        args = (torch.zeros((META.shape[0] * TQ, H, DH)), pool, pool, table,
                torch.from_numpy(META))
    else:
        args = (torch.zeros((4, 1, H, DH)), pool, pool, table,
                torch.zeros((4,), dtype=torch.int32))
    for f in (getattr(PA, fn), getattr(PA, fn + "_plain")):
        with pytest.raises(TypeError, match="KVQuant"):
            f(*args)


# launch entries (row, start, length, kind), every one on a tile boundary
ENTRY_CASES = {
    "decode_and_chunks": [(0, 7, 1, P.RAGGED_DECODE), (2, 30, 1, P.RAGGED_DECODE),
                          (1, 0, 19, P.RAGGED_PREFILL), (3, 8, 5, P.RAGGED_PREFILL)],
    "one_full_chunk": [(4, 64, 32, P.RAGGED_PREFILL)],
    "decode_only": [(b, 3 * b, 1, P.RAGGED_DECODE) for b in range(5)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_launch_planners_equal_jax(name):
    entries = ENTRY_CASES[name]
    W, tile = 64, 8
    got = P.build_ragged_meta(entries, width=W, tile=tile)
    want = JP.build_ragged_meta(entries, width=W, tile=tile)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == list(want[3]) and got[4] == want[4]
    offsets = got[3]
    for n_dev in range(len(entries) + 1):
        d_got = P.build_device_meta(entries, offsets, n_dev, width=W, tile=tile)
        d_want = JP.build_device_meta(entries, offsets, n_dev, width=W, tile=tile)
        for g, w in zip(d_got, d_want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype


def test_launch_planner_rejects_what_jax_rejects():
    for entries, kw in (([(0, 0, 9, P.RAGGED_PREFILL)], dict(width=8, tile=8)),
                        ([(0, 0, 0, P.RAGGED_PREFILL)], dict(width=8, tile=8)),
                        ([], dict(width=12, tile=8))):
        with pytest.raises(ValueError):
            JP.build_ragged_meta(entries, **kw)
        with pytest.raises(ValueError):
            P.build_ragged_meta(entries, **kw)


def test_apply_device_meta_equals_jax():
    entries = ENTRY_CASES["decode_and_chunks"]
    W, tile = 64, 8
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(
        entries, width=W, tile=tile)
    dev = P.build_device_meta(entries, offsets, 2, width=W, tile=tile)
    pos = np.array([11, 5, 40, 9, 0], np.int32)  # the slots' device positions
    m_j, p_j = JP.apply_device_meta(
        jnp.asarray(meta), jnp.asarray(tok_row), jnp.asarray(tok_pos),
        JP.DeviceMeta(*(jnp.asarray(a) for a in dev)), jnp.asarray(pos))
    m_t, p_t = P.apply_device_meta(
        *_t(meta, tok_row, tok_pos), P.DeviceMeta(*_t(*dev)), torch.from_numpy(pos))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    # the decode tiles now start at their slots' device positions
    assert m_t[0, 1].item() == 11 and m_t[1, 1].item() == 40
    # the host plan it started from is untouched
    assert meta[0, 1] == 7


# -- the CUDA decode kernel's split-KV walk, emulated -----------------------------

WALK_ATOL = 2e-6
WARP_KEYS = 16  # one warp's keys of a tile: the mma's M
# two pool geometries: 16-key blocks (a warp's slice is one block) and
# 12-key blocks that straddle the 64-key tiles' edges
WALK_GEOMETRIES = [(16, 20), (12, 27)]
WALK_SPLITS = [1, 2, 3, 9]
# static and per-layer windows whose starts cross tile edges, softcap, a
# scale that is no power of two
WALK_VARIANTS = [({}, None), ({"window": 5}, None), ({}, 70), ({}, -1),
                 ({"softcap": 3.0}, None), ({"scale": 0.2}, None)]
WALK_IDS = ["causal", "window", "window_dyn", "window_dyn_off", "softcap", "scale"]


def walk_positions(bs, MB):
    """Positions on block, 64-key tile and split edges, 0, the last key and
    past the table (a row at pos >= MB * bs attends all of it)."""
    S = MB * bs
    return [0, bs - 1, bs, 63, 64, 65, 127, 128, 191, 255, 256, S - 1, S, 2 * S + 7]


def walk_pool(seed, bs, MB, rows):
    """A pool and a table of shuffled physical blocks 1..N-1 (block 0 is
    the trash block)."""
    rng = np.random.default_rng(seed)
    n = rows * MB + 1
    pk = rng.standard_normal((n, KV, bs, DH)).astype(np.float32)
    pv = rng.standard_normal((n, KV, bs, DH)).astype(np.float32)
    table = (rng.permutation(n - 1)[: rows * MB] + 1).reshape(rows, MB).astype(np.int32)
    return rng, pk, pv, table


def _paged_walk(q, pool_k, pool_v, table, pos, window_dyn=None, *, window=None,
                scale=None, softcap=None, n_split=1, tile=PA.SLOTS_TILE, round_to=None):
    """The paged decode kernel's arithmetic in torch, fp32. Row b's live
    keys [lo, hi) (hi = min(pos + 1, MB * bs), lo = pos - win + 1 with a
    window, else 0) lie in `tile`-key tiles on the tile grid from key 0;
    split s takes tiles [s * n // n_split, (s + 1) * n // n_split). Key p
    is slot p % bs of block table[b, p // bs] (an id outside [0, N) reads
    block 0); an int8 row is q8 * s in fp32, rounded to `round_to` as the
    kernel rounds it for a bf16 / fp16 product. Each warp's 16-key slice of
    each tile folds into that warp's (m, l, acc) by a base-2 online
    softmax, the scores scaled after the product and soft-capped; the
    warps merge in order into the split's partial, the splits in order
    with the log-sum-exp rescale; a row with no live key gives zeros."""
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    B, _, H_, Dh = q.shape
    int8 = isinstance(pool_k, KVQuant)
    N, KV_, bs, _ = (pool_k.q if int8 else pool_k).shape
    MB_ = table.shape[1]
    S = MB_ * bs
    group = H_ // KV_
    scale = Dh ** -0.5 if scale is None else scale
    win = int(window_dyn.reshape(())) if window_dyn is not None else (
        window if window is not None else -1)
    log2e = 1.4426950408889634
    neg = torch.tensor(-0.7 * torch.finfo(torch.float32).max)

    def key_rows(leaf, ids, kvh, slots):
        if int8:
            x = leaf.q[ids, kvh, slots].float() * leaf.s[ids, kvh, slots][:, None]
            return x.to(round_to).float() if round_to is not None else x
        return leaf[ids, kvh, slots].float()

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, acc = torch.zeros(group), torch.zeros(group, Dh)
        for m, part_l, part_acc in parts:
            e = torch.exp2(m - mx)
            lsum = lsum + part_l * e
            acc = acc + part_acc * e[:, None]
        return mx, lsum, acc

    out = torch.zeros(B, 1, H_, Dh)
    for b in range(B):
        p = int(pos[b])
        hi = S if p >= S else p + 1
        lo = max(p - win + 1, 0) if win > 0 else 0
        base = lo - lo % tile
        n_tiles = (hi - 1 - base) // tile + 1 if hi > lo else 0
        for kvh in range(KV_):
            heads = slice(kvh * group, (kvh + 1) * group)
            qh = q[b, 0, heads].float()
            parts = []
            for s in range(n_split):
                warps = [(neg.expand(group).clone(), torch.zeros(group),
                          torch.zeros(group, Dh)) for _ in range(tile // WARP_KEYS)]
                for t in range(s * n_tiles // n_split, (s + 1) * n_tiles // n_split):
                    p0 = base + t * tile
                    for w in range(tile // WARP_KEYS):
                        k0 = max(p0 + w * WARP_KEYS, lo)
                        k1 = min(p0 + (w + 1) * WARP_KEYS, hi)
                        if k1 <= k0:
                            continue  # no live key in this warp's slice
                        keys = torch.arange(k0, k1)
                        ids = table[b, keys // bs].long()
                        ids = torch.where((ids >= 0) & (ids < N), ids, 0)
                        kr = key_rows(pool_k, ids, kvh, keys % bs)
                        vr = key_rows(pool_v, ids, kvh, keys % bs)
                        sc = (qh @ kr.T) * scale
                        if softcap is not None:
                            sc = softcap * torch.tanh(sc / softcap)
                        sc = sc * log2e
                        m, lsum, acc = warps[w]
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        pr = torch.exp2(sc - m_new[:, None])
                        warps[w] = (m_new, lsum * alpha + pr.sum(-1),
                                    acc * alpha[:, None] + pr @ vr)
                parts.append(merge(warps))
            _, lsum, acc = merge(parts)
            live = lsum > 0
            out[b, 0, heads] = torch.where(
                live[:, None], acc / torch.where(live, lsum, 1.0)[:, None], 0.0)
    return out


@functools.lru_cache(maxsize=None)
def _jax_decode(bs, MB, variant):
    """The Pallas kernel in interpret mode on walk_pool's inputs (cached:
    every split count is held to the same result)."""
    kw, wd = WALK_VARIANTS[variant]
    positions = walk_positions(bs, MB)
    rng, pk, pv, table = walk_pool(30 + bs, bs, MB, len(positions))
    q = rng.standard_normal((len(positions), 1, H, DH)).astype(np.float32)
    pos = np.array(positions, np.int32)
    wdj, _ = _window(wd)
    want = np.asarray(JA.paged_flash_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(pos), wdj, interpret=True, **kw))
    return (q, pk, pv, table, pos), want


@pytest.mark.parametrize("n_split", WALK_SPLITS)
@pytest.mark.parametrize("variant", range(len(WALK_VARIANTS)), ids=WALK_IDS)
@pytest.mark.parametrize("bs,mb", WALK_GEOMETRIES, ids=["bs16", "bs12"])
def test_paged_walk_matches_pallas_kernel(bs, mb, variant, n_split):
    (q, pk, pv, table, pos), want = _jax_decode(bs, mb, variant)
    kw, wd = WALK_VARIANTS[variant]
    _, wdt = _window(wd)
    got = _paged_walk(*_t(q, pk, pv, table, pos), wdt, n_split=n_split, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=WALK_ATOL, rtol=0)
    # a window that ends before the table's keys (pos 2S + 7) leaves none
    if kw.get("window") or (wd or 0) > 0:
        assert not got[-1].any()


def test_paged_walk_reads_block_zero_for_an_id_outside_the_pool():
    """Ids below 0 and at or past N read block 0 (the trash block), as the
    twin does. The twin holds this case: the Pallas kernel in interpret
    mode reads another block for such an id (an index map's out-of-range
    block), a table the fleet never writes."""
    positions = walk_positions(16, 20)
    rng, pk, pv, table = walk_pool(40, 16, 20, len(positions))
    table[2, 0] = pk.shape[0]
    table[-1, 3] = pk.shape[0] + 100
    table[-2, 19] = -7
    q = rng.standard_normal((len(positions), 1, H, DH)).astype(np.float32)
    args = _t(q, pk, pv, table, np.array(positions, np.int32))
    for n_split in (1, 3):
        got = _paged_walk(*args, n_split=n_split)
        torch.testing.assert_close(got, PA.paged_flash_attend_plain(*args),
                                   atol=WALK_ATOL, rtol=0)


@pytest.mark.parametrize("B_, KV_, MB_, bs_", [
    (1, 4, 64, 16), (8, 4, 64, 16), (32, 4, 64, 16), (8, 4, 20, 12), (3, 2, 8, 4),
    (64, 8, 256, 16), (1, 1, 1, 1),
])
def test_paged_splits_fill_the_card_within_the_slot(B_, KV_, MB_, bs_):
    """At least one split and at most one per 64-key tile of the MB * bs
    keys a table row holds; a function of its arguments alone; and
    B * KV * n_split >= 2 x SMs wherever the slot has tiles enough."""
    tiles = -(-(MB_ * bs_) // PA.SLOTS_TILE)
    for sm in (1, 78, 108, 132):
        n = PA._paged_splits(B_, KV_, MB_, bs_, sm)
        assert 1 <= n <= tiles
        assert n == PA._paged_splits(B_, KV_, MB_, bs_, sm)
        assert B_ * KV_ * n >= 2 * sm or n == tiles
    # the fleet's decode step on an H100's 132 SMs: 8 rows of 64 16-key blocks
    assert PA._paged_splits(8, 4, 64, 16, 132) == 9


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_paged_decode_launch_half_matches_the_c_signature(monkeypatch, kw, wd):
    """The wrapper's launch half on CPU tensors against a stand-in library:
    the argument list matches the C signature, with the workspace (B * H *
    n_split * (Dh + 2) fp32), the split count, the window operands and the
    scale; one launch counted per call."""
    from test_torch_kv_quant import _StandInLibrary

    lib = _StandInLibrary(PA.SIGNATURES)
    monkeypatch.setattr(PA, "resolve_kernel", lambda device: True)
    monkeypatch.setattr(PA, "_library", lambda: lib)
    monkeypatch.setattr(PA, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    allocated = []
    empty = torch.empty

    def tracked_empty(*shape, **kwargs):
        t = empty(*shape, **kwargs)
        allocated.append(t)
        return t

    monkeypatch.setattr(torch, "empty", tracked_empty)
    bs, mb = WALK_GEOMETRIES[0]
    rng, pk, pv, table = walk_pool(3, bs, mb, 5)
    q = rng.standard_normal((5, 1, H, DH)).astype(np.float32)
    pos = np.array([0, 3, 64, 170, mb * bs - 1], np.int32)
    _, wdt = _window(wd)
    before = PA.paged_flash_attend.launches
    out = PA.paged_flash_attend(*_t(q, pk, pv, table, pos), wdt, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert PA.paged_flash_attend.launches == before + 1
    name, args = lib.calls[-1]
    assert name == "dli_paged_flash_attend"
    assert len(args) == len(PA.SIGNATURES[name])
    n_split = PA._paged_splits(5, KV, mb, bs, 132)
    assert n_split == 5  # a table row's 320 keys: no more splits than tiles
    (ws,) = [t for t in allocated if t.dtype == torch.float32
             and t.numel() == 5 * H * n_split * (DH + 2)]
    # q, k, v, no scales (a raw pool), out, the workspace; dtype code, B, H,
    # KV, N, bs, MB, Dh; table, pos; the static window and the per-layer
    # one; scale and softcap; the split count; the stream
    assert args[3] is None and args[4] is None
    assert args[5] == out.data_ptr() and args[6] == ws.data_ptr()
    assert args[7:15] == (0, 5, H, KV, pk.shape[0], bs, mb, DH)
    assert args[17] == kw.get("window", -1)
    assert (args[18] is None) == (wdt is None)
    assert args[19] == pytest.approx(kw.get("scale", DH ** -0.5))
    assert args[20] == pytest.approx(kw.get("softcap", 0.0))
    assert args[21] == n_split


# -- the CUDA ragged kernel's flash walk through the table, emulated ----------------

RAGGED_H = 24  # a group of 12 over KV = 2: 96 folded rows a tile, two row tiles
RAGGED_TQ = 8  # the fleet's query tile
RAGGED_CLUSTERS = [1, 2, 4, 8]


def ragged_walk_meta(bs, MB):
    """(f)'s launch shapes cut to a short table row of S = MB * bs keys, one
    query tile per entry: decode rows at 0 and on block, 64-key tile and
    table edges; a 20-token chunk at 50 over three tiles; a 5-token
    prefill row at 37; a tile at MB * bs (its queries attend all S keys);
    an 8-token tile across the last tile edges; two pad tiles that repeat
    their predecessor's row and start with q_len 0."""
    S = MB * bs
    return np.array([
        (0, 0, 1, PA.RAGGED_DECODE), (1, bs - 1, 1, PA.RAGGED_DECODE),
        (2, bs, 1, PA.RAGGED_DECODE), (3, 63, 1, PA.RAGGED_DECODE),
        (4, 64, 1, PA.RAGGED_DECODE), (5, S - 1, 1, PA.RAGGED_DECODE),
        (6, 50, 8, PA.RAGGED_PREFILL), (6, 58, 8, PA.RAGGED_PREFILL),
        (6, 66, 4, PA.RAGGED_PREFILL), (7, 37, 5, PA.RAGGED_PREFILL),
        (8, S, 8, PA.RAGGED_PREFILL), (9, 250, 8, PA.RAGGED_PREFILL),
        (9, 250, 0, PA.RAGGED_PREFILL), (9, 250, 0, PA.RAGGED_PREFILL),
    ], np.int32)


def _ragged_walk(q, pool_k, pool_v, table, meta, window_dyn=None, *, window=None,
                 scale=None, softcap=None, cluster=1, min_share=0,
                 tile=64, rows=64, round_to=None):
    """The ragged kernel's arithmetic in torch, fp32. Tile g's queries
    t < q_len sit at q_start + t of table row `row` (clamped to [0, R));
    its folded rows (r = t * group + h) go in blocks of `rows`, each
    block's live keys the `tile`-key tiles [first, needed) on the tile
    grid from key 0: up to one past its last live query's position (never
    past S = MB * bs), from its first query's window start. The cluster's
    ranks (`min_share` > 0: only as many as keep that many tiles each)
    take even shares in order; each rank folds its tiles into (m, l, acc)
    by a base-2 online softmax, the scores scaled after the product and
    soft-capped, each row masked to its live range; the ranks merge in
    order with the log-sum-exp rescale (one rank divides its own). Key p
    is slot p % bs of block table[row, p // bs] (an id outside [0, N)
    reads block 0); an int8 row is q8 * s in fp32, rounded to `round_to`
    as the kernel rounds it for a bf16 / fp16 product. Dead rows and rows
    with no live key give zeros."""
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    W, H_, Dh = q.shape
    G = meta.shape[0]
    tq = W // G
    int8 = isinstance(pool_k, KVQuant)
    N, KV_, bs, _ = (pool_k.q if int8 else pool_k).shape
    R, MB_ = table.shape
    S = MB_ * bs
    group = H_ // KV_
    scale = Dh ** -0.5 if scale is None else scale
    win = int(window_dyn.reshape(())) if window_dyn is not None else (
        window if window is not None else -1)
    log2e = 1.4426950408889634
    neg = torch.tensor(-0.7 * torch.finfo(torch.float32).max)

    def key_rows(leaf, ids, kvh, slots):
        if int8:
            x = leaf.q[ids, kvh, slots].float() * leaf.s[ids, kvh, slots][:, None]
            return x.to(round_to).float() if round_to is not None else x
        return leaf[ids, kvh, slots].float()

    out = torch.zeros(W, H_, Dh)
    for g in range(G):
        row = min(max(int(meta[g, 0]), 0), R - 1)
        pos = int(meta[g, 1])
        t_live = min(max(int(meta[g, 2]), 0), tq)
        for kvh in range(KV_):
            qh = q[g * tq:(g + 1) * tq, kvh * group:(kvh + 1) * group].reshape(
                tq * group, Dh).float()
            for row0 in range(0, tq * group, rows):
                r = torch.arange(row0, min(row0 + rows, tq * group))
                qp = pos + r // group
                live_row = r < t_live * group
                hi = torch.where(live_row, torch.clamp(qp, max=S - 1), -1)
                lo = torch.clamp(qp - win + 1, min=0) if win > 0 else torch.zeros_like(qp)
                t_lo, t_hi = row0 // group, min((row0 + rows - 1) // group, t_live - 1)
                first = needed = kend = 0
                if t_hi >= t_lo:
                    kend = min(pos + t_hi + 1, S)
                    needed = -(-kend // tile) if kend > 0 else 0
                    first = max(pos + t_lo - win + 1, 0) // tile if win > 0 else 0
                n = max(needed - first, 0)
                ranks = cluster
                while min_share > 0 and ranks > 1 and ranks * min_share > n:
                    ranks //= 2
                parts = []
                for rank in range(ranks):
                    m = neg.expand(len(r)).clone()
                    lsum, acc = torch.zeros(len(r)), torch.zeros(len(r), Dh)
                    for j in range(first + rank * n // ranks, first + (rank + 1) * n // ranks):
                        kp = torch.arange(j * tile, min((j + 1) * tile, kend))
                        ids = table[row, kp // bs].long()
                        ids = torch.where((ids >= 0) & (ids < N), ids, 0)
                        kr = key_rows(pool_k, ids, kvh, kp % bs)
                        vr = key_rows(pool_v, ids, kvh, kp % bs)
                        x = (qh[r] @ kr.T) * scale
                        if softcap is not None:
                            x = softcap * torch.tanh(x / softcap)
                        x = x * log2e
                        live = (kp[None] >= lo[:, None]) & (kp[None] <= hi[:, None])
                        x = torch.where(live, x, neg)
                        m_new = torch.maximum(m, x.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.where(live, torch.exp2(x - m_new[:, None]), 0.0)
                        lsum = lsum * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ vr
                        m = m_new
                    parts.append((m, lsum, acc))
                if ranks == 1:
                    _, lsum, acc = parts[0]
                    o = acc / torch.where(lsum == 0, 1.0, lsum)[:, None]
                else:
                    mx = torch.stack([p_[0] for p_ in parts]).amax(0)
                    lsum, acc = torch.zeros(len(r)), torch.zeros(len(r), Dh)
                    for m, part_l, part_acc in parts:
                        e = torch.exp2(m - mx)
                        lsum = lsum + part_l * e
                        acc = acc + part_acc * e[:, None]
                    o = torch.where(lsum[:, None] == 0, 0.0,
                                    acc / torch.where(lsum == 0, 1.0, lsum)[:, None])
                out[g * tq + r // group, kvh * group + r % group] = o
    return out


def ragged_walk_pool(seed, bs, MB, rows, H_=RAGGED_H):
    """walk_pool's shuffled pool and table, with queries for the launch."""
    rng, pk, pv, table = walk_pool(seed, bs, MB, rows)
    meta = ragged_walk_meta(bs, MB)
    q = rng.standard_normal((meta.shape[0] * RAGGED_TQ, H_, DH)).astype(np.float32)
    return q, pk, pv, table, meta


@functools.lru_cache(maxsize=None)
def _jax_ragged(bs, MB, variant):
    """The Pallas ragged kernel in interpret mode on ragged_walk_pool's
    inputs (cached: every cluster is held to the same result)."""
    kw, wd = WALK_VARIANTS[variant]
    q, pk, pv, table, meta = ragged_walk_pool(60 + bs, bs, MB, 10)
    wdj, _ = _window(wd)
    want = np.asarray(JA.ragged_paged_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(meta), wdj, interpret=True, **kw))
    return (q, pk, pv, table, meta), want


def ragged_dead_rows(meta, tq=RAGGED_TQ):
    """The flat query rows the kernel must write as zeros: launch padding
    and the rows past each tile's q_len."""
    return [g * tq + t for g, m in enumerate(meta) for t in range(int(m[2]), tq)]


@pytest.mark.parametrize("cluster", RAGGED_CLUSTERS)
@pytest.mark.parametrize("variant", range(len(WALK_VARIANTS)), ids=WALK_IDS)
@pytest.mark.parametrize("bs,mb", WALK_GEOMETRIES, ids=["bs16", "bs12"])
def test_ragged_walk_matches_pallas_kernel(bs, mb, variant, cluster):
    """The kernel's walk with every rank walking its share (min_share 0)
    and with the ranks of a short tile agreeing to walk with fewer
    (RAGGED_MIN_SHARE): both within WALK_ATOL of the Pallas kernel, zeros
    on the dead rows."""
    (q, pk, pv, table, meta), want = _jax_ragged(bs, mb, variant)
    kw, wd = WALK_VARIANTS[variant]
    _, wdt = _window(wd)
    for share in (0, PA.RAGGED_MIN_SHARE):
        got = _ragged_walk(*_t(q, pk, pv, table, meta), wdt, cluster=cluster,
                           min_share=share, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=WALK_ATOL, rtol=0)
        assert not got[ragged_dead_rows(meta)].any()


@pytest.mark.parametrize("cluster", [1, 4])
def test_ragged_walk_reads_block_zero_for_an_id_outside_the_pool(cluster):
    """Ids below 0 and at or past N read block 0, the trash block, as the
    twin does (the Pallas kernel in interpret mode reads another block for
    such an id, a table the fleet never writes)."""
    q, pk, pv, table, meta = ragged_walk_pool(70, 16, 20, 10)
    table[0, 0] = -7
    table[6, 3] = pk.shape[0]
    table[8, 19] = pk.shape[0] + 100
    args = _t(q, pk, pv, table, meta)
    got = _ragged_walk(*args, cluster=cluster, min_share=PA.RAGGED_MIN_SHARE)
    torch.testing.assert_close(got, PA.ragged_paged_attend_plain(*args),
                               atol=WALK_ATOL, rtol=0)


@pytest.mark.parametrize("G,tq,H_,KV_,MB_,bs_", [
    (16, 8, 32, 4, 64, 16), (8, 8, 32, 4, 64, 16), (16, 8, 32, 4, 20, 12),
    (4, 16, 48, 4, 64, 16), (2, 4, 8, 2, 3, 4), (64, 8, 64, 8, 256, 16), (1, 1, 1, 1, 1, 1),
])
def test_ragged_plan_covers_the_card_and_mirrors_the_kernel_plan(G, tq, H_, KV_, MB_, bs_):
    """A power of two <= 8 whose blocks cover every SM, unless a rank would
    keep fewer than two of a table row's key tiles; the flash walk's tiles
    and ring, which the entry point checks against its build; a function
    of its arguments alone."""
    from distributed_llm_inference_tpu_torch.ops import flash_attention as fa

    for Dh in (20, 64, 128, 256):
        for esize, kv_esize in ((2, 2), (2, 1), (4, 4), (4, 1)):
            for sm in (1, 78, 132):
                p = PA.ragged_plan(G, tq, H_, KV_, MB_, bs_, Dh, sm, esize, kv_esize)
                assert p == PA.ragged_plan(G, tq, H_, KV_, MB_, bs_, Dh, sm, esize, kv_esize)
                assert p.cluster in (1, 2, 4, 8) and p.min_share == PA.RAGGED_MIN_SHARE
                assert (p.bn, p.stages) == fa.walk_tiles(Dh, esize, kv_esize)
                # the dense plan's tiles for the same widths
                dense = fa.flash_plan(1, tq, H_, KV_, MB_ * bs_, Dh, sm, esize, kv_esize)
                assert (p.rows, p.bn, p.stages, p.row_tiles) == (
                    dense.rows, dense.bn, dense.stages, dense.row_tiles)
                assert p.row_tiles * p.rows >= tq * (H_ // KV_) > (p.row_tiles - 1) * p.rows
                assert p.blocks == G * KV_ * p.row_tiles * p.cluster
                tiles = -(-MB_ * bs_ // p.bn)
                assert p.cluster == 1 or 2 * p.cluster <= tiles
                assert p.blocks >= sm or p.cluster == 8 or 4 * p.cluster > tiles
    # the fleet's mixed launch (16 tiles) and ragged whole-prefill (8) on 132 SMs
    assert PA.ragged_plan(16, 8, 32, 4, 64, 16, 64, 132).cluster == 4
    assert PA.ragged_plan(8, 8, 32, 4, 64, 16, 64, 132).cluster == 8
    assert PA.ragged_plan(16, 8, 32, 4, 64, 16, 64, 132, 2, 1).stages == 3


@pytest.mark.parametrize("kw,wd", VARIANTS, ids=VARIANT_IDS)
def test_ragged_launch_half_matches_the_c_signature(monkeypatch, kw, wd):
    """The wrapper's launch half on CPU tensors against a stand-in library:
    the argument list matches the C signature, with the table's shape, the
    window operands, scale and softcap, then the plan's bn, stages,
    cluster and min_share; a plan passed in replaces ragged_plan's; one
    launch counted per call."""
    from test_torch_kv_quant import _StandInLibrary

    lib = _StandInLibrary(PA.SIGNATURES)
    monkeypatch.setattr(PA, "resolve_kernel", lambda device: True)
    monkeypatch.setattr(PA, "_library", lambda: lib)
    monkeypatch.setattr(PA, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    bs, mb = WALK_GEOMETRIES[0]
    q, pk, pv, table, meta = ragged_walk_pool(4, bs, mb, 10)
    _, wdt = _window(wd)
    before = PA.ragged_paged_attend.launches
    out = PA.ragged_paged_attend(*_t(q, pk, pv, table, meta), wdt, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    name, args = lib.calls[-1]
    assert name == "dli_ragged_paged_attend"
    assert len(args) == len(PA.SIGNATURES[name])
    G = meta.shape[0]
    # q, k, v, no scales (a raw pool), out; dtype code, G, tq, H, KV, N, bs,
    # R, MB, Dh; table, meta; the static window and the per-layer one; scale
    # and softcap; the plan; the stream
    assert args[3] is None and args[4] is None and args[5] == out.data_ptr()
    assert args[6:16] == (0, G, RAGGED_TQ, RAGGED_H, KV, pk.shape[0], bs, 10, mb, DH)
    assert args[18] == kw.get("window", -1)
    assert (args[19] is None) == (wdt is None)
    assert args[20] == pytest.approx(kw.get("scale", DH ** -0.5))
    assert args[21] == pytest.approx(kw.get("softcap", 0.0))
    plan = PA.ragged_plan(G, RAGGED_TQ, RAGGED_H, KV, mb, bs, DH, 132, 4)
    assert args[22:26] == (plan.bn, plan.stages, plan.cluster, plan.min_share)
    assert plan.cluster == 2  # 56 blocks; a rank keeps two of a row's 5 tiles
    PA.ragged_paged_attend(*_t(q, pk, pv, table, meta), wdt,
                           plan=plan._replace(cluster=1, min_share=0), **kw)
    assert lib.calls[-1][1][24:26] == (1, 0)
    assert PA.ragged_paged_attend.launches == before + 2
