"""The port's CUDA kernels on the card, held to their plain twins.

Marked `cuda` and skipped where torch.cuda.is_available() is false. The
file imports nothing of jax, so on a machine with a card and no jax it
runs without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 (summation order differs); bf16 / fp16 atol
2e-2 (outputs round to ~3 significant digits)."""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (B, T, H, KV, Dh, S, pos, valid_start step, kwargs, per-layer window)
CASES = [
    # the solo engine's chunks at tinyllama's widths (clusters of 1, 4, 1, 4)
    (1, 64, 32, 4, 64, 2048, 0, 0, {}, None),
    (1, 64, 32, 4, 64, 2048, 640, 0, {}, None),
    (1, 128, 32, 4, 64, 2048, 0, 0, {}, None),
    (1, 128, 32, 4, 64, 2048, 640, 0, {}, None),
    # T * group no multiple of the 64-row tile; a group of 12 with a window
    (1, 100, 32, 4, 64, 2048, 300, 0, {}, None),
    (2, 50, 48, 4, 64, 1024, 10, 0, {"window": 20}, None),
    (4, 100, 32, 4, 64, 2048, 700, 3, {"window": 128, "softcap": 30.0}, None),
    (2, 33, 8, 1, 256, 512, 5, 7, {"scale": 0.1}, None),
    (1, 40, 8, 2, 24, 128, 5, 0, {}, 16),
    (2, 70, 16, 2, 128, 300, 30, 11, {}, -1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_kernel_matches_twin(card, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(0)
    for B, T, H, KV, Dh, S, pos, vs_step, kw, wdyn in CASES:
        q = torch.randn(B, T, H, Dh, generator=g, device=card).to(dt)
        ck = torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt)
        cv = torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt)
        vs = torch.arange(B, dtype=torch.int32, device=card) * vs_step
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=card)
        before = fa.flash_attend.launches
        got = fa.flash_attend(q, ck, cv, pos, vs, wd, **kw)
        torch.cuda.synchronize()
        assert fa.flash_attend.launches == before + 1
        want = fa.flash_attend_plain(q, ck, cv, pos, vs, wd, **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], (B, T, H, KV, Dh, S, pos, kw, wdyn, err)


def _flash_operands(card, dt, g, B, T, H, KV, Dh, S):
    return (torch.randn(B, T, H, Dh, generator=g, device=card).to(dt),
            torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt),
            torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_zeros_a_row_with_no_live_key_and_repeats_bit_equal(card, dtype):
    """Row 2's valid_start lies past the chunk: none of its queries sees a
    key, and the kernel writes zeros there, as the twin and the TPU kernel
    do. Two calls give the same bits (the cluster's ranks merge in a fixed
    order), raw and int8."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(8)
    q, ck, cv = _flash_operands(card, dt, g, 3, 64, 32, 4, 64, 2048)
    vs = torch.tensor([0, 100, 700], dtype=torch.int32, device=card)
    for k, v in ((ck, cv), (_int8(ck.float()), _int8(cv.float()))):
        got = fa.flash_attend(q, k, v, 600, vs, window=300)
        again = fa.flash_attend(q, k, v, 600, vs, window=300)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        want = fa.flash_attend_plain(q, k, v, 600, vs, window=300)
        assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_flash_kernel_replays_in_a_cuda_graph_bit_equal(card):
    """One call captured in a CUDA graph (a solo chunk's shape): after the
    cache, valid_start and window_dyn change in place, the replay gives an
    eager call's bits, and the eager call passes
    set_sync_debug_mode("error"): nothing is read back to the host."""
    g = torch.Generator(device=card).manual_seed(9)
    q, ck, cv = _flash_operands(card, torch.bfloat16, g, 1, 128, 32, 4, 64, 2048)
    vs = torch.zeros(1, dtype=torch.int32, device=card)
    wd = torch.tensor([-1], dtype=torch.int32, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: library, shared-memory opt-in
        fa.flash_attend(q, ck, cv, 640, vs, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attend(q, ck, cv, 640, vs, wd)
    launches = fa.flash_attend.launches
    for start, width in ((0, -1), (333, 200), (700, 64), (800, -1)):
        ck.copy_(torch.randn(ck.shape, generator=g, device=card))
        cv.copy_(torch.randn(cv.shape, generator=g, device=card))
        vs.fill_(start)
        wd.fill_(width)
        graph.replay()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = fa.flash_attend(q, ck, cv, 640, vs, wd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (start, width)
        want = fa.flash_attend_plain(q, ck, cv, 640, vs, wd)
        assert (out.float() - want.float()).abs().max().item() <= ATOL["bfloat16"]
    assert fa.flash_attend.launches == launches + 4  # the eager calls


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.randn(1, 8, 4, 16, device=card)
    ck = torch.randn(1, 2, 32, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attend(q.transpose(1, 2).contiguous().transpose(1, 2), ck, ck, 0)
    with pytest.raises(TypeError):
        fa.flash_attend(q.half(), ck, ck, 0)
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attend(q, ck, ck, 30)
    with pytest.raises(ValueError):
        fa.flash_attend(q, ck, ck, 0, torch.zeros(1, dtype=torch.int64, device=card))
    with pytest.raises(TypeError, match="KVQuant"):  # int8 without its scales
        fa.flash_attend(q, ck.to(torch.int8), ck.to(torch.int8), 0)


def test_engine_kernel_path_matches_plain_path(card):
    """Greedy generation on the card through the kernel (attn_impl
    "auto" on CUDA) gives the plain path's tokens, in fp32, and every
    T>1 chunk launched the kernel once per layer."""
    cfg = EngineConfig(prefill_buckets=(16, 32))
    out = {}
    for impl in ("auto", "plain"):
        engine = create_engine("test-llama-tiny", attn_impl=impl, seed=3,
                               engine_cfg=cfg, device=card)
        before = fa.flash_attend.launches
        r = engine.generate("The quick brown fox jumps over it, twice.",
                            max_tokens=10, greedy=True, chat=False)
        out[impl] = (r["response"], r["tokens_generated"],
                     fa.flash_attend.launches - before)
    # 42-token prompt: one 32-token extend chunk, then a 16-token bucket
    assert out["auto"][2] == 2 * 4 and out["plain"][2] == 0
    assert out["auto"][:2] == out["plain"][:2]


def _pool_case(card, dt, g, *, N, KV, bs, Dh, R, MB):
    """A random pool and R block tables drawn from a shuffled permutation
    of the physical blocks 1..N-1 (block 0 is the trash block)."""
    pool_k = torch.randn(N, KV, bs, Dh, generator=g, device=card).to(dt)
    pool_v = torch.randn(N, KV, bs, Dh, generator=g, device=card).to(dt)
    perm = torch.randperm(N - 1, generator=g, device=card)[: R * MB] + 1
    table = perm.reshape(R, MB).to(torch.int32).contiguous()
    return pool_k, pool_v, table


# (kwargs, per-layer window)
PAGED_VARIANTS = [({}, None), ({"window": 256}, None), ({}, 300), ({}, -1),
                  ({"softcap": 30.0}, None), ({"scale": 0.2}, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_decode_kernel_matches_twin(card, dtype):
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(1)
    H, KV, Dh, bs, MB = 32, 4, 64, 16, 64
    pool_k, pool_v, table = _pool_case(card, dt, g, N=8 * MB + 1, KV=KV,
                                       bs=bs, Dh=Dh, R=8, MB=MB)
    pos = torch.tensor([0, 15, 16, 700, 1023, 5, 64, 333], dtype=torch.int32,
                       device=card)
    q = torch.randn(8, 1, H, Dh, generator=g, device=card).to(dt)
    for kw, wdyn in PAGED_VARIANTS:
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=card)
        before = pa.paged_flash_attend.launches
        got = pa.paged_flash_attend(q, pool_k, pool_v, table, pos, wd, **kw)
        torch.cuda.synchronize()
        assert pa.paged_flash_attend.launches == before + 1
        want = pa.paged_flash_attend_plain(q, pool_k, pool_v, table, pos, wd, **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], (kw, wdyn, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ragged_kernel_matches_twin(card, dtype):
    """Decode rows, a prefill chunk, a short prefill row and pad tiles in
    one launch, over shuffled tables."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(2)
    H, KV, Dh, bs, MB, tq = 32, 4, 64, 16, 64, 8
    pool_k, pool_v, table = _pool_case(card, dt, g, N=10 * MB + 1, KV=KV,
                                       bs=bs, Dh=Dh, R=10, MB=MB)
    # (row, q_start, q_len, kind) per tile: 3 decode rows, a 19-token chunk
    # at 640 over three tiles, a 5-token row at 0, then two pad tiles that
    # repeat their predecessor's row and start with q_len 0
    meta = [(0, 17, 1, 1), (1, 1023, 1, 1), (2, 0, 1, 1),
            (5, 640, 8, 0), (5, 648, 8, 0), (5, 656, 3, 0),
            (9, 0, 5, 0), (9, 0, 0, 0), (9, 0, 0, 0)]
    meta = torch.tensor(meta, dtype=torch.int32, device=card)
    q = torch.randn(meta.shape[0] * tq, H, Dh, generator=g, device=card).to(dt)
    for kw, wdyn in PAGED_VARIANTS:
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=card)
        before = pa.ragged_paged_attend.launches
        got = pa.ragged_paged_attend(q, pool_k, pool_v, table, meta, wd, **kw)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attend.launches == before + 1
        want = pa.ragged_paged_attend_plain(q, pool_k, pool_v, table, meta, wd,
                                            **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], (kw, wdyn, err)
        # padding tiles and the rows past a tile's q_len are zeros
        assert got[7 * tq:].abs().max().item() == 0.0
        assert got[6 * tq + 5: 7 * tq].abs().max().item() == 0.0


# the ragged kernel's flash walk through the table at its edges: (H, KV, Dh,
# bs, MB, tq, per-tile (row, q_start, q_len, kind)). Tinyllama's widths with
# decode rows at block, 64-key tile and split edges, a 64-token chunk whose
# tiles straddle a tile edge, one past the table (q_start >= MB * bs:
# attends all MB * bs keys), a 5-token row at 37, then pad tiles; 12-key
# blocks that straddle the tiles' edges; a group of 12 heads (96 folded
# rows: two row tiles); Dh 128, 256, and 20 (rows no multiple of 16 bytes:
# element copies)
RAGGED_EDGE_CASES = [
    (32, 4, 64, 16, 64, 8, [(0, 0, 1, 1), (1, 15, 1, 1), (2, 16, 1, 1), (3, 63, 1, 1),
                            (4, 64, 1, 1), (5, 1023, 1, 1), (6, 56, 8, 0), (6, 64, 8, 0),
                            (7, 1030, 8, 0), (8, 37, 5, 0), (8, 37, 0, 0), (8, 37, 0, 0)]),
    (32, 4, 64, 12, 50, 8, [(0, 11, 1, 1), (1, 12, 1, 1), (2, 599, 1, 1), (3, 590, 8, 0),
                            (3, 598, 2, 0), (4, 0, 0, 0)]),
    (24, 2, 64, 16, 44, 8, [(0, 699, 1, 1), (1, 100, 8, 0), (1, 108, 7, 0), (1, 0, 0, 0)]),
    (8, 2, 128, 16, 20, 4, [(0, 0, 1, 1), (1, 17, 4, 0), (2, 300, 4, 0), (2, 0, 0, 0)]),
    (16, 2, 256, 16, 38, 4, [(0, 599, 1, 1), (1, 64, 4, 0), (1, 68, 3, 0)]),
    (8, 2, 20, 8, 13, 4, [(0, 5, 1, 1), (1, 100, 4, 0), (1, 104, 1, 0), (0, 0, 0, 0)]),
]


def _ragged_edge_operands(card, dt, g, H, KV, Dh, bs, MB, tq, meta):
    """A shuffled pool as _pool_case (one table row per distinct meta row),
    with bad ids inside the live ranges of row 0 (-3) and of the last row
    (N + 5): both read block 0, the trash block, as in the twin."""
    R = max(m[0] for m in meta) + 1
    pool_k, pool_v, table = _pool_case(card, dt, g, N=R * MB + 1, KV=KV, bs=bs, Dh=Dh,
                                       R=R, MB=MB)
    table[0, 0] = -3
    table[-1, min(MB - 1, max(m[1] for m in meta if m[0] == R - 1) // bs)] = R * MB + 6
    q = torch.randn(len(meta) * tq, H, Dh, generator=g, device=card).to(dt)
    return q, pool_k, pool_v, table, torch.tensor(meta, dtype=torch.int32, device=card)


def _dead_rows(meta, tq):
    """The flat query rows that must be zeros: launch padding and the rows
    past each tile's q_len."""
    return [g * tq + t for g, m in enumerate(meta) for t in range(m[2], tq)]


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ragged_kernel_matches_twin_at_tile_block_and_split_edges(card, dtype, int8):
    """Every edge case above under every variant, raw and int8 pools: within
    atol of the twin, the same bits on a repeat, exact zeros on padding."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(25)
    for H, KV, Dh, bs, MB, tq, meta in RAGGED_EDGE_CASES:
        q, pk, pv, table, m = _ragged_edge_operands(card, torch.float32, g, H, KV, Dh, bs,
                                                    MB, tq, meta)
        q = q.to(dt)
        pk, pv = (_int8(pk), _int8(pv)) if int8 else (pk.to(dt), pv.to(dt))
        dead = _dead_rows(meta, tq)
        for kw, wdyn in PAGED_VARIANTS:
            wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                        device=card)
            counts = (pa.ragged_paged_attend.launches, pa.ragged_paged_attend.launches_int8)
            got = pa.ragged_paged_attend(q, pk, pv, table, m, wd, **kw)
            again = pa.ragged_paged_attend(q, pk, pv, table, m, wd, **kw)
            torch.cuda.synchronize()
            assert (pa.ragged_paged_attend.launches, pa.ragged_paged_attend.launches_int8) \
                == ((counts[0], counts[1] + 2) if int8 else (counts[0] + 2, counts[1]))
            assert torch.equal(got, again)  # a fixed-order merge: the same bits
            want = pa.ragged_paged_attend_plain(q, pk, pv, table, m, wd, **kw)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (H, Dh, bs, meta, kw, wdyn, err)
            assert not got[dead].any(), (H, Dh, bs, kw, wdyn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_kernel_agrees_across_clusters_and_shares(card, dtype):
    """The fleet's mixed launch under every cluster size and every
    min_share (0: each rank walks its share, however short): within atol
    of the twin, each plan's repeats bit-equal."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(26)
    H, KV, Dh, bs, MB, tq, meta = RAGGED_EDGE_CASES[0]
    q, pk, pv, table, m = _ragged_edge_operands(card, dt, g, H, KV, Dh, bs, MB, tq, meta)
    want = pa.ragged_paged_attend_plain(q, pk, pv, table, m)
    chosen = pa.ragged_plan(len(meta), tq, H, KV, MB, bs, Dh,
                            torch.cuda.get_device_properties(card).multi_processor_count,
                            q.element_size())
    for cluster in (1, 2, 4, 8):
        for share in (0, 1, 2, 4):
            plan = chosen._replace(cluster=cluster, min_share=share)
            got = pa.ragged_paged_attend(q, pk, pv, table, m, plan=plan)
            again = pa.ragged_paged_attend(q, pk, pv, table, m, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (cluster, share)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (cluster, share, err)


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_ragged_kernel_replays_in_a_cuda_graph_bit_equal(card, int8):
    """One call at the mixed launch's width captured in a CUDA graph (the
    plan fixed on the host): after meta and the per-layer window change in
    place, as engine/paged.apply_device_meta rewrites them, each replay
    gives the eager call's bits; the eager call passes
    set_sync_debug_mode("error")."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=card).manual_seed(27)
    H, KV, Dh, bs, MB, tq, meta = RAGGED_EDGE_CASES[0]
    q, pk, pv, table, m = _ragged_edge_operands(card, torch.float32, g, H, KV, Dh, bs, MB,
                                                tq, meta)
    q = q.to(torch.bfloat16)
    pk, pv = (_int8(pk), _int8(pv)) if int8 else (pk.to(torch.bfloat16),
                                                  pv.to(torch.bfloat16))
    wd = torch.tensor([-1], dtype=torch.int32, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: library, shared-memory opt-in
        pa.ragged_paged_attend(q, pk, pv, table, m, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.ragged_paged_attend(q, pk, pv, table, m, wd)
    counts = (pa.ragged_paged_attend.launches, pa.ragged_paged_attend.launches_int8)
    shifted = [(r, s + 100, n, k) for r, s, n, k in meta]
    decode_only = [(r, 1023 - r, 1 if r < 8 else 0, 1) for r, _, _, _ in meta]
    for new_meta, width in ((meta, -1), (shifted, 256), (decode_only, 300)):
        m.copy_(torch.tensor(new_meta, dtype=torch.int32))
        wd.fill_(width)
        graph.replay()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = pa.ragged_paged_attend(q, pk, pv, table, m, wd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), width
        want = pa.ragged_paged_attend_plain(q, pk, pv, table, m, wd)
        assert (out.float() - want.float()).abs().max().item() <= ATOL["bfloat16"]
        assert not out[_dead_rows(new_meta, tq)].any()
    # the eager calls only, on the count of the pool's storage type
    assert (pa.ragged_paged_attend.launches, pa.ragged_paged_attend.launches_int8) == (
        (counts[0], counts[1] + 3) if int8 else (counts[0] + 3, counts[1]))


def test_paged_kernels_reject_what_they_do_not_take(card):
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    pool = torch.randn(9, 2, 16, 16, device=card)
    table = torch.ones(2, 4, dtype=torch.int32, device=card)
    q = torch.randn(2, 1, 4, 16, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_flash_attend(q, pool, pool, table.long(), pos)
    with pytest.raises(TypeError):
        pa.paged_flash_attend(q.half(), pool, pool, table, pos)
    with pytest.raises(TypeError, match="KVQuant"):  # int8 without its scales
        pa.paged_flash_attend(q, pool.to(torch.int8), pool.to(torch.int8), table, pos)
    meta = torch.zeros(3, 4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="dividing"):
        pa.ragged_paged_attend(torch.randn(8, 4, 16, device=card), pool, pool,
                               table, meta)


# the paged decode kernel's split-KV walk at its edges: (B, H, KV, Dh, bs, MB,
# positions). B = 1 (the most splits: one per 64-key tile of the row), B = 8
# at the fleet's shapes with positions on block, tile and split edges (9
# splits of 16 tiles on 132 SMs), B = 32 on both sides of every tile edge
# (3 splits), 12-key blocks that straddle the tiles' edges, a group of 12
# heads (two head tiles), Dh 128 and 256, and a Dh of 20 whose rows are no
# multiple of 16 bytes (element copies, no cp.async); each list holds a row
# at pos >= MB * bs (attends all of them)
PAGED_SPLIT_CASES = [
    (1, 32, 4, 64, 16, 64, [1023]),
    (1, 32, 4, 64, 16, 64, [1087]),
    (8, 32, 4, 64, 16, 64, [0, 15, 16, 63, 64, 127, 128, 1023]),
    (8, 32, 4, 64, 16, 64, [191, 192, 447, 448, 703, 704, 959, 5000]),
    (32, 32, 4, 64, 16, 64, [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 255, 256, 257,
                             319, 320, 383, 384, 447, 448, 511, 512, 575, 576, 639, 640,
                             703, 704, 767, 768, 1022, 1023, 1024]),
    (4, 32, 4, 64, 12, 50, [11, 12, 599, 600]),
    (2, 24, 2, 64, 16, 44, [699, 704]),
    (3, 8, 2, 128, 16, 20, [0, 17, 400]),
    (2, 16, 2, 256, 16, 38, [599, 64]),
    (2, 8, 2, 20, 8, 13, [5, 103]),
]


def _paged_split_operands(card, dt, g, B, H, KV, Dh, bs, MB, positions):
    """A shuffled pool as _pool_case, with a bad id inside the live range of
    row 0 (-3) and of the last row (N + 5): both read block 0, the trash
    block, as in the twin."""
    pool_k, pool_v, table = _pool_case(card, dt, g, N=B * MB + 1, KV=KV, bs=bs,
                                       Dh=Dh, R=B, MB=MB)
    table[0, 0] = -3
    table[-1, min(MB - 1, positions[-1] // bs)] = B * MB + 6
    q = torch.randn(B, 1, H, Dh, generator=g, device=card).to(dt)
    return q, pool_k, pool_v, table, torch.tensor(positions, dtype=torch.int32, device=card)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_decode_kernel_matches_twin_at_split_edges(card, dtype):
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(21)
    for B, H, KV, Dh, bs, MB, positions in PAGED_SPLIT_CASES:
        q, pk, pv, table, pos = _paged_split_operands(card, dt, g, B, H, KV, Dh, bs, MB,
                                                      positions)
        for kw, wdyn in PAGED_VARIANTS:
            wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                        device=card)
            before = pa.paged_flash_attend.launches
            got = pa.paged_flash_attend(q, pk, pv, table, pos, wd, **kw)
            again = pa.paged_flash_attend(q, pk, pv, table, pos, wd, **kw)
            torch.cuda.synchronize()
            assert pa.paged_flash_attend.launches == before + 2
            assert torch.equal(got, again)  # a fixed-order merge: the same bits
            want = pa.paged_flash_attend_plain(q, pk, pv, table, pos, wd, **kw)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (B, Dh, bs, positions, kw, wdyn, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_int8_paged_decode_kernel_matches_twin_at_split_edges(card, dtype):
    """The int8 pool's ring (int8 rows and fp32 scales) and each warp's
    dequantized keys, at the split edges above."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(22)
    for B, H, KV, Dh, bs, MB, positions in PAGED_SPLIT_CASES:
        q, pk, pv, table, pos = _paged_split_operands(card, torch.float32, g, B, H, KV,
                                                      Dh, bs, MB, positions)
        q, pk, pv = q.to(dt), _int8(pk), _int8(pv)
        for kw, wdyn in PAGED_VARIANTS:
            wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                        device=card)
            before = pa.paged_flash_attend.launches_int8
            got = pa.paged_flash_attend(q, pk, pv, table, pos, wd, **kw)
            torch.cuda.synchronize()
            assert pa.paged_flash_attend.launches_int8 == before + 1
            assert torch.equal(got, pa.paged_flash_attend(q, pk, pv, table, pos, wd, **kw))
            want = pa.paged_flash_attend_plain(q, pk, pv, table, pos, wd, **kw)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (B, Dh, bs, positions, kw, wdyn, err)


def test_paged_decode_kernel_gives_zeros_for_a_row_with_no_live_key(card):
    """pos < 0, or a window that ends before MB * bs (a row at 2 MB bs):
    every split is empty and the merge writes zeros, as the TPU kernel does."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=card).manual_seed(23)
    q, pk, pv, table, pos = _paged_split_operands(card, torch.bfloat16, g, 4, 32, 4, 64,
                                                  16, 64, [-1, 5, 2048, 700])
    got = pa.paged_flash_attend(q, pk, pv, table, pos, window=13)
    want = pa.paged_flash_attend_plain(q, pk, pv, table, pos, window=13)
    assert torch.equal(got[0::2], torch.zeros_like(got[0::2]))
    assert (got[1::2].float() - want[1::2].float()).abs().max().item() <= ATOL["bfloat16"]


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
def test_paged_decode_kernel_replays_in_a_cuda_graph_bit_equal(card, int8):
    """One call at the fleet's shapes captured in a CUDA graph (the
    workspace from the graph's pool, n_split fixed on the host): after pos
    and the per-layer window change in place, each replay gives the eager
    call's bits; the eager call passes set_sync_debug_mode("error")."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=card).manual_seed(24)
    q, pk, pv, table, pos = _paged_split_operands(card, torch.float32, g, 8, 32, 4, 64,
                                                  16, 64, [1023] * 8)
    q = q.to(torch.bfloat16)
    pk, pv = (_int8(pk), _int8(pv)) if int8 else (pk.to(torch.bfloat16),
                                                  pv.to(torch.bfloat16))
    wd = torch.tensor([-1], dtype=torch.int32, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: library, shared-memory opt-in
        pa.paged_flash_attend(q, pk, pv, table, pos, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_flash_attend(q, pk, pv, table, pos, wd)
    counts = (pa.paged_flash_attend.launches, pa.paged_flash_attend.launches_int8)
    for positions, width in (([0, 15, 16, 63, 64, 500, 1023, 1024], -1),
                             ([-1, 3, 700, 2048] * 2, 256), ([1023] * 8, 300)):
        pos.copy_(torch.tensor(positions, dtype=torch.int32))
        wd.fill_(width)
        graph.replay()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = pa.paged_flash_attend(q, pk, pv, table, pos, wd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (positions, width)
        want = pa.paged_flash_attend_plain(q, pk, pv, table, pos, wd)
        assert (out.float() - want.float()).abs().max().item() <= ATOL["bfloat16"]
    # the eager calls only, on the count of the pool's storage type
    assert (pa.paged_flash_attend.launches, pa.paged_flash_attend.launches_int8) == (
        (counts[0], counts[1] + 3) if int8 else (counts[0] + 3, counts[1]))


# -- int4 weights and the int8 KV cache --------------------------------------------

# q4 outputs are sums of in ~ 2048-5632 products of size ~in**-0.5: |y|
# stays below 8, where one bf16 ulp is 0.03 and one fp16 ulp 0.004, and
# the kernel and its twin may round the same fp32 sum to neighbours
Q4_ATOL = {"float32": 1e-4, "bfloat16": 6e-2, "float16": 1e-2}
# tinyllama's projections (in, out) with the LM head; 5632 -> 2048 has
# G = 88 groups, (64, 128) one group and one column tile
Q4_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000),
             (256, 384), (64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_q4_matmul_kernel_matches_twin(card, dtype):
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(4)
    for d_in, d_out in Q4_SHAPES:
        w = Q.quantize_tensor4(
            torch.randn(d_in, d_out, generator=g, device=card) * d_in ** -0.5)
        for R in (1, 5, 8, 9, 16, 17, 32):
            x = torch.randn(R, d_in, generator=g, device=card).to(dt)
            before = Q.q4_matmul_rows.launches
            got = Q.q4_matmul_rows(x, w)
            torch.cuda.synchronize()
            assert Q.q4_matmul_rows.launches == before + 1
            assert got.dtype == dt and got.shape == (R, d_out)
            want = Q.q4_matmul_rows_plain(x, w)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= Q4_ATOL[dtype], (d_in, d_out, R, err)
            # the split over groups reduces in a fixed order: same bits again
            assert torch.equal(got, Q.q4_matmul_rows(x, w))


def test_q4_matmul_replays_in_a_cuda_graph_bit_equal(card):
    """One call captured in a CUDA graph: after x changes in place, the
    replay gives an eager call's bits; the call passes
    set_sync_debug_mode("error") (nothing is read back to the host)."""
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    g = torch.Generator(device=card).manual_seed(7)
    for d_in, d_out, R in ((2048, 2048, 8), (5632, 2048, 32), (2048, 32000, 1)):
        w = Q.quantize_tensor4(
            torch.randn(d_in, d_out, generator=g, device=card) * d_in ** -0.5)
        x = torch.randn(R, d_in, generator=g, device=card).to(torch.bfloat16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm: library, shared-memory opt-in
            Q.q4_matmul_rows(x, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = Q.q4_matmul_rows(x, w)
        launches = Q.q4_matmul_rows.launches
        for _ in range(2):
            x.copy_(torch.randn(R, d_in, generator=g, device=card))
            graph.replay()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = Q.q4_matmul_rows(x, w)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert torch.equal(out, eager), (d_in, d_out, R)
            want = Q.q4_matmul_rows_plain(x, w)
            assert (out.float() - want.float()).abs().max().item() <= Q4_ATOL["bfloat16"]
        assert Q.q4_matmul_rows.launches == launches + 2  # the eager calls


def test_q4_matmul_rejects_what_it_does_not_take(card):
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    w = Q.quantize_tensor4(torch.randn(256, 384, device=card))
    with pytest.raises(ValueError):
        Q.q4_matmul_rows(torch.randn(33, 256, device=card), w)
    with pytest.raises(ValueError):
        Q.q4_matmul_rows(torch.randn(2, 256, device=card),
                         Q.quantize_tensor4(torch.randn(256, 96, device=card)))
    with pytest.raises(TypeError):
        Q.q4_matmul_rows(torch.randn(2, 256, device=card).double(), w)


def _int8(x):
    from distributed_llm_inference_tpu_torch.ops import kv_quant as K

    q, s = K.quantize_chunk(x)
    return K.KVQuant(q.contiguous(), s.contiguous())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_flash_kernel_matches_twin(card, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(5)
    for B, T, H, KV, Dh, S, pos, vs_step, kw, wdyn in CASES:
        q = torch.randn(B, T, H, Dh, generator=g, device=card).to(dt)
        ck = _int8(torch.randn(B, KV, S, Dh, generator=g, device=card))
        cv = _int8(torch.randn(B, KV, S, Dh, generator=g, device=card))
        vs = torch.arange(B, dtype=torch.int32, device=card) * vs_step
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=card)
        before = (fa.flash_attend.launches, fa.flash_attend.launches_int8)
        got = fa.flash_attend(q, ck, cv, pos, vs, wd, **kw)
        torch.cuda.synchronize()
        assert (fa.flash_attend.launches, fa.flash_attend.launches_int8) == (
            before[0], before[1] + 1)
        want = fa.flash_attend_plain(q, ck, cv, pos, vs, wd, **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], (B, T, H, KV, Dh, S, pos, kw, wdyn, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_kernels_match_twins(card, dtype):
    """Both entry points over one shuffled int8 pool: a decode batch, and
    a ragged launch of decode rows, a chunk, a short row and pad tiles."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(6)
    H, KV, Dh, bs, MB, tq = 32, 4, 64, 16, 64, 8
    pool_k, pool_v, table = _pool_case(card, torch.float32, g, N=10 * MB + 1, KV=KV,
                                       bs=bs, Dh=Dh, R=10, MB=MB)
    pool_k, pool_v = _int8(pool_k), _int8(pool_v)
    pos = torch.tensor([0, 15, 16, 700, 1023, 5, 64, 333], dtype=torch.int32,
                       device=card)
    qd = torch.randn(8, 1, H, Dh, generator=g, device=card).to(dt)
    meta = torch.tensor([(0, 17, 1, 1), (1, 1023, 1, 1), (2, 0, 1, 1),
                         (5, 640, 8, 0), (5, 648, 8, 0), (5, 656, 3, 0),
                         (9, 0, 5, 0), (9, 0, 0, 0)], dtype=torch.int32, device=card)
    qr = torch.randn(meta.shape[0] * tq, H, Dh, generator=g, device=card).to(dt)
    for kw, wdyn in PAGED_VARIANTS:
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=card)
        for fn, args in (("paged_flash_attend", (qd, pool_k, pool_v, table[:8], pos)),
                         ("ragged_paged_attend", (qr, pool_k, pool_v, table, meta))):
            wrapper = getattr(pa, fn)
            before = wrapper.launches_int8
            got = wrapper(*args, wd, **kw)
            torch.cuda.synchronize()
            assert wrapper.launches_int8 == before + 1
            want = getattr(pa, fn + "_plain")(*args, wd, **kw)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (fn, kw, wdyn, err)


def test_quantized_engine_kernel_path_matches_plain_path(card):
    """Greedy generation on the card under quant="int4", kv_quant="int8"
    through the kernels (attn_impl "auto") gives the plain attention
    path's tokens in fp32, solo and on the fleet, and the kernels ran."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    cfg = EngineConfig(prefill_buckets=(16, 32))
    prompt = "The quick brown fox jumps over it, twice."
    out = {}
    for impl in ("auto", "plain"):
        engine = create_engine("test-llama-tiny", attn_impl=impl, seed=3, quant="int4",
                               kv_quant="int8", engine_cfg=cfg, device=card)
        counts = (fa.flash_attend.launches_int8, pa.ragged_paged_attend.launches_int8,
                  Q.q4_matmul_rows.launches)
        solo = engine.generate(prompt, max_tokens=10, greedy=True, chat=False)
        fleet = ContinuousEngine(engine, n_slots=2, kv_pool_blocks=20, slot_max_seq=128)
        try:
            r = fleet.submit(prompt, max_tokens=10, greedy=True, chat=False)
        finally:
            fleet.close()
        now = (fa.flash_attend.launches_int8, pa.ragged_paged_attend.launches_int8,
               Q.q4_matmul_rows.launches)
        out[impl] = (solo["response"], r["response"], [b - a for a, b in zip(counts, now)])
    assert out["auto"][:2] == out["plain"][:2]
    assert out["auto"][2][0] == 2 * 4 and out["plain"][2][0] == 0  # two T>1 chunks
    assert out["auto"][2][1] > 0 and out["plain"][2][1] == 0
    assert out["auto"][2][2] > 0 and out["plain"][2][2] > 0  # q4 on both paths


# -- flash_attend_slots: T=1 decode over the dense slot cache ------------------------

# (B, H, KV, Dh, S, positions): the JAX bench's fleet leg (8 x 8192 at
# pos 1024), the dense fleet's 1024-position slots with block edges, the
# last position and a finished slot at pos = S, an S that is no multiple
# of the 64-key tile, and a small GQA shape with a frozen pos past S;
# then the split-KV kernel's edges: B = 1 (the most splits per row, 66 on
# 132 SMs) with the live range's last tile full or ragged, B = 32 (the
# fewest) with positions on both sides of every 64-key tile edge, a group
# of 12 heads (two head tiles, the second half empty), Dh 256, and a Dh
# of 20 whose rows are no multiple of 16 bytes (element copies, no
# cp.async)
SLOTS_CASES = [
    (8, 32, 4, 64, 8192, [1024] * 8),
    (8, 32, 4, 64, 1024, [0, 17, 63, 64, 500, 1000, 1023, 1024]),
    (4, 32, 4, 64, 1000, [0, 999, 1000, 640]),
    (3, 8, 2, 128, 44, [0, 17, 50]),
    (1, 32, 4, 64, 8192, [1024]),
    (1, 32, 4, 64, 8192, [8191]),
    (1, 32, 4, 64, 4096, [1087]),
    (32, 32, 4, 64, 1024, [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 255, 256, 257,
                           319, 320, 383, 384, 447, 448, 511, 512, 575, 576, 639, 640,
                           703, 704, 767, 768, 1022, 1023, 1024]),
    (2, 24, 2, 64, 700, [699, 130]),
    (2, 16, 2, 256, 600, [599, 64]),
    (2, 8, 2, 20, 100, [5, 99]),
]


def _slots_operands(card, dt, g, B, H, KV, Dh, S, positions):
    q = torch.randn(B, 1, H, Dh, generator=g, device=card).to(dt)
    ck = torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt)
    cv = torch.randn(B, KV, S, Dh, generator=g, device=card).to(dt)
    return q, ck, cv, torch.tensor(positions, dtype=torch.int32, device=card)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_slots_kernel_matches_twin(card, dtype):
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(4)
    for B, H, KV, Dh, S, positions in SLOTS_CASES:
        q, ck, cv, pos = _slots_operands(card, dt, g, B, H, KV, Dh, S, positions)
        for window in (None, 256, 13):
            before = pa.flash_attend_slots.launches
            got = pa.flash_attend_slots(q, ck, cv, pos, window=window)
            again = pa.flash_attend_slots(q, ck, cv, pos, block_k=128, window=window)
            torch.cuda.synchronize()
            assert pa.flash_attend_slots.launches == before + 2
            assert torch.equal(got, again)  # block_k and repeats: same bits
            want = pa.flash_attend_slots_plain(q, ck, cv, pos, window=window)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (B, S, positions, window, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_slots_kernel_gives_zeros_for_a_row_with_no_live_key(card, dtype):
    """pos < 0, or a window that ends before S (a frozen slot at 2S):
    every split is empty and the merge writes zeros, as the TPU kernel
    does; the live rows of the same call match the twin."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(5)
    q, ck, cv, pos = _slots_operands(card, dt, g, 4, 32, 4, 64, 300, [-1, 5, -7, 299])
    for window in (None, 13):
        got = pa.flash_attend_slots(q, ck, cv, pos, window=window)
        want = pa.flash_attend_slots_plain(q, ck, cv, pos, window=window)
        assert torch.equal(got[0::2], torch.zeros_like(got[0::2]))
        assert (got[1::2].float() - want[1::2].float()).abs().max().item() <= ATOL[dtype]
    frozen = torch.tensor([600, 5, 600, 299], dtype=torch.int32, device=card)
    got = pa.flash_attend_slots(q, ck, cv, frozen, window=13)
    assert torch.equal(got[0::2], torch.zeros_like(got[0::2]))
    got = pa.flash_attend_slots(q, ck, cv, frozen)  # no window: attends all S
    want = pa.flash_attend_slots_plain(q, ck, cv, frozen)
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_slots_kernel_replays_in_a_cuda_graph_bit_equal(card):
    """One call captured in a CUDA graph: after pos changes in place, the
    replay gives the eager call's bits; the call passes
    set_sync_debug_mode("error") (nothing is read back to the host)."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=card).manual_seed(6)
    q, ck, cv, pos = _slots_operands(card, torch.bfloat16, g, 8, 32, 4, 64, 1024,
                                     [1024] * 8)
    for window in (None, 256):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm: library, shared-memory opt-in
            pa.flash_attend_slots(q, ck, cv, pos, window=window)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pa.flash_attend_slots(q, ck, cv, pos, window=window)
        launches = pa.flash_attend_slots.launches
        for positions in ([0, 17, 63, 64, 500, 1000, 1023, 1024], [-1, 3, 700, 2048] * 2):
            pos.copy_(torch.tensor(positions, dtype=torch.int32))
            graph.replay()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = pa.flash_attend_slots(q, ck, cv, pos, window=window)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert torch.equal(out, eager), (window, positions)
            want = pa.flash_attend_slots_plain(q, ck, cv, pos, window=window)
            # pos < 0, or a window that ends before S: no live key, zeros
            live = (pos >= 0) & ((pos - (window or 0) + 1 < 1024) if window else True)
            assert torch.equal(out[~live], torch.zeros_like(out[~live]))
            assert (out[live].float() - want[live].float()).abs().max().item() \
                <= ATOL["bfloat16"]
        assert pa.flash_attend_slots.launches == launches + 2  # the eager calls


def test_slots_kernel_rejects_what_it_does_not_take(card):
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    q = torch.randn(2, 1, 4, 16, device=card)
    ck = torch.randn(2, 2, 32, 16, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        pa.flash_attend_slots(q, ck, ck, pos.long())
    with pytest.raises(TypeError):
        pa.flash_attend_slots(q.half(), ck, ck, pos)
    with pytest.raises(ValueError, match="T=1|B,1"):
        pa.flash_attend_slots(torch.randn(2, 3, 4, 16, device=card), ck, ck, pos)
    with pytest.raises(ValueError, match="window"):
        pa.flash_attend_slots(q, ck, ck, pos, window=0)


def test_dense_fleet_kernel_path_matches_plain_path(card):
    """The dense fleet on the card, fp32: the kernel path (flash_attend for
    every T>1 prefill chunk, the einsum at decode) gives the plain path's
    greedy tokens, and no paged or slots kernel runs."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    cfg = EngineConfig(prefill_buckets=(16, 32))
    out = {}
    for impl in ("auto", "plain"):
        engine = create_engine("test-llama-tiny", attn_impl=impl, seed=3,
                               engine_cfg=cfg, device=card)
        fleet = ContinuousEngine(engine, n_slots=2, chunk_steps=4, slot_max_seq=128)
        counts = (fa.flash_attend.launches, pa.paged_flash_attend.launches,
                  pa.ragged_paged_attend.launches, pa.flash_attend_slots.launches)
        try:
            r = fleet.submit("The quick brown fox jumps over it, twice.",
                             max_tokens=10, greedy=True, chat=False)
        finally:
            fleet.close()
        after = (fa.flash_attend.launches, pa.paged_flash_attend.launches,
                 pa.ragged_paged_attend.launches, pa.flash_attend_slots.launches)
        out[impl] = (r["token_ids"], [a - b for a, b in zip(after, counts)],
                     r["prefill_chunks"])
    # 42-token prompt: one 32-token extend chunk, then a 16-token bucket
    assert out["auto"][2] == 2 and out["auto"][1] == [2 * 4, 0, 0, 0]
    assert out["plain"][1] == [0, 0, 0, 0]
    assert out["auto"][0] == out["plain"][0]


# -- CUDA graphs of the fleet's launches (engine/graphs.py) -----------------------

GRAPH_KINDS = ["decode_chunk", "mixed_arming", "mixed_idle", "dense_chunk"]
GRAPH_QUANT = {"raw": {}, "int4+int8": dict(quant="int4", kv_quant="int8")}


def _tensors(tree):
    """Every tensor of a nested tuple / dict / KVQuant, in a fixed order."""
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, KVQuant):
        yield tree.q
        yield tree.s
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif isinstance(tree, tuple):
        for leaf in tree:
            yield from _tensors(leaf)


def _clone(tree):
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, KVQuant):
        return KVQuant(tree.q.clone(), tree.s.clone())
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [_clone(v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def _graph_case(card, kind, engine, pages=None):
    """Static buffers of one launch kind on a 4-slot fleet at the tiny
    model's widths, and the launch body over them: slots 0-2 armed at
    positions 40, 57 and 90 (greedy, then sampled with penalties) over
    random K/V; the mixed launches carry their decode rows and, arming,
    slot 3's 12-token prompt landing whole. pages: the slots' adapter
    pages ([4] int32 on the card, a static input of the paged kinds), or
    None. Returns (buffers, run(buffers, generator) -> packed)."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.models import api as M

    cfg, be = engine.cfg, engine.backend
    B, V, S, bs, K, W, tile = 4, cfg.vocab_size, 128, 16, 4, 48, 8
    g = torch.Generator(device=card).manual_seed(2)
    dense = kind == "dense_chunk"
    cache = (M.init_kv_cache(cfg, B, max_seq=S, device=card) if dense
             else P.init_pool(cfg, B * (S // bs) + 1, bs, device=card))
    for leaf in _tensors(cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=card))
        elif leaf.dim() == 4:  # int8 scales
            leaf.copy_(torch.rand(leaf.shape, generator=g, device=card) / 64)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=card))
    table = None if dense else (torch.randperm(B * (S // bs), generator=g, device=card)
                                + 1).reshape(B, S // bs).to(torch.int32)
    state, sparams = G.init_slots(B, V, device=card)
    none = torch.zeros(V, dtype=torch.bool, device=card)
    for b, p in enumerate((40, 57, 90)):
        knobs = ((1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0) if b % 2 == 0
                 else (0.8, 20, 0.95, False, 0.05, 1.1, 0.2, 0.1))
        state, sparams = P.arm_slot_only(cfg, state, sparams, b, 10 + b, p, 12, *knobs,
                                         none)
    bufs = {"cache": cache, "table": table, "state": state, "sparams": sparams}
    if pages is not None:
        bufs["pages"] = pages
    if not kind.startswith("mixed"):
        def run(b, gen):
            return graphs.decode_chunk(be, b["state"], b["sparams"], b["cache"],
                                       b["table"], gen, K, pages=b.get("pages"))
        return bufs, run
    arming = kind == "mixed_arming"
    entries = [(b, 0, 1, P.RAGGED_DECODE) for b in range(3)]
    if arming:
        entries.append((3, 0, 12, P.RAGGED_PREFILL))
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W, tile=tile)
    dev = P.build_device_meta(entries, offsets, 3, width=W, tile=tile)
    toks = np.zeros(W, np.int32)
    dec_flag = np.zeros(W, bool)
    dec_idx = np.zeros(B, np.int32)
    for b, off in zip(range(3), offsets):
        dec_flag[off] = True
        dec_idx[b] = off
    inp = graphs.mixed_inputs(W, tile, B, V, device=card)
    if arming:
        toks[offsets[3]: offsets[3] + 12] = np.arange(30, 42)
        arm = inp.arm
        arm.on[3], arm.idx[3], arm.prompt_len[3], arm.max_tokens[3] = (
            True, offsets[3] + 11, 12, 9)
        for field, value in zip(arm.params, (0.7, 10, 0.9, False, 0.05, 1.2, 0.0, 0.0)):
            field[3] = value
        arm.presence[3, 30:42] = True
    for dst, a in zip((inp.tokens, inp.tok_row, inp.tok_pos, inp.dec_flag, inp.meta,
                       inp.dec_idx, *inp.dev),
                      (toks, tok_row, tok_pos, dec_flag, meta, dec_idx, *dev)):
        dst.copy_(torch.from_numpy(a))
    bufs["inputs"] = inp

    def run(b, gen):
        return graphs.mixed_launch(be, b["inputs"], b["cache"], b["table"], b["state"],
                                   b["sparams"], gen, pages=b.get("pages"))
    return bufs, run


@pytest.mark.parametrize("quant", list(GRAPH_QUANT))
@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_graph_replay_bit_equal_to_eager_and_counts_its_launches(card, kind, quant):
    """Each launch kind captured once and replayed twice: every replay's
    packed result, slot state and pool are bit-equal to the eager body
    on a clone of the buffers with the same generator state (greedy and
    sampled rows), and the kernel counters move by the capture's deltas
    per replay: n_layers paged kernels per decode step, n_layers ragged
    launches per mixed launch. The trash block is left out: colliding
    writes of padding rows land there in any order."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           **GRAPH_QUANT[quant])
    L = engine.cfg.n_layers
    bufs, run = _graph_case(card, kind, engine)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), kind, card, gen)
    lg()  # the warm launch, then the capture
    assert (lg.captures, lg.replays) == (1, 0)
    sfx = "[int8]" if quant != "raw" else ""
    want_deltas = {"decode_chunk": {"paged_flash_attend" + sfx: L * 4},
                   "dense_chunk": {}}.get(kind, {"ragged_paged_attend" + sfx: L})
    for name, n in lg.deltas.items():
        if name != "q4_matmul_rows":
            assert n == want_deltas.get(name, 0), (name, n)
    # int4: the LM head and the 128-wide projections pass the kernel's gate
    assert (lg.deltas["q4_matmul_rows"] > 0) == (quant != "raw")
    for _ in range(2):
        ref = _clone(bufs)
        g2 = torch.Generator(device=card)
        g2.set_state(gen.get_state())
        before = graphs.launch_counts()
        got = lg().clone()
        moved = {k: v - before[k] for k, v in graphs.launch_counts().items()}
        want = run(ref, g2)
        torch.cuda.synchronize()
        assert moved == lg.deltas
        assert torch.equal(got, want)
        for name in ("state", "sparams"):
            for a, b in zip(_tensors(bufs[name]), _tensors(ref[name])):
                assert torch.equal(a, b), name
        for a, b in zip(_tensors(bufs["cache"]), _tensors(ref["cache"])):
            keep = a if kind == "dense_chunk" else a[:, 1:]
            assert torch.equal(keep, b if kind == "dense_chunk" else b[:, 1:]), "cache"
    assert lg.replays == 2
    emitted = got[4:8] if kind.endswith("chunk") else got[1]  # the emit masks
    assert int(emitted.sum()) > 0
    lg.close()


def test_failed_capture_raises_with_its_cause_and_never_returns_eagerly(card):
    """A launch that cannot be captured (a host read of a device value)
    raises GraphCaptureError on every call, naming the launch, with the
    CUDA fault as its cause: no eager result comes back, and the counters
    and the card work on."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    x = torch.ones(8, device=card)

    def body():
        return x * float(x.sum().item())  # the host read no graph can hold

    lg = graphs.LaunchGraph(body, "test launch", card, torch.Generator(device=card))
    before = graphs.launch_counts()
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError, match="test launch") as err:
            lg()
        assert err.value.__cause__ is not None
    assert (lg.graph, lg.captures, lg.replays) == (None, 0, 0)
    assert graphs.launch_counts() == before
    assert float((x * 2).sum()) == 16.0


def test_fleet_serves_through_one_graph_per_launch_kind(card):
    """The chunked paged fleet on the card: one capture per launch kind,
    every later launch a replay, every kernel launch counted once per
    layer (and step), and the greedy tokens of the CPU fleet on the same
    fp32 weights."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    cpu = create_engine("test-llama-tiny", seed=3, device="cpu")
    moved = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(card)) for k, v in cpu.backend.params.items()}
    gpu = create_engine(cpu.cfg, params=moved, attn_impl="auto", device=card)
    prompts = ["The quick brown fox jumps over it, twice.", "a b c",
               " ".join(f"w{i}" for i in range(30))]
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu)):
        fleet = ContinuousEngine(engine, n_slots=2, chunk_steps=4, kv_pool_blocks=40,
                                 slot_max_seq=128)
        counts = (pa.ragged_paged_attend.launches, pa.paged_flash_attend.launches)
        try:
            rs = [fleet.submit(p, max_tokens=10, greedy=True, chat=False) for p in prompts]
            st = fleet.stats()
        finally:
            fleet.close()
        after = (pa.ragged_paged_attend.launches, pa.paged_flash_attend.launches)
        out[name] = ([r["token_ids"] for r in rs], st,
                     [b - a for a, b in zip(counts, after)])
    tokens, st, launched = out["card"]
    assert tokens == out["cpu"][0]
    L, launches, g = cpu.cfg.n_layers, st["launches"], st["graphs"]
    assert g["decode_chunk"]["captures"] == g["mixed_launch"]["captures"] == 1
    assert g["mixed_launch"]["replays"] == launches["mixed"] - 1 >= 1
    assert g["decode_chunk"]["replays"] == launches["decode_chunks"] - 1 >= 1
    assert launched == [L * launches["mixed"], L * 4 * launches["decode_chunks"]]


# -- the KV shadow's movers on the card (engine/shadow.py, engine/paged.py) -------

def _upload(card, a):
    """A host array to the card as the fleet uploads it: pinned, non_blocking."""
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(card, non_blocking=True)


@pytest.mark.parametrize("quant", list(GRAPH_QUANT))
def test_shadow_restore_in_place_is_read_by_a_replayed_mixed_launch(card, quant):
    """Blocks captured through the shadow store (bf16 through its int16
    carrier) and scattered back with restore_shadow_blocks land in the
    static pool IN PLACE: the mixed launch captured before the restore
    replays over the restored bytes, bit-equal to the eager body on a clone
    of the restored buffers, and the pool keeps its storage."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           dtype="bfloat16", **GRAPH_QUANT[quant])
    bufs, run = _graph_case(card, "mixed_arming", engine)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), "mixed_arming", card, gen)
    lg()  # the warm launch, then the capture
    pool = bufs["cache"]
    ptrs = [t.data_ptr() for t in P.pool_leaves(pool)]
    # another pool's blocks through the store, into slot 0's head blocks
    donor = _clone(pool)
    for leaf in P.pool_leaves(donor):
        leaf.copy_(leaf.flip(1))
    src = [int(b) for b in bufs["table"][1, :3].tolist()]
    dst = [int(b) for b in bufs["table"][0, :3].tolist()]
    store = ShadowStore(16, max_blocks=8)
    try:
        keys = [tuple(range(16 * (i + 1))) for i in range(3)]
        dev = P.gather_shadow_blocks(donor, _upload(card, np.asarray(src, np.int32)))
        assert store.put_async(keys, P.pool_leaves(dev), 0) and store.flush(10.0)
        entries = store.entries_for(keys)
    finally:
        store.close()
    stacked = []
    for j, like in enumerate(P.pool_leaves(pool)):
        t = torch.from_numpy(np.stack([e.leaves[j] for e in entries]))
        if like.dtype == torch.bfloat16:
            assert t.dtype == torch.int16
            t = t.view(torch.bfloat16)
        stacked.append(t.pin_memory().to(card, non_blocking=True))
    P.restore_shadow_blocks(pool, P.pool_from_leaves(pool, stacked),
                            _upload(card, np.asarray(dst, np.int32)))
    for a, b in zip(P.pool_leaves(pool), P.pool_leaves(donor)):
        assert torch.equal(a[:, dst], b[:, src])
    assert [t.data_ptr() for t in P.pool_leaves(pool)] == ptrs
    ref = _clone(bufs)
    g2 = torch.Generator(device=card)
    g2.set_state(gen.get_state())
    got = lg().clone()
    want = run(ref, g2)
    torch.cuda.synchronize()
    assert lg.replays == 1 and torch.equal(got, want)
    for a, b in zip(_tensors(bufs["state"]), _tensors(ref["state"])):
        assert torch.equal(a, b)
    lg.close()


def test_shadow_capture_after_a_mixed_launch_syncs_no_host(card):
    """One replayed mixed launch, then the capture it triggers (the block
    gather, put_async's copy into pinned memory behind an event) under
    torch.cuda.set_sync_debug_mode("error"): no host sync on the calling
    thread; the copier thread lands the blocks' exact bytes."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           dtype="bfloat16")
    bufs, run = _graph_case(card, "mixed_arming", engine)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), "mixed_arming", card, gen)
    lg()
    store = ShadowStore(16, max_blocks=16)
    blocks = [int(b) for b in bufs["table"][3, :2].tolist()] * 4  # 8 rows, padded
    keys = [(1,) * 16, (1,) * 32]
    try:
        store.put_async([(0,) * 16], P.pool_leaves(P.gather_shadow_blocks(
            bufs["cache"], _upload(card, np.asarray(blocks, np.int32)))), 0)
        assert store.flush(10.0)  # the pinned allocator warmed
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lg()
            ids = _upload(card, np.asarray(blocks, np.int32))
            dev = P.gather_shadow_blocks(bufs["cache"], ids)
            assert store.put_async(keys, P.pool_leaves(dev), 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert store.flush(10.0)
        entries = store.entries_for(keys)
    finally:
        store.close()
    torch.cuda.synchronize()
    for j, leaf in enumerate(P.pool_leaves(bufs["cache"])):
        for e, b in zip(entries, blocks[:2]):
            host = torch.from_numpy(e.leaves[j])
            if leaf.dtype == torch.bfloat16:
                host = host.view(torch.bfloat16)
            assert torch.equal(host, leaf[:, b].cpu())
    lg.close()


# -- the KV fabric on the card (serving/kv_fabric.py) ---------------------------

@pytest.mark.parametrize("quant", list(GRAPH_QUANT))
def test_fabric_import_in_place_is_read_by_a_replayed_mixed_launch(card, quant):
    """Blocks of another pool through the fabric's wire (encode_chain,
    decode_chain with the content-key recheck and the pool's leaf layout;
    bf16 as its int16 carrier) and scattered into the static pool in place:
    the mixed launch captured before the import replays over the imported
    bytes, bit-equal to the eager body on a clone of the buffers, and the
    pool keeps its storage."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore
    from distributed_llm_inference_tpu_torch.serving import kv_fabric as kvf

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           dtype="bfloat16", **GRAPH_QUANT[quant])
    bufs, run = _graph_case(card, "mixed_arming", engine)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), "mixed_arming", card, gen)
    lg()  # the warm launch, then the capture
    pool = bufs["cache"]
    ptrs = [t.data_ptr() for t in P.pool_leaves(pool)]
    donor = _clone(pool)
    for leaf in P.pool_leaves(donor):
        leaf.copy_(leaf.flip(1))
    src = [int(b) for b in bufs["table"][1, :3].tolist()]
    dst = [int(b) for b in bufs["table"][0, :3].tolist()]
    ids = list(range(1, 49))
    keys = [tuple(ids[: 16 * (i + 1)]) for i in range(3)]
    store = ShadowStore(16, max_blocks=8)
    try:
        dev = P.gather_shadow_blocks(donor, _upload(card, np.asarray(src, np.int32)))
        assert store.put_async(keys, P.pool_leaves(dev), 0) and store.flush(10.0)
        blob = kvf.serve_chain(store, store.digest_of(keys[-1]))
    finally:
        store.close()
    layout = [(np.dtype(np.int16) if t.dtype == torch.bfloat16
               else torch.empty((), dtype=t.dtype).numpy().dtype, (t.shape[0], *t.shape[2:]))
              for t in P.pool_leaves(pool)]
    got_keys, per_block = kvf.decode_chain(blob, 16, kvf.chain_digest(ids, 16))
    assert got_keys == keys
    stacked = []
    for j, like in enumerate(P.pool_leaves(pool)):
        for leaves in per_block:
            kvf.check_layout(leaves, layout)
        t = torch.from_numpy(np.stack([leaves[j] for leaves in per_block]))
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        stacked.append(t.pin_memory().to(card, non_blocking=True))
    P.restore_shadow_blocks(pool, P.pool_from_leaves(pool, stacked),
                            _upload(card, np.asarray(dst, np.int32)))
    for a, b in zip(P.pool_leaves(pool), P.pool_leaves(donor)):
        assert torch.equal(a[:, dst], b[:, src])
    assert [t.data_ptr() for t in P.pool_leaves(pool)] == ptrs
    ref = _clone(bufs)
    g2 = torch.Generator(device=card)
    g2.set_state(gen.get_state())
    got = lg().clone()
    want = run(ref, g2)
    torch.cuda.synchronize()
    assert lg.replays == 1 and torch.equal(got, want)
    for a, b in zip(_tensors(bufs["state"]), _tensors(ref["state"])):
        assert torch.equal(a, b)
    lg.close()


def test_fabric_remote_hit_imports_a_bf16_chain_bit_exact(card):
    """Two bf16 fleets on the card over HTTP: the puller's remote hit
    imports the holder's chain (bf16 carried as int16 on the wire) with
    its bytes bit-exact in the puller's pool, each graph captured once, and
    the cold run's greedy tokens."""
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    prompt = "shared fabric preamble " * 4 + "tail one"
    gen = dict(max_tokens=10, greedy=True, chat=False)
    base = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                         dtype="bfloat16")

    def replica(prefix):
        eng = create_engine(base.cfg, params=base.backend.params, device=card,
                            engine_cfg=EngineConfig(prefix_cache_entries=prefix))
        fleet = ContinuousEngine(eng, n_slots=2, chunk_steps=4, kv_pool_blocks=48,
                                 slot_max_seq=128)
        srv = InferenceServer(eng, "127.0.0.1", 0, max_tokens_cap=64, continuous=fleet)
        srv.start()
        return fleet, srv

    def head_bytes(fleet, ids):
        p0, blocks, _ = fleet._bpx.lookup(ids)
        idx = torch.tensor(blocks, device=card)
        return p0, [leaf[:, idx].cpu() for leaf in P.pool_leaves(fleet.cache)]

    (hold, hsrv), (pull, psrv), (cold, csrv) = replica(8), replica(8), replica(0)
    try:
        r = hold.submit(prompt, **gen, prefill_only=True)
        want = cold.submit(prompt, **gen)
        got = pull.submit(prompt, **gen, kv_hint={
            "peer": f"http://127.0.0.1:{hsrv.port}", "digest": r["kv_digests"][-1]})
        ids = base.tokenizer.encode(prompt)
        (hp0, hb), (pp0, pb) = head_bytes(hold, ids), head_bytes(pull, ids)
        graphs = pull.stats()["graphs"]
    finally:
        for srv in (hsrv, psrv, csrv):
            srv.shutdown()
    assert got["kv_fabric_blocks"] == 6 and got["token_ids"] == want["token_ids"]
    assert hp0 == pp0 == 96 and hb[0].dtype == torch.bfloat16
    for a, b in zip(hb, pb):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert all(g["captures"] == 1 for g in graphs.values())


# -- speculation on the mixed launch (engine/paged.py, engine/graphs.py) ----------

def _verify_launch(card, width, pos):
    """A mixed launch's plan at tinyllama's widths with verify rows whose
    q_start derives on the device (apply_device_meta): rows 0 and 1 plain
    decode, row 2 a K = 4 verify row (one tile), row 3 a K = 8 one (two
    tiles, tile_off 8 on the second), row 4 a 21-token prompt chunk at 300.
    Returns the applied meta [G, 4]."""
    from distributed_llm_inference_tpu_torch.engine import paged as P

    entries = [(0, 0, 1, P.RAGGED_DECODE), (1, 0, 1, P.RAGGED_DECODE),
               (2, 0, 5, P.RAGGED_PREFILL), (3, 0, 9, P.RAGGED_PREFILL),
               (4, 300, 21, P.RAGGED_PREFILL)]
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=width, tile=8)
    dev = P.build_device_meta(entries, offsets, 4, width=width, tile=8)
    tdev = P.DeviceMeta(*(torch.from_numpy(a).to(card) for a in dev))
    m, _ = P.apply_device_meta(torch.from_numpy(meta).to(card),
                               torch.from_numpy(tok_row).to(card),
                               torch.from_numpy(tok_pos).to(card), tdev, pos)
    return m


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ragged_kernel_matches_twin_on_verify_rows(card, dtype, int8):
    """Verify rows are prefill-kind tiles whose q_start comes from the slot
    state on the device, shorter than a tile (K = 4) and spanning two
    (K = 8), beside decode rows and a prompt chunk: within atol of the
    twin, the same bits on a repeat, exact zeros past each tile's q_len."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(41)
    H, KV, Dh, bs, MB, tq = 32, 4, 64, 16, 64, 8
    pk, pv, table = _pool_case(card, torch.float32, g, N=6 * MB + 1, KV=KV, bs=bs,
                               Dh=Dh, R=6, MB=MB)
    pk, pv = (_int8(pk), _int8(pv)) if int8 else (pk.to(dt), pv.to(dt))
    for pos in ([17, 1023, 15, 700, 0, 0], [0, 64, 1018, 1007, 0, 0]):
        m = _verify_launch(card, 64, torch.tensor(pos, dtype=torch.int32, device=card))
        assert m[2, 1].item() == pos[2] and m[4, 1].item() == pos[3] + 8
        q = torch.randn(m.shape[0] * tq, H, Dh, generator=g, device=card).to(dt)
        got = pa.ragged_paged_attend(q, pk, pv, table, m)
        again = pa.ragged_paged_attend(q, pk, pv, table, m)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want = pa.ragged_paged_attend_plain(q, pk, pv, table, m)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], (pos, err)
        assert not got[_dead_rows(m.tolist(), tq)].any()


def test_paged_decode_kernel_matches_twin_on_the_draft_pool(card):
    """The draft chain's T=1 steps over a second pool through the same block
    tables: each step's attention within atol of the twin."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=card).manual_seed(42)
    H, KV, Dh, bs, MB = 32, 4, 64, 16, 64
    for dt in (torch.float32, torch.bfloat16):
        dk, dv, table = _pool_case(card, dt, g, N=8 * MB + 1, KV=KV, bs=bs, Dh=Dh,
                                   R=8, MB=MB)
        pos = torch.tensor([3, 15, 16, 300, 511, 700, 1000, 1023], dtype=torch.int32,
                           device=card)
        for step in range(5):  # a K = 4 chain: 5 steps from each row's frontier
            q = torch.randn(8, 1, H, Dh, generator=g, device=card).to(dt)
            got = pa.paged_flash_attend(q, dk, dv, table, torch.clamp(pos + step, max=1023))
            want = pa.paged_flash_attend_plain(q, dk, dv, table,
                                               torch.clamp(pos + step, max=1023))
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL["float32" if dt == torch.float32 else "bfloat16"], err


SPEC_GRAPH_KINDS = ["mixed_spec", "mixed_spec_draft", "draft_fill", "draft_propose"]


def _spec_graph_case(card, kind, engine):
    """The static buffers of a speculating fleet (K = 8) over _graph_case's
    armed slots: slot 0 a verify row of 4 n-gram drafts, slot 1 a plain
    decode row, slot 2 a verify row of 8 (two tiles), slot 3's prompt
    landing and arming; a draft pool of random K/V and a 2-layer draft at
    the tiny model's widths. Returns (buffers, run)."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.models import api as M

    bufs, _ = _graph_case(card, "mixed_arming", engine)
    cfg, be = engine.cfg, engine.backend
    B, K, W, tile = 4, 8, 48, 8
    g = torch.Generator(device=card).manual_seed(5)
    entries = [(0, 0, 5, P.RAGGED_PREFILL), (1, 0, 1, P.RAGGED_DECODE),
               (2, 0, 9, P.RAGGED_PREFILL), (3, 0, 12, P.RAGGED_PREFILL)]
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W, tile=tile)
    dev = P.build_device_meta(entries, offsets, 3, width=W, tile=tile)
    toks = np.zeros(W, np.int32)
    dec_flag = np.zeros(W, bool)
    dec_idx = np.zeros(B, np.int32)
    spec = graphs.spec_inputs(B, K, device=card)
    for b, nd in ((0, 4), (1, 0), (2, 8)):
        off = offsets[b]
        dec_flag[off] = True
        if nd:
            spec.plan.dec_on[b], spec.plan.on[b], spec.plan.n_draft[b] = False, True, nd
            idxs = off + np.arange(K + 1)
            idxs[nd + 1:] = off + nd
            spec.plan.idx[b] = torch.from_numpy(idxs)
            toks[off + 1: off + 1 + nd] = np.arange(50, 50 + nd)
        else:
            dec_idx[b] = off
    toks[offsets[3]: offsets[3] + 12] = np.arange(30, 42)
    spec.toks.copy_(torch.randint(3, cfg.vocab_size, (B, K), generator=g, device=card))
    inp = bufs["inputs"]
    for dst, a in zip((inp.tokens, inp.tok_row, inp.tok_pos, inp.dec_flag, inp.meta,
                       inp.dec_idx, *inp.dev),
                      (toks, tok_row, tok_pos, dec_flag, meta, dec_idx, *dev)):
        dst.copy_(torch.from_numpy(a))
    dcfg = cfg.replace(n_layers=2, quant=None)  # int8 KV stays on the draft pool
    dparams = M.init_params(dcfg, torch.Generator(device=card).manual_seed(1))
    dpool = P.init_pool(dcfg, int(bufs["table"].max()) + 1, 16, device=card)
    for leaf in _tensors(dpool):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=card))
        elif leaf.dim() == 4:
            leaf.copy_(torch.rand(leaf.shape, generator=g, device=card) / 64)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=card))
    bufs.update(spec=spec, dpool=dpool)

    def run(b, gen):
        if kind == "draft_fill":
            graphs.draft_fill(dcfg, dparams, b["inputs"], b["dpool"], b["table"],
                              b["state"])
            return b["dpool"]["v"] if isinstance(b["dpool"]["v"], torch.Tensor) \
                else b["dpool"]["v"].q
        if kind == "draft_propose":
            return graphs.draft_propose(dcfg, dparams, b["state"], b["dpool"], b["table"],
                                        b["spec"].toks)
        return graphs.mixed_spec_launch(be, b["inputs"], b["spec"], b["cache"], b["table"],
                                        b["state"], b["sparams"], gen,
                                        draft_toks=kind == "mixed_spec_draft")
    return bufs, run


@pytest.mark.parametrize("quant", list(GRAPH_QUANT))
@pytest.mark.parametrize("kind", SPEC_GRAPH_KINDS)
def test_spec_graph_replay_bit_equal_to_eager(card, kind, quant):
    """The speculation launch kinds captured once and replayed twice: each
    replay's result, slot state, knobs, pool and draft pool bit-equal to the
    eager body on a clone with the same generator state; the counters move
    by the capture's deltas: n_layers ragged launches per verify launch and
    per draft fill, n_draft_layers x (K + 1) paged decode launches per
    propose chain."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           **GRAPH_QUANT[quant])
    L = engine.cfg.n_layers
    bufs, run = _spec_graph_case(card, kind, engine)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), kind, card, gen)
    lg()
    assert (lg.captures, lg.replays) == (1, 0)
    sfx = "[int8]" if quant != "raw" else ""
    want_deltas = {"draft_fill": {"ragged_paged_attend" + sfx: 2},
                   "draft_propose": {"paged_flash_attend" + sfx: 2 * 9}}.get(
        kind, {"ragged_paged_attend" + sfx: L})
    for name, n in lg.deltas.items():
        if name != "q4_matmul_rows":
            assert n == want_deltas.get(name, 0), (name, n)
    for _ in range(2):
        ref = _clone(bufs)
        g2 = torch.Generator(device=card)
        g2.set_state(gen.get_state())
        before = graphs.launch_counts()
        got = lg().clone()
        moved = {k: v - before[k] for k, v in graphs.launch_counts().items()}
        want = run(ref, g2)
        torch.cuda.synchronize()
        assert moved == lg.deltas
        assert torch.equal(got if kind != "draft_fill" else got[:, 1:],
                           want if kind != "draft_fill" else want[:, 1:])
        for name in ("state", "sparams", "spec"):
            for a, b in zip(_tensors(bufs[name]), _tensors(ref[name])):
                assert torch.equal(a, b), name
        for name in ("cache", "dpool"):
            for a, b in zip(_tensors(bufs[name]), _tensors(ref[name])):
                assert torch.equal(a[:, 1:], b[:, 1:]), name
    if kind.startswith("mixed_spec"):
        assert got.shape == (5 + 2 * 9 + 1, 4)
        assert got[5 + 9: 5 + 18, 0].sum() >= 1 and got[5 + 9: 5 + 18, 2].sum() >= 1
    lg.close()


@pytest.mark.parametrize("mode", ["devmeta", "legacy", "draft_model"])
def test_spec_fleet_serves_through_one_graph_per_kind(card, mode):
    """The speculating fleet on the card (fp32 weights of the CPU fleet):
    the plain CPU fleet's greedy tokens, verify rows launched, each kind
    captured once and every later launch a replay."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    cpu = create_engine("test-llama-tiny", seed=3, device="cpu")
    moved = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(card)) for k, v in cpu.backend.params.items()}
    spec = dict(spec_decode=True, spec_device_meta=mode != "legacy",
                spec_draft_model="test-llama-tiny" if mode == "draft_model" else None)
    gpu = create_engine(cpu.cfg, params=moved, attn_impl="auto", device=card,
                        engine_cfg=EngineConfig(**spec))
    if mode == "draft_model":
        gpu.set_draft(gpu.cfg, moved)
    prompts = ["the cat sat on the mat " * 4, "a b c", "abc xyz " * 6]
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu)):
        fleet = ContinuousEngine(engine, n_slots=2, chunk_steps=4, kv_pool_blocks=40,
                                 slot_max_seq=128)
        try:
            rs = [fleet.submit(p, max_tokens=16, greedy=True, chat=False) for p in prompts]
            st = fleet.stats()
        finally:
            fleet.close()
        out[name] = ([r["token_ids"] for r in rs], st)
    tokens, st = out["card"]
    assert tokens == out["cpu"][0]
    assert st["speculative"]["launches"] > 0
    kinds = {"decode_chunk", "mixed_launch", "mixed_spec"} | (
        {"draft_fill", "draft_propose"} if mode == "draft_model" else set())
    assert set(st["graphs"]) == kinds
    g, launches = st["graphs"], st["launches"]
    for kind in kinds - {"decode_chunk"}:
        assert g[kind]["captures"] == 1 and g[kind]["replays"] >= 1, (kind, g)
    # a draft-model fleet may speculate to the end of every request
    chunks = launches["decode_chunks"]
    assert g["decode_chunk"] == {"captures": min(1, chunks), "replays": max(0, chunks - 1)}
    assert g["mixed_launch"]["replays"] + g["mixed_spec"]["replays"] == launches["mixed"] - 2


# -- token streaming and cancellation on the card (engine/continuous.py) -----------

def _stream_fleets(card):
    """(CPU fleet, card fleet) over the same fp32 weights."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    cpu = create_engine("test-llama-tiny", seed=3, device="cpu")
    moved = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(card)) for k, v in cpu.backend.params.items()}
    gpu = create_engine(cpu.cfg, params=moved, attn_impl="auto", device=card)
    return [ContinuousEngine(e, n_slots=2, chunk_steps=4, kv_pool_blocks=40,
                             slot_max_seq=128) for e in (cpu, gpu)]


def test_stream_deltas_on_the_card_join_to_the_cpu_fleets_response(card):
    """A streamed request on the card: the deltas join to its response,
    its ids are the CPU fleet's, the kernels launched once per layer (and
    step), and the streamed run replays the graphs the plain run captured."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    prompt = "The quick brown fox jumps over it, twice."
    cpu, gpu = _stream_fleets(card)
    try:
        want = cpu.submit(prompt, max_tokens=24, greedy=True, chat=False)["token_ids"]
        plain = gpu.submit(prompt, max_tokens=24, greedy=True, chat=False)
        before = gpu.stats()["launches"]
        counts = (pa.ragged_paged_attend.launches, pa.paged_flash_attend.launches)
        events = list(gpu.stream(prompt, max_tokens=24, greedy=True, chat=False))
        after = gpu.stats()
    finally:
        cpu.close()
        gpu.close()
    *deltas, final = events
    assert final["done"] is True and final["status"] == "success"
    assert "".join(e["delta"] for e in deltas) == final["response"] == plain["response"]
    assert final["token_ids"] == plain["token_ids"] == want
    mixed = after["launches"]["mixed"] - before["mixed"]
    chunks = after["launches"]["decode_chunks"] - before["decode_chunks"]
    L = gpu.cfg.n_layers
    assert [pa.ragged_paged_attend.launches - counts[0],
            pa.paged_flash_attend.launches - counts[1]] == [L * mixed, L * 4 * chunks]
    assert all(g["captures"] == 1 for g in after["graphs"].values())


def test_mid_stream_cancel_on_the_card_frees_the_slot_for_the_next(card):
    """Closing a stream after its first delta frees the slot and every
    block within a scheduler step; the request admitted next gets its ids
    of a run alone, and no launch kind is captured again."""
    prompt, nxt = "a b c d e f", "The next request, alone."
    cpu, gpu = _stream_fleets(card)
    try:
        want = cpu.submit(nxt, max_tokens=16, greedy=True, chat=False)["token_ids"]
        gen = gpu.stream(prompt, max_tokens=100, greedy=True, chat=False)
        assert "delta" in next(gen)
        gen.close()
        import time

        t0 = time.time()
        while gpu.stats()["occupied"]:
            assert time.time() - t0 < 10, "the cancelled slot never freed"
            time.sleep(0.001)
        st = gpu.stats()
        assert st["paged"]["free_blocks"] == 39
        assert gpu.engine.metrics.get("dli_cancelled_total").labels(
            cause="disconnect").value == 1
        got = gpu.submit(nxt, max_tokens=16, greedy=True, chat=False)["token_ids"]
        graphs = gpu.stats()["graphs"]
    finally:
        cpu.close()
        gpu.close()
    assert got == want
    assert all(g["captures"] == 1 for g in graphs.values())


# -- runtime LoRA adapters (engine/adapters.py) on the card ----------------------


@pytest.mark.parametrize("quant", list(GRAPH_QUANT))
@pytest.mark.parametrize("kind", ["mixed_arming", "decode_chunk"])
def test_adapter_page_loaded_after_capture_is_read_by_the_replay(card, kind, quant):
    """A launch kind captured while every adapter page is the all-zero base
    (the rows on pages 1 and 2 compute the base), then two adapters loaded
    into pages 1 and 2 IN PLACE (AdapterPool.acquire -> write_adapter_page,
    pinned and non_blocking on the launch stream) and the pages input
    rewritten in place: the replay, under the sync check, is bit-equal to
    the eager body on a clone of the buffers, and its K/V differ from a
    base-only launch's on the adapter rows (the replay read the pages).
    The lora leaves keep their storage."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine import adapters as A
    from distributed_llm_inference_tpu_torch.engine import graphs

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card,
                           dtype="bfloat16", **GRAPH_QUANT[quant],
                           engine_cfg=EngineConfig(adapter_slots=2, adapter_rank=4))
    cfg, pool = engine.cfg, engine.adapters
    rng = np.random.default_rng(7)
    for name in ("x", "y"):
        pool.register(name, {
            leaf: ((rng.standard_normal((cfg.n_layers, i, 4)) * 0.3).astype(np.float32),
                   (rng.standard_normal((cfg.n_layers, 4, o)) * 0.3).astype(np.float32))
            for leaf, (i, o) in A.adapter_leaf_dims(cfg).items()})
    pages = torch.tensor([1, 0, 2, 1], dtype=torch.int32, device=card)
    bufs, run = _graph_case(card, kind, engine, pages=pages)
    start = _clone(bufs)
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), kind, card, gen)
    lg()  # the warm launch, then the capture, on the all-zero pages
    leaves = {k: v.data_ptr() for k, v in engine.backend.params["layers"].items()
              if k.startswith("lora_")}
    px, py = pool.acquire("x"), pool.acquire("y")
    pages.copy_(torch.tensor([px, 0, py, px], dtype=torch.int32))
    assert {k: v.data_ptr() for k, v in engine.backend.params["layers"].items()
            if k.startswith("lora_")} == leaves
    graphs.commit((bufs["state"], bufs["sparams"]), (start["state"], start["sparams"]))
    for a, b in zip(_tensors(bufs["cache"]), _tensors(start["cache"])):
        a.copy_(b)
    ref, base = _clone(bufs), _clone(bufs)
    base["pages"].zero_()
    g2, g3 = torch.Generator(device=card), torch.Generator(device=card)
    g2.set_state(gen.get_state())
    g3.set_state(gen.get_state())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lg().clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = run(ref, g2)
    run(base, g3)
    torch.cuda.synchronize()
    assert lg.replays == 1 and torch.equal(got, want)
    for a, b in zip(_tensors(bufs["state"]), _tensors(ref["state"])):
        assert torch.equal(a, b)
    moved = False
    for a, b, c in zip(_tensors(bufs["cache"]), _tensors(ref["cache"]),
                       _tensors(base["cache"])):
        assert torch.equal(a[:, 1:], b[:, 1:])
        moved = moved or not torch.equal(a[:, 1:], c[:, 1:])
    assert moved, "the replay's K/V equal a base-only launch's"
    lg.close()


# -- grammar constraints: the dense fleet's constrained chunk (constrain/) -------


def _constrained_chunk_run(engine):
    from distributed_llm_inference_tpu_torch.engine import graphs

    def run(b, gen):
        return graphs.decode_chunk_constrained(
            engine.backend, b["state"], b["sparams"], b["cache"], b["fsm"], b["cmask"],
            b["ctrans"], gen, 4)
    return run


def test_constrained_chunk_replay_bit_equal_to_eager_across_a_table_rewrite(card):
    """The dense fleet's constrained decode chunk captured over the static
    FSM vector and one bucket's views of the fleet table (two constraints
    resident, slots 0 and 2 constrained, slot 1 free): two replays
    bit-equal to the eager body on a clone of the buffers (packed result,
    slot state, FSM states, cache). Then a third constraint acquired in
    the same bucket writes its rows IN PLACE and slot 1 moves onto it: the
    replay under the sync check is bit-equal to eager again, the tables
    keep their storage, and every constrained row emitted only tokens its
    table allows."""
    from distributed_llm_inference_tpu_torch.constrain import FleetConstraintTable
    from distributed_llm_inference_tpu_torch.engine import graphs

    engine = create_engine("test-llama-tiny", attn_impl="auto", seed=3, device=card)
    bufs, _ = _graph_case(card, "dense_chunk", engine)
    run = _constrained_chunk_run(engine)
    table = FleetConstraintTable(engine.cfg.vocab_size, max_states=64)
    arts = [engine._compile_constraint(s) for s in (
        {"regex": "[0-9]{3}-[0-9]{4}"}, {"choices": ["alpha", "beta", "gamma"]},
        {"regex": "[a-f]{2,5}"})]
    offs = [table.acquire(a) for a in arts[:2]]
    cm, ct = table.device_tables(card)
    bucket = cm.shape[0]
    bufs.update(cmask=cm, ctrans=ct, fsm=torch.tensor(
        [offs[0] + arts[0].start, 0, offs[1] + arts[1].start, 0], dtype=torch.int32,
        device=card))
    ptrs = (cm.data_ptr(), ct.data_ptr())
    gen = torch.Generator(device=card).manual_seed(11)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), "decode_chunk_constrained", card, gen)
    lg()

    def replay_vs_eager(sync_check):
        ref = _clone({k: v for k, v in bufs.items() if k not in ("cmask", "ctrans")})
        ref.update(cmask=bufs["cmask"], ctrans=bufs["ctrans"])
        g2 = torch.Generator(device=card)
        g2.set_state(gen.get_state())
        fsm_before = bufs["fsm"].clone()
        torch.cuda.synchronize()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = lg().clone()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = run(ref, g2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for name in ("state", "sparams"):
            for a, b in zip(_tensors(bufs[name]), _tensors(ref[name])):
                assert torch.equal(a, b), name
        assert torch.equal(bufs["fsm"], ref["fsm"])
        for a, b in zip(_tensors(bufs["cache"]), _tensors(ref["cache"])):
            assert torch.equal(a, b)
        # every emitted token of a constrained row is allowed by its state
        em, mask = got[:4].cpu().numpy(), got[4:8].cpu().numpy().astype(bool)
        mnp, tnp = (t.cpu().numpy() for t in table.device_tables(card))
        st = fsm_before.cpu().numpy()
        for k in range(4):
            for b in range(4):
                if mask[k, b]:
                    assert mnp[st[b], em[k, b]], (k, b, st[b], em[k, b])
                    st[b] = tnp[st[b], em[k, b]]
        np_fsm = bufs["fsm"].cpu().numpy()
        assert (np_fsm == st).all()
        return got

    for _ in range(2):
        replay_vs_eager(False)
    off_c = table.acquire(arts[2])  # a third constraint, the same bucket
    cm2, ct2 = table.device_tables(card)
    assert cm2.shape[0] == bucket and (cm2.data_ptr(), ct2.data_ptr()) == ptrs
    mnp = cm2.cpu().numpy()
    assert (mnp[off_c:off_c + arts[2].num_states] == arts[2].mask).all()
    # slot 1 re-armed greedy with a fresh budget at position 70, on the new rows
    from distributed_llm_inference_tpu_torch.engine import paged as P

    st, sp = P.arm_slot_only(engine.cfg, bufs["state"], bufs["sparams"], 1, 11, 70, 12,
                             1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0,
                             torch.zeros(engine.cfg.vocab_size, dtype=torch.bool,
                                         device=card))
    graphs.commit((bufs["state"], bufs["sparams"]), (st, sp))
    bufs["fsm"][1] = off_c + arts[2].start
    got = replay_vs_eager(True)
    assert int(got[4:8, 1].sum()) > 0  # slot 1 decoded under the new rows
    assert (lg.captures, lg.replays) == (1, 3)
    lg.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_token_allowed_greedy_on_cuda_equals_cpu(card, dtype):
    """The grammar mask after bias and penalties, greedy: the card picks
    the CPU's tokens, and only allowed ones (a bf16 row whose one allowed
    token sits far below the max included)."""
    from distributed_llm_inference_tpu_torch.ops import sampling as S

    g = torch.Generator().manual_seed(0)
    B, V = 6, 32000
    logits = (torch.randn(B, V, generator=g) * 4).to(getattr(torch, dtype))
    allowed = torch.rand(B, V, generator=g) < 0.01
    allowed[5] = False
    allowed[5, 123] = True
    logits[5, 123] = -50.0
    presence = torch.rand(B, V, generator=g) < 0.1
    bias = torch.zeros(V)
    bias[:50] = 100.0
    args = (1.0, 0, 1.0, True, 0.0, 1.3, 0.0, 0.0)
    want = S.sample_token(torch.Generator().manual_seed(1), logits, *args,
                          presence=presence, bias=bias, allowed=allowed)
    got = S.sample_token(torch.Generator(device=card).manual_seed(1), logits.to(card),
                         *args, presence=presence.to(card), bias=bias.to(card),
                         allowed=allowed.to(card))
    assert torch.equal(got.cpu(), want)
    assert allowed[torch.arange(B), want].all() and int(want[5]) == 123


def test_dense_fleet_serves_constraints_through_the_constrained_graph(card):
    """The dense fleet on the card with two constrained tenants and a free
    one: the CPU fleet's greedy tokens on the same fp32 weights, the
    constrained chunk captured once per bucket and replayed for the rest
    of its launches, the plain chunk back once no tenant is constrained."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    cpu = create_engine("test-llama-tiny", seed=3, device="cpu")
    moved = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(card)) for k, v in cpu.backend.params.items()}
    gpu = create_engine(cpu.cfg, params=moved, attn_impl="auto", device=card)
    reqs = [("pick a color:", {"regex": "(red|green|blue)"}),
            ("tell me something", None), ("phone:", {"regex": "[0-9]{3}-[0-9]{4}"}),
            ("after:", None)]
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu)):
        fleet = ContinuousEngine(engine, n_slots=2, chunk_steps=4, slot_max_seq=128)
        try:
            rs = [fleet.submit(p, max_tokens=12, greedy=True, chat=False,
                               **({"constraint": c} if c else {})) for p, c in reqs]
            st = fleet.stats()
        finally:
            fleet.close()
        out[name] = ([r["token_ids"] for r in rs], [r.get("constrained") for r in rs], st)
    tokens, flags, st = out["card"]
    assert tokens == out["cpu"][0] and flags == [True, None, True, None]
    g, launches = st["graphs"], st["launches"]
    cg = g["decode_chunk_constrained"]
    assert cg["captures"] == len(cg["buckets"]) >= 1
    assert cg["replays"] == launches["constrained_chunks"] - cg["captures"] >= 1
    assert g["decode_chunk"]["captures"] == 1
    assert g["decode_chunk"]["replays"] == (launches["decode_chunks"]
                                            - launches["constrained_chunks"] - 1) >= 1


# -- the solo engine's features on the card ------------------------------------


def _card_engine(card, impl="auto", kv_quant=None, **ecfg):
    """test-llama-tiny (fp32, seed 3) on the card with the CPU engine's
    weights, and that CPU engine."""
    cfg = EngineConfig(prefill_buckets=(16, 32), **ecfg)
    cpu = create_engine("test-llama-tiny", seed=3, engine_cfg=cfg, device="cpu")
    moved = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(card)) for k, v in cpu.backend.params.items()}
    return create_engine(cpu.cfg, params=moved, attn_impl=impl, kv_quant=kv_quant,
                         engine_cfg=cfg, device=card), cpu


def test_verify_forward_through_the_kernel_matches_plain(card):
    """One speculative verify forward (T = 1 + 4 at a scalar pos) through
    flash_attend, once per layer, against the plain path on the same
    cache; then whole speculative requests (n-gram, and the target as its
    own draft) on the card give plain greedy's ids."""
    from distributed_llm_inference_tpu_torch.engine import generate as G

    kern, _ = _card_engine(card, "auto")
    plain, _ = _card_engine(card, "plain")
    ids = [1] + [7, 11, 13, 17] * 5
    logits = {}
    for name, eng in (("kernel", kern), ("plain", plain)):
        cache = eng.backend.init_cache(1, eng.cfg.max_seq_len)
        toks = torch.tensor([ids + [0] * (32 - len(ids))], device=card)
        first, _, cache = G.prefill(eng.cfg, eng.backend.params, toks, len(ids), cache,
                                    torch.Generator(device=card).manual_seed(0),
                                    G.default_sampling(greedy=True))
        window = torch.tensor([[int(first[0]), 7, 11, 13, 17]], device=card)
        before = fa.flash_attend.launches
        out, _ = G._verify_fwd(eng.cfg, eng.backend.params)(window, cache, len(ids))
        logits[name] = (out, fa.flash_attend.launches - before)
    assert logits["kernel"][1] == kern.cfg.n_layers and logits["plain"][1] == 0
    torch.testing.assert_close(logits["kernel"][0], logits["plain"][0], atol=1e-4, rtol=0)
    prompt = "ab ab ab ab ab ab ab ab ab"
    want = plain.generate(prompt, max_tokens=16, greedy=True, chat=False)["response"]
    assert kern.generate(prompt, max_tokens=16, greedy=True, chat=False,
                         speculative=True)["response"] == want
    kern.set_draft(kern.cfg, kern.backend.params)
    r = kern.generate(prompt, max_tokens=16, greedy=True, chat=False, speculative=True)
    assert r["response"] == want and r["draft_model"] == kern.cfg.name


def test_score_chunk_kernel_matches_plain(card):
    """Teacher-forced scoring of a prompt over three chunks through the
    kernel (n_layers launches per chunk) against the plain path, within
    1e-4, the same top-2 strings."""
    kern, _ = _card_engine(card, "auto")
    plain, _ = _card_engine(card, "plain")
    prompt = "chunked scoring wants " * 4  # 89 tokens: 32 + 32 + a 32-bucket tail
    before = fa.flash_attend.launches
    got = kern.score(prompt, top_n=2)
    assert fa.flash_attend.launches - before == 3 * kern.cfg.n_layers
    want = plain.score(prompt, top_n=2)
    assert got["status"] == want["status"] == "success"
    import numpy as np

    np.testing.assert_allclose(got["token_logprobs"][1:], want["token_logprobs"][1:],
                               atol=1e-4)
    assert [set(d) for d in got["top_logprobs"][1:]] == \
        [set(d) for d in want["top_logprobs"][1:]]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefix_splice_on_cuda_is_bit_equal_to_the_cold_head(card, kv_quant):
    """A hit splices the snapshot into the card's solo cache in place: its
    head slots are bit-equal to the cold ingest that stored them, the
    cache keeps its storage, and the ids equal a cold engine's."""
    eng, _ = _card_engine(card, kv_quant=kv_quant, prefix_cache_entries=2,
                          prefix_chunk=16)
    cold, _ = _card_engine(card, kv_quant=kv_quant)
    head = "You are a helpful assistant. Answer briefly: "
    kw = dict(max_tokens=6, greedy=True, chat=False)
    eng.generate(head + "what is two plus two?", **kw)

    def tensors(cache):
        return [t for n in ("k", "v") for t in
                ((cache[n].q, cache[n].s) if hasattr(cache[n], "q") else (cache[n],))]

    stored = [t[:, :, :, :32].clone() for t in tensors(eng._cache)]
    ptrs = [t.data_ptr() for t in tensors(eng._cache)]
    r = eng.generate(head + "name a colour.", **kw)
    assert r["prefix_cached_tokens"] == 32
    assert [t.data_ptr() for t in tensors(eng._cache)] == ptrs
    for got, want in zip(tensors(eng._cache), stored):
        assert torch.equal(got[:, :, :, :32], want)
    assert r["response"] == cold.generate(head + "name a colour.", **kw)["response"]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_beam_reorder_on_cuda_equals_cpu(card, kv_quant):
    """The per-step reorder (index_select by parent beam on the card) is
    the CPU's bit for bit, an int8 cache's scales too; beam search on the
    card gives the CPU engine's beams."""
    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    g = torch.Generator().manual_seed(0)
    if kv_quant:
        leaf = lambda: KVQuant(torch.randint(-127, 128, (2, 4, 2, 64, 16), generator=g,
                                             dtype=torch.int8),
                               torch.rand(2, 4, 2, 64, generator=g))
    else:
        leaf = lambda: torch.randn(2, 4, 2, 64, 16, generator=g).to(torch.bfloat16)
    cache = {"k": leaf(), "v": leaf()}
    parents = torch.tensor([3, 3, 0, 1])
    want = G.reorder_cache(cache, parents)
    on_card = G.map_cache(cache, lambda x: x.to(card))
    got = G.reorder_cache(on_card, parents.to(card))
    for n in ("k", "v"):
        for a, b in ((got[n].q, want[n].q), (got[n].s, want[n].s)) if kv_quant else \
                ((got[n], want[n]),):
            assert torch.equal(a.cpu(), b)
    kern, cpu = _card_engine(card, "auto")
    kw = dict(max_tokens=8, chat=False, num_beams=4, length_penalty=1.0)
    a, b = kern.generate("Once upon a time", **kw), cpu.generate("Once upon a time", **kw)
    assert [x["text"] for x in a["beams"]] == [x["text"] for x in b["beams"]]
    for x, y in zip(a["beams"], b["beams"]):
        assert x["score"] == pytest.approx(y["score"], abs=1e-4)
