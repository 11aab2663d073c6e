"""The port's CUDA kernels on the card at the widths of the other
families, held to their plain twins: a GQA group of 1 (gpt2-medium: 16
query and 16 KV heads of 64) and head_dim 128 (qwen3-30b-a3b: 32 query
heads over 4 KV heads); q4_matmul_rows at both models' int4 projections;
then both families' engines at full width and cut depth, the kernel path
against the plain path, and both families' paged fleets through their
graphs.

Marked `cuda` and skipped where torch.cuda.is_available() is false. The
file imports nothing of jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_families.py

Tolerances: fp32 atol 1e-4 (summation order differs); bf16 atol 2e-2
(outputs round to ~3 significant digits); q4 as tests/test_torch_cuda.py
(fp32 1e-4, bf16 6e-2);
logits through bf16 layers 0.25 (chip_smoke's LOGITS_ATOL)."""

import pytest

torch = pytest.importorskip("torch")

from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as pa  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import quant as Q  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
Q4_ATOL = {"float32": 1e-4, "bfloat16": 6e-2}
LOGITS_ATOL = 0.25
# the MoE engines compare in fp32: a bf16 ulp between the two attention
# paths can move a token's router logits across the top-k edge, and a
# different expert moves its logits by O(1) at 2 layers (0.797 in bf16 on
# an NVIDIA H100 80GB HBM3 at 700 W). In fp32 the paths part by ~1e-6
# relative; 1e-3 leaves the fp32 attention atol (1e-4) a 10x growth over
# 2 layers.
FP32_LOGITS_ATOL = 1e-3
# (label, H, KV, Dh): gpt2-medium's MHA and qwen3-30b-a3b's Dh 128
WIDTHS = [("group1", 16, 16, 64), ("dh128", 32, 4, 128)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,H,KV,Dh", WIDTHS)
def test_flash_kernel_matches_twin_at_the_new_widths(card, dtype, label, H, KV, Dh):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(0)
    for B, T, pos, vs_step in ((1, 64, 0, 0), (1, 128, 384, 0), (1, 100, 600, 0),
                               (3, 33, 7, 5)):
        q = torch.randn(B, T, H, Dh, generator=g, device=card).to(dt)
        ck = torch.randn(B, KV, 1024, Dh, generator=g, device=card).to(dt)
        cv = torch.randn(B, KV, 1024, Dh, generator=g, device=card).to(dt)
        vs = torch.arange(B, dtype=torch.int32, device=card) * vs_step
        before = fa.flash_attend.launches
        got = fa.flash_attend(q, ck, cv, pos, vs)
        torch.cuda.synchronize()
        assert fa.flash_attend.launches == before + 1
        err = _err(got, fa.flash_attend_plain(q, ck, cv, pos, vs))
        assert err <= ATOL[dtype], (label, B, T, pos, err)
        assert torch.equal(got, fa.flash_attend(q, ck, cv, pos, vs))


def _pool(card, dt, g, KV, Dh, rows, MB=64, bs=16):
    n = rows * MB + 1
    pk = torch.randn(n, KV, bs, Dh, generator=g, device=card).to(dt)
    pv = torch.randn(n, KV, bs, Dh, generator=g, device=card).to(dt)
    perm = torch.randperm(n - 1, generator=g, device=card)[: rows * MB] + 1
    return pk, pv, perm.reshape(rows, MB).to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,H,KV,Dh", WIDTHS)
def test_paged_decode_kernel_matches_twin_at_the_new_widths(card, dtype, label, H, KV, Dh):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(1)
    pk, pv, table = _pool(card, dt, g, KV, Dh, 8)
    pos = torch.tensor([0, 15, 16, 700, 1023, 5, 64, 333], dtype=torch.int32, device=card)
    q = torch.randn(8, 1, H, Dh, generator=g, device=card).to(dt)
    for kw in ({}, {"window": 256}):
        before = pa.paged_flash_attend.launches
        got = pa.paged_flash_attend(q, pk, pv, table, pos, **kw)
        torch.cuda.synchronize()
        assert pa.paged_flash_attend.launches == before + 1
        err = _err(got, pa.paged_flash_attend_plain(q, pk, pv, table, pos, **kw))
        assert err <= ATOL[dtype], (label, kw, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,H,KV,Dh", WIDTHS)
def test_ragged_kernel_matches_twin_at_the_new_widths(card, dtype, label, H, KV, Dh):
    """Decode rows, a 19-token chunk over three tiles, a 5-token row and
    pad tiles in one launch; padding rows exact zeros."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(2)
    tq = 8
    pk, pv, table = _pool(card, dt, g, KV, Dh, 10)
    meta = torch.tensor([(0, 17, 1, 1), (1, 1023, 1, 1), (2, 0, 1, 1),
                         (5, 640, 8, 0), (5, 648, 8, 0), (5, 656, 3, 0),
                         (9, 0, 5, 0), (9, 0, 0, 0), (9, 0, 0, 0)],
                        dtype=torch.int32, device=card)
    q = torch.randn(meta.shape[0] * tq, H, Dh, generator=g, device=card).to(dt)
    before = pa.ragged_paged_attend.launches
    got = pa.ragged_paged_attend(q, pk, pv, table, meta)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attend.launches == before + 1
    err = _err(got, pa.ragged_paged_attend_plain(q, pk, pv, table, meta))
    assert err <= ATOL[dtype], (label, err)
    assert got[7 * tq:].abs().max().item() == 0.0
    assert got[6 * tq + 5: 7 * tq].abs().max().item() == 0.0
    assert torch.equal(got, pa.ragged_paged_attend(q, pk, pv, table, meta))


# gpt2-medium's int4 projections and qwen3-30b-a3b's attention projections
Q4_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024), (2048, 4096), (2048, 512),
             (4096, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_matmul_kernel_matches_twin_at_the_new_projections(card, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(4)
    for d_in, d_out in Q4_SHAPES:
        w = Q.quantize_tensor4(torch.randn(d_in, d_out, generator=g, device=card)
                               * d_in ** -0.5)
        for R in (1, 8, 32):
            x = torch.randn(R, d_in, generator=g, device=card).to(dt)
            before = Q.q4_matmul_rows.launches
            got = Q.q4_matmul_rows(x, w)
            torch.cuda.synchronize()
            assert Q.q4_matmul_rows.launches == before + 1
            err = _err(got, Q.q4_matmul_rows_plain(x, w))
            assert err <= Q4_ATOL[dtype], (d_in, d_out, R, err)


def _engine(name, dtype="bfloat16", **kw):
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(name, n_layers=2, max_seq_len=1024)
    return create_engine(cfg, dtype=dtype, attn_impl="auto", seed=0, device="cuda",
                         engine_cfg=EngineConfig(prefill_buckets=(64, 128)), **kw)


@pytest.mark.parametrize("name,quant,dtype,atol", [
    ("gpt2-medium", None, "bfloat16", LOGITS_ATOL),
    ("gpt2-medium", "int4", "bfloat16", LOGITS_ATOL),
    ("qwen3-30b-a3b", None, "float32", FP32_LOGITS_ATOL),
    ("qwen3-30b-a3b", "int8", "float32", FP32_LOGITS_ATOL)])
def test_engine_kernel_path_matches_plain_path(card, name, quant, dtype, atol):
    """Full width, 2 layers: a 96-token prefill chunk and a 64-token chunk
    at 96 through the kernels against the plain path's logits."""
    from distributed_llm_inference_tpu_torch.models import api as M

    eng = _engine(name, dtype=dtype, quant=quant)
    params = eng.backend.params
    toks = torch.randint(3, eng.cfg.vocab_size, (1, 160), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    out = {}
    with torch.no_grad():
        for cfg in (eng.cfg, eng.cfg.replace(attn_impl="plain")):
            cache = M.init_kv_cache(cfg, 1, max_seq=1024, device=card)
            before = fa.flash_attend.launches
            a, cache = M.forward(cfg, params, toks[:, :96], cache, 0)
            b, cache = M.forward(cfg, params, toks[:, 96:], cache, 96)
            out[cfg.attn_impl] = (torch.cat([a, b], dim=1), fa.flash_attend.launches - before)
    (k, nk), (p, npl) = out["kernel"], out["plain"]
    assert nk == 2 * 2 and npl == 0
    assert bool(torch.isfinite(k).all())
    assert _err(k, p) <= atol


def _paged_fleet_through_graphs(name):
    """`name` (2 layers) on the paged fleet: four greedy requests, the
    mixed launch and the decode chunk each captured once and replayed,
    the two kernels' launches per layer, every block back."""
    import threading

    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    eng = _engine(name)
    fleet = ContinuousEngine(eng, n_slots=4, chunk_steps=8, slot_max_seq=512,
                             kv_pool_blocks=129, kv_block_size=16)
    try:
        out = {}
        prompts = ["the quick brown fox " * k for k in (1, 3, 9, 20)]
        before = (pa.ragged_paged_attend.launches, pa.paged_flash_attend.launches)
        threads = [threading.Thread(target=lambda i=i, p=p: out.update(
            {i: fleet.submit(p, max_tokens=24, greedy=True, chat=False)}))
            for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        st = fleet.stats()
    finally:
        fleet.close()
    assert all(out[i]["status"] == "success" for i in range(4))
    mixed, chunks = st["launches"]["mixed"], st["launches"]["decode_chunks"]
    assert pa.ragged_paged_attend.launches - before[0] == 2 * mixed > 0
    assert pa.paged_flash_attend.launches - before[1] == 2 * 8 * chunks > 0
    graphs = st["graphs"]
    assert graphs["mixed_launch"]["captures"] == 1 and graphs["decode_chunk"]["captures"] == 1
    assert st["paged"]["free_blocks"] + st["paged"]["cached_blocks"] == 128


def test_gpt2_paged_fleet_serves_through_its_graphs(card):
    _paged_fleet_through_graphs("gpt2-medium")


def test_moe_paged_fleet_serves_through_its_graphs(card):
    """qwen3-30b-a3b's all-experts FFN ([W, 128, 768] intermediates) inside
    the captured mixed launch and decode chunk."""
    _paged_fleet_through_graphs("qwen3-30b-a3b")
