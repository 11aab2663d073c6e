"""The port's CUDA kernels on the card, held to their plain twins.

Marked `cuda` and skipped where torch.cuda.is_available() is false. The
file imports nothing of jax, so on a machine with a card and no jax it
runs without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 (summation order differs); bf16 / fp16 atol
2e-2 (outputs round to ~3 significant digits)."""

import pytest

torch = pytest.importorskip("torch")

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
    (1, 64, 32, 4, 64, 2048, 0, 0, {}, None),
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
    with pytest.raises(NotImplementedError):
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
