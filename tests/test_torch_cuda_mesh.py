"""The part-B mesh backends on the card: the 1F1B schedule, the context
ring and the expert mesh, their ranks sharing one card over gloo, held to
the plain pipeline or the single device on CUDA tensors.

Marked `cuda` and skipped where torch.cuda.is_available() is false. The
file imports nothing of jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py

Tolerance: fp32 logits within 1e-4 (the kernels' and the shards' sums run
in another order), greedy ids equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_llm_inference_tpu_torch.config import MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import SingleDeviceBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_to  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.ring import ring_attend  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_backend  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh's ranks run on the card")
    return torch.device("cuda")


def _run(backend, toks, plen, steps=8):
    s = G.default_sampling(greedy=True)
    cache = backend.init_cache(toks.shape[0], 128)
    f, lg, cache = backend.prefill(toks, plen, cache, torch.Generator(device=toks.device), s)
    o, n, _ = backend.decode(f, cache, plen, steps, torch.Generator(device=toks.device), s,
                             max_steps=steps)
    return f.cpu(), lg.float().cpu(), o.cpu(), n.cpu()


def _prompts(cfg, B, T, card, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, T))).long().to(card)


def test_1f1b_decode_equals_plain_pipeline_on_cuda(card):
    """pp 2 with M 2 against the plain pp 2 pipeline on the card (the T > 1
    chunks through flash_attend on each rank): the same prefill logits
    and greedy ids."""
    cfg = get_model_config("test-llama-tiny", dtype="float32", n_layers=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    _, f1b = create_backend(cfg, mesh_cfg=MeshConfig(pp=2), microbatches=2, params=params,
                            attn_impl="kernel", device=card)
    _, plain = create_backend(cfg, mesh_cfg=MeshConfig(pp=2), params=params,
                              attn_impl="kernel", device=card)
    try:
        f1b.return_prefill_logits = True
        toks = _prompts(cfg, 4, 32, card)
        got, want = _run(f1b, toks, 32), _run(plain, toks, 32)
        torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=0)
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            assert torch.equal(g, w)
    finally:
        f1b.close()
        plain.close()


def test_ring_attend_matches_single_device_attention_on_cuda(card):
    """The context ring at sp 2 (ring and Ulysses) on the card against the
    single device's engine functions: prefill logits and greedy ids."""
    cfg = get_model_config("test-llama-tiny", dtype="float32", n_layers=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(1))
    single = SingleDeviceBackend(cfg, params_to(params, card), card)
    toks = _prompts(cfg, 2, 32, card, seed=1)
    want = _run(single, toks, 27)
    for strategy in ("ring", "ulysses"):
        _, cp = create_backend(cfg, mesh_cfg=MeshConfig(sp=2), sp_strategy=strategy,
                               params=params, device=card)
        try:
            got = _run(cp, toks, 27)
        finally:
            cp.close()
        torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=0)
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            assert torch.equal(g, w), strategy


def test_ring_attend_one_rank_is_causal_attention_on_cuda(card):
    """ring_attend over a ring of one rank is causal attention on CUDA
    tensors (SDPA's)."""

    class One:
        rank, size = 0, 1

    g = torch.Generator(device=card).manual_seed(2)
    q = torch.randn(2, 64, 8, 32, device=card, generator=g)
    k = torch.randn(2, 64, 4, 32, device=card, generator=g)
    v = torch.randn(2, 64, 4, 32, device=card, generator=g)
    got = ring_attend(q, k, v, One())
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(2, 2).transpose(1, 2),
        v.repeat_interleave(2, 2).transpose(1, 2), is_causal=True).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_expert_mesh_equals_single_device_on_cuda(card):
    """An MoE model at ep 2 on the card: the single device's logits and
    greedy ids."""
    cfg = get_model_config("test-moe-tiny", dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(3))
    single = SingleDeviceBackend(cfg, params_to(params, card), card)
    _, ep = create_backend(cfg, mesh_cfg=MeshConfig(ep=2), params=params, device=card)
    try:
        toks = _prompts(cfg, 2, 16, card, seed=3)
        got, want = _run(ep, toks, 16), _run(single, toks, 16)
    finally:
        ep.close()
    torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=0)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert torch.equal(g, w)
