"""PyTorch port vs JAX package: full-model logits on the tiny registry
configs, the same weights carried over by models/bridge.params_from_numpy.

Tolerance atol 1e-4 on fp32 logits: a few layers of matmuls summed in a
different order by each framework."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as TM  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402

ATOL = 1e-4


# dense flags no tiny registry preset sets: Qwen2's qkv bias and
# Granite's multipliers, as overrides of test-llama-tiny on both sides
OVERRIDES = {
    "qwen2-bias": ("test-llama-tiny", {"attn_qkv_bias": True}),
    "granite": ("test-llama-tiny", {
        "embed_multiplier": 12.0, "residual_multiplier": 0.22,
        "attn_scale_override": 0.015625, "logits_divider": 8.0}),
}


def _configs(name):
    base, kw = OVERRIDES.get(name, (name, {}))
    return (dataclasses.replace(jax_cfg(base), **kw),
            get_model_config(base).replace(**kw))


def _weights(name, seed=0):
    """JAX params with every weight perturbed (so biases, norm weights
    and qk-norms are not at their neutral init), as numpy."""
    params = JM.init_params(_configs(name)[0], jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf, np.float32)
        if path[-1].key == "window_flag":
            return arr
        return arr + 0.05 * rng.standard_normal(arr.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.mark.parametrize("name", [
    "test-llama-tiny", "test-qwen3-tiny", "test-gemma2-tiny",
    "test-gemma3-tiny", "test-olmo2-tiny", "qwen2-bias", "granite",
])
def test_forward_logits_match_jax(name):
    tree = _weights(name)
    jcfg, tcfg = _configs(name)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    S = 48
    jcache = JM.init_kv_cache(jcfg, 2, max_seq=S)
    tcache = TM.init_kv_cache(tcfg, 2, max_seq=S, device="cpu")
    pos = 0
    for T in (11, 3, 1):  # prefill, a chunk at an offset, a decode step
        toks = rng.integers(3, tcfg.vocab_size, (2, T)).astype(np.int32)
        jlog, jcache = JM.forward(jcfg, jparams, jnp.asarray(toks), jcache, jnp.int32(pos))
        tlog, tcache = TM.forward(tcfg, tparams, torch.from_numpy(toks).long(), tcache, pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
        pos += T


@pytest.mark.parametrize("name", ["test-llama-tiny", "test-gemma2-tiny"])
def test_slots_mode_per_row_positions_match_jax(name):
    """Continuous batching's slots mode: pos is an int32 [B] tensor, each
    row writes its chunk at its own offset (ops/attention.
    update_kv_cache_slots) and attends under its own causal (and window)
    mask (slot_causal_mask), with RoPE per row."""
    tree = _weights(name)
    jcfg, tcfg = _configs(name)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    S = 40
    jcache = JM.init_kv_cache(jcfg, 3, max_seq=S)
    tcache = TM.init_kv_cache(tcfg, 3, max_seq=S, device="cpu")
    toks = rng.integers(3, tcfg.vocab_size, (3, 12)).astype(np.int32)
    _, jcache = JM.forward(jcfg, jparams, jnp.asarray(toks), jcache, jnp.int32(0))
    _, tcache = TM.forward(tcfg, tparams, torch.from_numpy(toks).long(), tcache, 0)
    # rows at their own positions: one decodes on, one rewinds, one idles at 0
    for T, pos in ((1, [12, 5, 0]), (3, [13, 6, 0]), (1, [16, 9, 3])):
        toks = rng.integers(3, tcfg.vocab_size, (3, T)).astype(np.int32)
        p = np.array(pos, np.int32)
        jlog, jcache = JM.forward(jcfg, jparams, jnp.asarray(toks), jcache, jnp.asarray(p))
        tlog, tcache = TM.forward(tcfg, tparams, torch.from_numpy(toks).long(), tcache,
                                  torch.from_numpy(p))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["test-llama-tiny", "test-gemma2-tiny"])
def test_kernel_path_matches_plain_path(name):
    """attn_impl="kernel" on the CPU runs the flash kernel's plain twin
    inside the model: same logits as the einsum path."""
    cfg = get_model_config(name)
    params = params_from_numpy(cfg, _weights(name), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (1, 13), generator=torch.Generator().manual_seed(0))
    outs = []
    for impl in ("plain", "kernel"):
        c = cfg.replace(attn_impl=impl)
        cache = TM.init_kv_cache(c, 1, max_seq=32, device="cpu")
        outs.append(TM.forward(c, params, toks, cache, 4)[0])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5, rtol=0)


def test_unported_features_raise():
    """What this test once held refused is served since the other
    families were ported (the MoE FFN's params, gpt2's, int8 expert banks;
    their parity in test_torch_moe.py and test_torch_gpt2.py) and the
    expert mesh (its parity in test_torch_moe.py): an ep group of one
    rank is the whole bank."""
    from distributed_llm_inference_tpu_torch.models import llama as TL
    from distributed_llm_inference_tpu_torch.ops.quant import QTensor, quantize_params

    cfg = get_model_config("test-moe-tiny")
    moe = TM.init_params(cfg, torch.Generator())
    assert tuple(moe["layers"]["w_gate"].shape) == (4, 4, 64, 96)
    assert tuple(moe["layers"]["w_router"].shape) == (4, 64, 4)
    gpt2 = TM.init_params(get_model_config("test-gpt2-tiny"), torch.Generator())
    assert tuple(gpt2["pos_embed"].shape) == (128, 64)
    q = quantize_params(get_model_config("test-llama-tiny", quant="int8"),
                        {"layers": {"w_up": torch.zeros(2, 4, 8, 16)}})
    assert isinstance(q["layers"]["w_up"], QTensor)
    x, cache = torch.zeros(1, 2, cfg.dim), TM.init_kv_cache(cfg, 1, 16)
    class _One:  # an ep group of one rank
        rank, size = 0, 1

        @staticmethod
        def psum(t):
            return t.clone()

    x = torch.randn(1, 2, cfg.dim, generator=torch.Generator().manual_seed(0))
    want, _ = TL.forward_layers(cfg, moe["layers"], x, cache, 0)
    got, _ = TL.forward_layers(cfg, moe["layers"], x, TM.init_kv_cache(cfg, 1, 16), 0,
                               ep_axis=_One())
    assert torch.equal(got, want)
    # tp groups and pipeline stages are ported; an MoE layer refuses a tp
    # group in the JAX package's words, and no update gate is taken
    with pytest.raises(NotImplementedError, match="MoE \\+ tensor parallelism"):
        TL.forward_layers(cfg, moe["layers"], x, cache, 0, tp_group=object())
    with pytest.raises(TypeError):
        TL.forward_layers(cfg, moe["layers"], x, cache, 0, update_gate=torch.ones(()))
