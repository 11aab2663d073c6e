"""PyTorch port vs JAX package: the MoE FFN (models/llama.moe_ffn) and its
int8 expert banks (ops/quant.expert_einsum) on the CPU.

The same weights (test-moe-tiny, fp32, with and without
`moe_renormalize`; params from the JAX package's init_params carried over
by models/bridge.py) and the same seeded inputs go through the JAX
function and its port: `moe_ffn` within 1e-5 (top-k ties broken toward
the lower expert, as jax.lax.top_k breaks them), `expert_einsum` on int8
banks, `quantize_params` on the 4-D banks (int8 quantized with scales
bit-equal, int4 left dense), the whole forward under int8; then the
greedy ids (exact) of the solo engine and of the paged fleet (ragged and
chunked prefill) against the JAX engine's and fleet's; and the adapter
refusals (MoE mlp targets, and gpt2) in the JAX words."""

import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import llama as JL  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu.runtime import create_engine as jax_create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as TM  # noqa: E402
from distributed_llm_inference_tpu_torch.models import llama as TL  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import quant as TQ  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-moe-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1)
ENGINE = dict(prefill_buckets=(32, 64), prefix_cache_entries=0)
PROMPTS = ["the quick brown fox", "jumps over the lazy dog while the band plays",
           "hello", "one two three four five six"]
ATOL = 1e-5


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _ids(r) -> list:
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


@functools.lru_cache(maxsize=None)
def _weights(renorm: bool, seed: int = 0):
    """One model's weights, drawn once (a jitted init_params: one compile,
    not one per leaf) and shared by the tests, which read them only."""
    kw = dict(OVERRIDES, moe_renormalize=renorm)
    jcfg, tcfg = jax_cfg(MODEL, **kw), get_model_config(MODEL, **kw)
    params = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module", params=[True, False], ids=["renorm", "no_renorm"])
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def qwen3_weights():
    """Renormalised top-k (Qwen3-MoE's norm_topk_prob, the registry's
    test-moe-tiny): the engines and the quantizer run on these alone."""
    return _weights(True)


def _layer(tree, i):
    return {k: (jax.tree.map(lambda a: a[i], v) if hasattr(v, "q") else v[i])
            for k, v in tree["layers"].items()}


def _tlayer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


def test_moe_ffn_equals_jax(weights):
    """One layer's MoE FFN on a seeded [B, T, D] chunk, fp32 within 1e-5,
    and renormalising changes the result (the flag is live)."""
    jcfg, tcfg, params, tparams = weights
    h = np.random.default_rng(4).standard_normal((2, 6, jcfg.dim)).astype(np.float32)
    want = JL.moe_ffn(jcfg, _layer(params, 1), jnp.asarray(h))
    got = TL.moe_ffn(tcfg, _tlayer(tparams, 1), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    other = TL.moe_ffn(tcfg.replace(moe_renormalize=not tcfg.moe_renormalize),
                       _tlayer(tparams, 1), torch.from_numpy(h))
    assert not torch.allclose(other, got)


def test_moe_ffn_ties_pick_the_lower_expert():
    """A router whose logits tie at the k-th place: both packages select
    the lower-indexed expert (jax.lax.top_k's order)."""
    jcfg, tcfg, params, tparams = _weights(True)
    lp, tlp = _layer(params, 0), _tlayer(tparams, 0)
    # every expert's logit equal: the top 2 are experts 0 and 1
    w = np.zeros((jcfg.dim, jcfg.n_experts), np.float32)
    lp["w_router"], tlp["w_router"] = jnp.asarray(w), torch.from_numpy(w)
    h = np.random.default_rng(5).standard_normal((1, 3, jcfg.dim)).astype(np.float32)
    want = JL.moe_ffn(jcfg, lp, jnp.asarray(h))
    got = TL.moe_ffn(tcfg, tlp, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_banks_equal_jax(qwen3_weights, mode):
    """The 4-D banks: int8 QTensors with [L, E, out] scales bit-equal to
    the JAX package's under int8 (quantized one layer slice at a time);
    dense under int4, while the attention projections take int4."""
    jcfg, tcfg, params, tparams = qwen3_weights
    jq = JQ.quantize_params(jcfg, params, mode)["layers"]
    tq = TQ.quantize_params(tcfg, tparams, mode)["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        if mode == "int8":
            assert isinstance(tq[name], TQ.QTensor), name
            assert tq[name].s.shape == tuple(np.asarray(jq[name].s).shape)
            assert np.array_equal(tq[name].q.numpy(), np.asarray(jq[name].q)), name
            assert np.array_equal(tq[name].s.numpy(), np.asarray(jq[name].s)), name
        else:
            assert not isinstance(jq[name], (JQ.QTensor, JQ.Q4Tensor))
            assert tq[name] is tparams["layers"][name], name
    assert isinstance(tq["wq"], TQ.QTensor if mode == "int8" else TQ.Q4Tensor)
    assert tq["w_router"] is tparams["layers"]["w_router"]


@pytest.mark.parametrize("spec", ["btd,edf->btef", "btef,efd->bted"])
def test_expert_einsum_int8_equals_jax(weights, spec):
    jcfg, tcfg, params, tparams = weights
    name = "w_gate" if spec.startswith("btd") else "w_down"
    jq = jax.tree.map(lambda a: a[2], JQ.quantize_params(jcfg, params, "int8")["layers"][name])
    tq = TQ.quantize_params(tcfg, tparams, "int8")["layers"][name][2]
    rng = np.random.default_rng(6)
    shape = (2, 3, jcfg.dim) if spec.startswith("btd") else (2, 3, jcfg.n_experts, jcfg.ffn_dim)
    x = rng.standard_normal(shape).astype(np.float32)
    want = JQ.expert_einsum(spec, jnp.asarray(x), jq)
    got = TQ.expert_einsum(spec, torch.from_numpy(x), tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    dense = TQ.expert_einsum(spec, torch.from_numpy(x), TQ.dequantize_tensor(tq))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_forward_equals_jax(weights, quant):
    """The whole model (prefill chunk, then a decode step at per-row
    positions), fp32 logits within 1e-5, raw and with int8 banks."""
    jcfg, tcfg, params, tparams = weights
    if quant:
        params = JQ.quantize_params(jcfg, params, quant)
        tparams = TQ.quantize_params(tcfg, tparams, quant)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 7))
    jc, tc = JM.init_kv_cache(jcfg, 2, 32), TM.init_kv_cache(tcfg, 2, 32)
    # the JAX side jitted whole: one compile, not one per primitive
    jl, jc = jax.jit(functools.partial(JM.forward, jcfg))(params, jnp.asarray(toks), jc, 0)
    tl, tc = TM.forward(tcfg, tparams, torch.from_numpy(toks), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    rows = np.array([7, 7], np.int32)
    jx = JM.embed(jcfg, params, jnp.asarray(nxt), jnp.asarray(rows))
    jx, jc = jax.jit(functools.partial(JM.forward_layers, jcfg))(
        params["layers"], jx, jc, jnp.asarray(rows))
    tx = TM.embed(tcfg, tparams, torch.from_numpy(nxt), torch.from_numpy(rows))
    tx, tc = TM.forward_layers(tcfg, tparams["layers"], tx, tc, torch.from_numpy(rows))
    np.testing.assert_allclose(TM.unembed(tcfg, tparams, tx).numpy(),
                               np.asarray(JM.unembed(jcfg, params, jx)), rtol=0, atol=ATOL)


def _engines(weights, quant=None):
    jcfg, tcfg, params, tparams = weights
    extra = {"quant": quant} if quant else {}
    jparams = JQ.quantize_params(jcfg.replace(**extra), params) if quant else params
    je = JaxEngine(jcfg.replace(**extra), params=jparams, tokenizer=IdTokenizer(),
                   engine_cfg=JaxEngineConfig(**ENGINE))
    te = create_engine(tcfg, params=tparams, tokenizer=IdTokenizer(),
                       engine_cfg=EngineConfig(**ENGINE), device="cpu", **extra)
    return je, te


@pytest.mark.parametrize("quant", [None, "int8"])
def test_solo_engine_greedy_ids_equal_jax(qwen3_weights, quant):
    je, te = _engines(qwen3_weights, quant)
    for p in PROMPTS[:2]:
        want = je.generate(p, max_tokens=12, greedy=True, chat=False)
        got = te.generate(p, max_tokens=12, greedy=True, chat=False)
        assert _ids(got) == _ids(want), (quant, p)


def _fleet_ids(mod, engine, **kw):
    fleet = mod.ContinuousEngine(engine, **kw)
    try:
        out = {}
        threads = [threading.Thread(target=lambda i=i, p=p: out.update(
            {i: fleet.submit(p, max_tokens=10, greedy=True, chat=False)}))
            for i, p in enumerate(PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        return [_ids(out[i]) for i in range(len(PROMPTS))], fleet.stats()
    finally:
        fleet.close()


def test_paged_fleet_greedy_ids_equal_jax(qwen3_weights):
    """Four concurrent greedy requests over two slots of the paged fleet
    (ragged, chunked prefill): the JAX fleet's ids, every block back."""
    je, te = _engines(qwen3_weights)
    kw = dict(n_slots=2, chunk_steps=4, slot_max_seq=64, kv_pool_blocks=24, kv_block_size=8)
    want, _ = _fleet_ids(JC, je, **kw)
    got, stats = _fleet_ids(TC, te, **kw)
    assert got == want
    assert stats["paged"]["free_blocks"] == stats["paged"]["pool_blocks"] - 1


def test_adapters_refused_as_jax():
    """Runtime adapters: an MoE config has no mlp leaves to target, and
    gpt2 has none at all; both packages refuse with the same words."""
    jcfg, tcfg, params, tparams = _weights(True)
    ecfg = dict(ENGINE, adapter_slots=2, adapter_rank=4)
    je = jax_create_engine(jcfg, params=params, engine_cfg=JaxEngineConfig(**ecfg))
    te = create_engine(tcfg, params=tparams, engine_cfg=EngineConfig(**ecfg), device="cpu")
    L, D, F = jcfg.n_layers, jcfg.dim, jcfg.ffn_dim
    factors = {"w_gate": (np.zeros((L, D, 4), np.float32), np.zeros((L, 4, F), np.float32))}
    with pytest.raises(ValueError) as want:
        je.adapters.register("a", factors)
    with pytest.raises(ValueError) as got:
        te.adapters.register("a", factors)
    assert str(got.value) == str(want.value) and "MoE" in str(got.value)
    g = dict(dtype="float32")
    gparams = JM.init_params(jax_cfg("test-gpt2-tiny", **g), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as want:
        jax_create_engine(jax_cfg("test-gpt2-tiny", **g), params=gparams,
                          engine_cfg=JaxEngineConfig(**ecfg))
    with pytest.raises(ValueError) as got:
        create_engine(get_model_config("test-gpt2-tiny", **g), device="cpu",
                      params=params_from_numpy(get_model_config("test-gpt2-tiny", **g),
                                               jax.tree.map(np.asarray, gparams), "cpu"),
                      engine_cfg=EngineConfig(**ecfg))
    assert str(got.value) == str(want.value)
