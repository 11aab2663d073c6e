"""PyTorch port vs JAX package: the gpt2 family (models/gpt2.py) on the
CPU, from the layer up to the served fleets.

The same weights (test-gpt2-tiny, fp32; params from the JAX package's
init_params carried over by models/bridge.py) and the same seeded inputs
go through the JAX function and its port: `gelu_new`, `embed` at a
scalar and a per-row position (out-of-range positions clamp as the JAX
gather does), `forward_layers` and `unembed`, fp32 within 1e-5; then the
greedy ids (exact, spelled by an id tokenizer) of the solo engine (raw,
int8 and int4 weights, an int8 KV cache), the dense fleet and the paged
fleet (ragged, chunked prefill) against the JAX engine's and fleets';
`generate_batch`'s refusal in the JAX words; a gpt2 draft, which the JAX
engine takes."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import gpt2 as JG2  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as TM  # noqa: E402
from distributed_llm_inference_tpu_torch.models import gpt2 as TG2  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import quant as TQ  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-gpt2-tiny"
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


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES), get_model_config(MODEL, **OVERRIDES)
    params = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(0))
    # non-zero biases and norms, so every leaf counts
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    return jcfg, tcfg, params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


# -- the layers ---------------------------------------------------------------------


def test_gelu_new_equals_jax():
    x = np.random.default_rng(0).standard_normal((3, 7, 64)).astype(np.float32) * 4
    _close(TG2.gelu_new(torch.from_numpy(x)), JG2.gelu_new(jnp.asarray(x)), "gelu_new")


@pytest.mark.parametrize("pos", ["scalar", "rows", "out_of_range"])
def test_embed_forward_layers_unembed_equal_jax(weights, pos):
    """embed, forward_layers and unembed at a scalar offset and at per-row
    positions (slots mode), fp32 within 1e-5; positions past the table or
    negative clamp as the JAX gather does."""
    jcfg, tcfg, params, tparams = weights
    B, T, S = 3, 5, 64
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, T))
    if pos == "scalar":
        jpos, tpos = 7, 7
    else:
        rows = np.array([0, 11, 40] if pos == "rows" else [-3, 126, 200], np.int32)
        jpos, tpos = jnp.asarray(rows), torch.from_numpy(rows)
    je = JM.embed(jcfg, params, jnp.asarray(toks), jpos)
    te = TM.embed(tcfg, tparams, torch.from_numpy(toks), tpos)
    _close(te, je, "embed")
    if pos == "out_of_range":
        return
    jcache, tcache = JM.init_kv_cache(jcfg, B, S), TM.init_kv_cache(tcfg, B, S)
    jx, jcache = JM.forward_layers(jcfg, params["layers"], je, jcache, jpos)
    tx, tcache = TM.forward_layers(tcfg, tparams["layers"], te, tcache, tpos)
    _close(tx, jx, "forward_layers")
    _close(tcache["k"], jcache["k"], "cache k")
    _close(tcache["v"], jcache["v"], "cache v")
    _close(TM.unembed(tcfg, tparams, tx), JM.unembed(jcfg, params, jx), "unembed")


def test_forward_layers_refuses_like_jax(weights):
    jcfg, tcfg, params, tparams = weights
    x = torch.zeros((1, 2, tcfg.dim))
    cache = TM.init_kv_cache(tcfg, 1, 16)
    jx = jnp.zeros((1, 2, jcfg.dim))
    jcache = JM.init_kv_cache(jcfg, 1, 16)
    for kw, tkw in (({"valid_start": jnp.zeros(1, jnp.int32)},
                     {"valid_start": torch.zeros(1, dtype=torch.int32)}),
                    ({"ep_axis": "ep"}, {"ep_axis": "ep"})):
        with pytest.raises(NotImplementedError) as want:
            JG2.forward_layers(jcfg, params["layers"], jx, jcache, 0, **kw)
        with pytest.raises(NotImplementedError) as got:
            TG2.forward_layers(tcfg, tparams["layers"], x, cache, 0, **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JM.forward_layers(jcfg, params["layers"], jx, jcache, 0,
                          lora_pages=jnp.zeros(1, jnp.int32))
    with pytest.raises(ValueError) as got:
        TM.forward_layers(tcfg, tparams["layers"], x, cache, 0,
                          lora_pages=torch.zeros(1, dtype=torch.int32))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_equals_jax(weights, mode):
    """gpt2's projections quantize (w_fc and w_proj among them), bit-equal
    to the JAX quantize_params; biases, norms and positions stay dense."""
    jcfg, tcfg, params, tparams = weights
    carried = params_from_numpy(
        tcfg, jax.tree.map(np.asarray, JQ.quantize_params(jcfg, params, mode)), "cpu")
    own = TQ.quantize_params(tcfg, tparams, mode)
    assert TQ._QUANT_KEYS["gpt2"] == JQ._QUANT_KEYS["gpt2"]
    for name in TQ._QUANT_KEYS["gpt2"]:
        a, b = carried["layers"][name], own["layers"][name]
        assert type(a) is type(b) and isinstance(a, (TQ.QTensor, TQ.Q4Tensor)), name
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), name
    for name in ("bq", "b_fc", "ln1_w"):
        assert own["layers"][name] is tparams["layers"][name]
    assert own["pos_embed"] is tparams["pos_embed"]


# -- the solo engine and the fleets -------------------------------------------------


def _engines(weights, quant=None, kv_quant=None, **ecfg):
    jcfg, tcfg, params, tparams = weights
    extra = {k: v for k, v in (("quant", quant), ("kv_quant", kv_quant)) if v}
    ecfg = {**ENGINE, **ecfg}
    je = JaxEngine(jcfg.replace(**extra), params=params, tokenizer=IdTokenizer(),
                   engine_cfg=JaxEngineConfig(**ecfg))
    if quant:
        je = JaxEngine(jcfg.replace(**extra),
                       params=JQ.quantize_params(jcfg.replace(**extra), params),
                       tokenizer=IdTokenizer(), engine_cfg=JaxEngineConfig(**ecfg))
    te = create_engine(tcfg, params=tparams, tokenizer=IdTokenizer(),
                       engine_cfg=EngineConfig(**ecfg), device="cpu", **extra)
    return je, te


@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("int8", None),
                                            ("int4", "int8")])
def test_solo_engine_greedy_ids_equal_jax(weights, quant, kv_quant):
    je, te = _engines(weights, quant, kv_quant)
    for p in PROMPTS[:2]:
        want = je.generate(p, max_tokens=12, greedy=True, chat=False)
        got = te.generate(p, max_tokens=12, greedy=True, chat=False)
        assert _ids(got) == _ids(want), (quant, kv_quant, p)


def test_generate_batch_refused_as_jax(weights):
    je, te = _engines(weights)
    want = je.generate_batch(PROMPTS[:2], max_tokens=4, greedy=True, chat=False)
    got = te.generate_batch(PROMPTS[:2], max_tokens=4, greedy=True, chat=False)
    assert want["status"] == got["status"] == "failed"
    assert got["error"] == want["error"] and "llama-family only" in got["error"]


def _fleet_ids(mod, engine, prompts, **kw):
    fleet = mod.ContinuousEngine(engine, **kw)
    try:
        import threading

        out = {}
        threads = [threading.Thread(target=lambda i=i, p=p: out.update(
            {i: fleet.submit(p, max_tokens=10, greedy=True, chat=False)}))
            for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        return [_ids(out[i]) for i in range(len(prompts))], fleet.stats()
    finally:
        fleet.close()


@pytest.mark.parametrize("fleet", ["dense", "paged", "paged_int8"])
def test_fleet_greedy_ids_equal_jax(weights, fleet):
    """The dense fleet and the paged fleet (ragged and chunked prefill; an
    int8 pool) serve four concurrent greedy requests over two slots with
    the JAX fleet's ids; every pool block comes back."""
    kv = "int8" if fleet == "paged_int8" else None
    je, te = _engines(weights, kv_quant=kv)
    kw = dict(n_slots=2, chunk_steps=4, slot_max_seq=64)
    if fleet != "dense":
        kw.update(kv_pool_blocks=24, kv_block_size=8)
    want, _ = _fleet_ids(JC, je, PROMPTS, **kw)
    got, stats = _fleet_ids(TC, te, PROMPTS, **kw)
    assert got == want
    if fleet != "dense":
        assert stats["paged"]["free_blocks"] == stats["paged"]["pool_blocks"] - 1
        assert stats["launches"]["mixed"] > 0


def test_gpt2_draft_as_the_jax_engine_takes_it(weights):
    """A gpt2 draft on a gpt2 target: the JAX engine takes it, the port's
    does too, and a speculative request's ids equal the JAX engine's (and
    its plain greedy ids); the draft's 2-layer config, seed 3."""
    jcfg, tcfg, params, tparams = weights
    je, te = _engines(weights)
    dj = jax_cfg(MODEL, **OVERRIDES, n_layers=2)
    dparams = JM.init_params(dj, jax.random.PRNGKey(3))
    je.set_draft(dj, dparams)
    te.set_draft(get_model_config(MODEL, **OVERRIDES, n_layers=2),
                 params_from_numpy(tcfg, jax.tree.map(np.asarray, dparams), "cpu"))
    want = je.generate(PROMPTS[1], max_tokens=10, greedy=True, chat=False, speculative=True)
    got = te.generate(PROMPTS[1], max_tokens=10, greedy=True, chat=False, speculative=True)
    assert _ids(got) == _ids(want)
    plain = te.generate(PROMPTS[1], max_tokens=10, greedy=True, chat=False)
    assert _ids(got) == _ids(plain)
