"""PyTorch port vs JAX package: the solo engine's beam search.

The cases of tests/test_beam_search.py at tier-1 sizes (test-llama-tiny,
fp32, the reference's init_params carried over by models/bridge.py): the
beams (texts, scores to 1e-5, order) equal the JAX engine's for
num_beams 2 and 4, length_penalty 0.5 / 1.0 / 2.0 and early_stopping
both ways, and over an int8 cache (scores to 1e-2 there: one int8 grid
step); a scripted beam loop whose
candidates tie exactly (equal seed scores, finished and dead beams at
NEG_INF_F32) ranks them as the JAX loop does; and the rejections carry the
JAX engine's messages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (16, 32)
PROMPT = "Once upon a time"


@pytest.fixture(scope="module")
def engines():
    """{kv_quant: (jax engine, port engine)} on the same weights."""
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(5))
    tparams = params_from_numpy(get_model_config(MODEL),
                                jax.tree.map(np.asarray, params), "cpu")
    out = {}
    for kvq in (None, "int8"):
        je = JaxEngine(jax_cfg(MODEL, kv_quant=kvq), params,
                       engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
        pe = create_engine(get_model_config(MODEL), params=tparams, kv_quant=kvq,
                           engine_cfg=EngineConfig(prefill_buckets=BUCKETS),
                           device="cpu")
        out[kvq] = (je, pe)
    return out


def _same_beams(got, want, atol=1e-5):
    assert got["status"] == want["status"] == "success", (got, want)
    assert len(got["beams"]) == len(want["beams"]) == got["num_beams"]
    for g, w in zip(got["beams"], want["beams"]):
        assert (g["text"], g["tokens"], g["stopped"]) == (w["text"], w["tokens"],
                                                          w["stopped"])
        assert g["score"] == pytest.approx(w["score"], abs=atol)
    scores = [b["score"] for b in got["beams"]]
    assert scores == sorted(scores, reverse=True)
    for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason",
                "num_beams", "stopped"):
        assert got.get(key) == want.get(key), key
    assert set(got) == set(want)


@pytest.mark.parametrize("num_beams,early_stopping,length_penalty", [
    (2, True, 1.0), (2, False, 0.5), (4, True, 2.0), (4, False, 1.0),
])
def test_beams_equal_jax(engines, num_beams, early_stopping, length_penalty):
    je, pe = engines[None]
    kw = dict(max_tokens=12, chat=False, num_beams=num_beams,
              early_stopping=early_stopping, length_penalty=length_penalty)
    _same_beams(pe.generate(PROMPT, **kw), je.generate(PROMPT, **kw))


def test_beams_over_an_int8_cache_equal_jax(engines):
    """The tiled and reordered cache carries the KVQuant scales too. The
    two packages' int8 writes may store a value one grid step apart
    (test_torch_kv_quant.py's LOGITS_ATOL): the texts are equal, the
    scores within that step's reach."""
    je, pe = engines["int8"]
    kw = dict(max_tokens=10, chat=False, num_beams=3, length_penalty=1.0)
    _same_beams(pe.generate(PROMPT, **kw), je.generate(PROMPT, **kw), atol=1e-2)


def test_stable_top_is_jax_top_k_under_ties():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(5, 64)).astype(np.float32)  # ties everywhere
    x[0, :] = -1e9
    jv, ji = jax.lax.top_k(jnp.asarray(x), 9)
    v, i = G.stable_top(torch.from_numpy(x), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("early_stopping", [True, False])
def test_beam_loop_breaks_exact_ties_as_jax(early_stopping):
    """Scripted logits: the seed row's best tokens tie, every beam sees the
    same row (so candidates of different parents tie exactly), the stop
    token ties with a live one, and dead beams sit at NEG_INF_F32. The
    port's loop keeps the JAX loop's order (lower index first)."""
    cfg = get_model_config(MODEL)
    jcfg = jax_cfg(MODEL)
    nb, V, steps = 3, 16, 6
    eos = cfg.eos_token_id
    rows = np.full((steps + 1, V), -5.0, np.float32)
    rows[:, [4, 7, 9]] = 1.0  # three-way tie
    rows[2:, eos] = 1.0  # the stop token ties the live ones from step 2
    rows[4, :] = 0.0  # a flat row: every token ties
    table = np.broadcast_to(rows[:, None, :], (steps + 1, nb, V)).copy()
    start = 10

    jt = jnp.asarray(table)
    jout, jn, js, _ = JG.beam_loop(
        jcfg, lambda last, c, pos: (jt[pos - start + 1], c),
        jt[0], {"k": jnp.zeros((1, nb, 1, 1, 1))}, jnp.int32(start),
        jnp.int32(steps), jnp.float32(1.0), max_steps=8, num_beams=nb,
        early_stopping=early_stopping)
    tt = torch.from_numpy(table)
    out, n, s, _ = G.beam_loop(
        cfg, lambda last, c, pos: (tt[pos - start + 1], c), tt[0],
        {"k": torch.zeros((1, nb, 1, 1, 1))}, start, steps, 1.0, max_steps=8,
        num_beams=nb, early_stopping=early_stopping)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)


def test_reorder_cache_gathers_every_leaf_by_parent():
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    q = torch.arange(2 * 3 * 1 * 4 * 2, dtype=torch.int8).reshape(2, 3, 1, 4, 2)
    s = torch.arange(2 * 3 * 1 * 4, dtype=torch.float32).reshape(2, 3, 1, 4)
    raw = torch.randn(2, 1, 1, 4, 2)
    tiled = G.tile_cache({"k": raw, "v": raw.clone()}, 3)
    assert tiled["k"].shape == (2, 3, 1, 4, 2)
    assert torch.equal(tiled["k"][:, 2], raw[:, 0])
    parents = torch.tensor([2, 0, 0])
    got = G.reorder_cache({"k": KVQuant(q, s), "v": KVQuant(q.clone(), s.clone())},
                          parents)
    assert torch.equal(got["k"].q, q[:, [2, 0, 0]])
    assert torch.equal(got["v"].s, s[:, [2, 0, 0]])


@pytest.mark.parametrize("kw", [
    {"num_beams": 2, "frequency_penalty": 0.5},
    {"num_beams": 17},
    {"num_beams": 2, "prompt": "x" * 40},  # past the one 32-token bucket
], ids=["penalty", "range", "long-prompt"])
def test_beam_rejections_equal_jax(engines, kw):
    je, pe = engines[None]
    kw = dict(kw)
    prompt = kw.pop("prompt", PROMPT)
    got = pe.generate(prompt, max_tokens=4, chat=False, **kw)
    want = je.generate(prompt, max_tokens=4, chat=False, **kw)
    assert got["status"] == want["status"] == "failed"
    assert got["error_type"] == want["error_type"] == "invalid_request"
    assert got["error"] == want["error"]
