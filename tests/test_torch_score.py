"""PyTorch port vs JAX package: teacher-forced scoring (engine.score, the
OpenAI echo + logprobs + max_tokens=0 route's engine half).

The cases of tests/test_score.py at tier-1 sizes, held to the JAX
functions instead of an HF model (test-llama-tiny, fp32, the reference's
init_params carried over by models/bridge.py): `score_chunk` over two
chained chunks and `score_post` give the JAX functions' log-probabilities
to 1e-5 and their top-N ids, ties ranked as jax.lax.top_k ranks them;
`engine.score` across chunk boundaries (a prompt past the largest bucket)
equals the JAX engine's envelope, through the plain and the flash path;
the rejections carry the JAX messages."""

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
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (16, 32)
LONG = "chunked scoring wants " * 4  # 89 tokens: two full chunks and a tail


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(7))
    return params, params_from_numpy(get_model_config(MODEL),
                                     jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def engines(weights):
    params, tparams = weights
    je = JaxEngine(jax_cfg(MODEL), params,
                   engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    out = {"jax": je}
    for impl in ("plain", "kernel"):
        out[impl] = create_engine(get_model_config(MODEL, attn_impl=impl),
                                  params=tparams,
                                  engine_cfg=EngineConfig(prefill_buckets=BUCKETS),
                                  device="cpu")
    return out


def test_score_chunk_chained_equals_jax(weights):
    """Two 16-token chunks chained through the cache: within-chunk
    log-probabilities, the top-3 alternatives and the last position's
    distribution (which scores the next chunk's first token)."""
    params, tparams = weights
    jcfg, cfg = jax_cfg(MODEL), get_model_config(MODEL)
    ids = np.random.default_rng(0).integers(3, 256, size=32).tolist()
    jcache = JM.init_kv_cache(jcfg, 1, max_seq=128)
    cache = M.init_kv_cache(cfg, 1, max_seq=128, device="cpu")
    for c in range(2):
        rows = [ids[c * 16:(c + 1) * 16]]
        jw, jv, ji, jl, jcache = JG.score_chunk(jcfg, params, jnp.asarray(rows, jnp.int32),
                                                jnp.int32(c * 16), jcache, top_n=3)
        w, v, i, last, cache = G.score_chunk(cfg, tparams, torch.tensor(rows), c * 16,
                                             cache, top_n=3)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(last.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("top_n", [0, 4])
def test_score_post_ties_and_shapes_equal_jax(top_n):
    """Logits with exact ties: the same top-N ids in the same order as
    jax.lax.top_k (lower index first), and empty alternatives at 0."""
    rng = np.random.default_rng(1)
    logits = rng.integers(0, 3, size=(2, 5, 12)).astype(np.float32)
    tokens = rng.integers(0, 12, size=(2, 5))
    jw, jv, ji, jl = JG.score_post(jnp.asarray(logits), jnp.asarray(tokens, jnp.int32),
                                   top_n)
    w, v, i, last = G.score_post(torch.from_numpy(logits), torch.from_numpy(tokens), top_n)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl), atol=1e-6)
    assert v.shape == jv.shape and i.shape == ji.shape
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)


def _same_score(got, want):
    assert got["status"] == want["status"] == "success", (got, want)
    assert set(got) == set(want)
    for key in ("prompt", "prompt_tokens", "token_strings", "backend"):
        assert got[key] == want[key], key
    assert got["token_logprobs"][0] is None and want["token_logprobs"][0] is None
    np.testing.assert_allclose(got["token_logprobs"][1:], want["token_logprobs"][1:],
                               atol=1e-5, rtol=0)
    assert got["logprob_sum"] == pytest.approx(want["logprob_sum"], abs=1e-4)
    if "top_logprobs" in want:
        assert got["top_logprobs"][0] is None
        for g, w in zip(got["top_logprobs"][1:], want["top_logprobs"][1:]):
            assert list(g) == list(w)  # the same strings, best first
            np.testing.assert_allclose(list(g.values()), list(w.values()), atol=1e-5)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("prompt,top_n", [("top n check", 3), (LONG, 0), (LONG, 2)],
                         ids=["one-chunk-top3", "chunked", "chunked-top2"])
def test_engine_score_equals_jax(engines, impl, prompt, top_n):
    got, want = engines[impl].score(prompt, top_n=top_n), engines["jax"].score(
        prompt, top_n=top_n)
    _same_score(got, want)
    if prompt == LONG:
        assert got["prompt_tokens"] > 2 * BUCKETS[-1]


@pytest.mark.parametrize("prompt,top_n", [("", 0), ("ok here", 6), ("x" * 130, 0)],
                         ids=["too-short", "top-n", "too-long"])
def test_score_rejections_equal_jax(engines, prompt, top_n):
    got, want = engines["plain"].score(prompt, top_n=top_n), engines["jax"].score(
        prompt, top_n=top_n)
    assert got["status"] == want["status"] == "failed"
    assert got["error_type"] == want["error_type"] == "invalid_request"
    assert got["error"] == want["error"]
