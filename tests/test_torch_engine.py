"""PyTorch port vs JAX package: greedy generation through the whole solo
engine (tokenize, bucket plan, chunked prefill, early-exit decode,
detokenize) on test-llama-tiny with the byte tokenizer and the same
weights. Greedy output must be token-identical; the per-token
log-probabilities, which pin every emitted token, agree to atol 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (16, 32)  # a 32-token largest bucket: a 51-token prompt chunk-prefills


@pytest.fixture(scope="module")
def engines():
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    jax_engine = JaxEngine(jax_cfg(MODEL), params,
                           engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    port = create_engine(
        MODEL, params=params_from_numpy(get_model_config(MODEL), tree, "cpu"),
        engine_cfg=EngineConfig(prefill_buckets=BUCKETS), device="cpu",
    )
    return jax_engine, port


@pytest.mark.parametrize("prompt", [
    "Hello",  # one padded prefill bucket
    "The quick brown fox jumps over the lazy dog, twice.",  # extend + final chunk
])
def test_greedy_generate_token_identical(engines, prompt):
    jax_engine, port = engines
    kw = dict(max_tokens=12, greedy=True, chat=False, logprobs=True)
    want = jax_engine.generate(prompt, **kw)
    got = port.generate(prompt, **kw)
    assert got["status"] == want["status"] == "success", (got, want)
    for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason",
                "token_strings"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=1e-4)
    assert set(got) == set(want)


@pytest.mark.parametrize("extra", [
    {"repetition_penalty": 1.3, "frequency_penalty": 0.5, "presence_penalty": 0.2},
    {"logit_bias": {"101": 1.5}},
    {"stop": ["(a"]},  # inside this model's plain greedy text: it stops
])
def test_greedy_with_penalties_bias_and_stop_token_identical(engines, extra):
    """Penalties and logit bias act on the greedy argmax too, and a stop
    string decodes in escalating chunks: same tokens as the JAX engine."""
    jax_engine, port = engines
    kw = dict(max_tokens=20, greedy=True, chat=False, logprobs=True, **extra)
    want = jax_engine.generate("Hello there", **kw)
    got = port.generate("Hello there", **kw)
    assert got["status"] == want["status"] == "success", (got, want)
    for key in ("response", "tokens_generated", "finish_reason", "token_strings"):
        assert got[key] == want[key], key
    assert got.get("stopped") == want.get("stopped") == ("stop" in extra or None)


def test_greedy_batch_token_identical(engines):
    """The left-padded batch path (per-row valid_start)."""
    jax_engine, port = engines
    prompts = ["hi", "a somewhat longer prompt"]
    kw = dict(max_tokens=8, greedy=True, chat=False)
    want = jax_engine.generate_batch(prompts, **kw)
    got = port.generate_batch(prompts, **kw)
    assert got["status"] == want["status"] == "success"
    for g, w in zip(got["results"], want["results"]):
        assert g == w


def test_unported_request_features_are_invalid_requests(engines):
    """Beams, speculation and the solo prefix cache answer as the JAX
    engine answers them (they refused by name until the solo-engine
    features were ported); the meshes of part B of the SPMD item (sp, ep,
    microbatching) still raise, naming their heading (dp x pp x tp meshes
    are served since, tests/test_torch_pipeline.py)."""
    jax_engine, port = engines
    for kw in ({"num_beams": 2}, {"speculative": True, "greedy": True}):
        got = port.generate("hi", max_tokens=4, chat=False, **kw)
        want = jax_engine.generate("hi", max_tokens=4, chat=False, **kw)
        assert got["status"] == want["status"] == "success", (got, want)
        assert got["response"] == want["response"] and set(got) == set(want)
    # an engine with prefix_cache_entries > 0 serves solo requests through
    # its prefix snapshots, a repeat hitting
    prefixed = create_engine(MODEL, engine_cfg=EngineConfig(prefix_cache_entries=2),
                             device="cpu")
    for _ in range(2):
        r = prefixed.generate("hi " * 30, max_tokens=4, chat=False)
        assert r["status"] == "success", r
    assert r["prefix_cached_tokens"] == 64 and prefixed.stats()["prefix_cache"]["hits"] == 1
    from distributed_llm_inference_tpu_torch.config import MeshConfig

    # the mesh selection refuses what the JAX runtime refuses, in its
    # words, before a rank is spawned (the meshes it builds are held to
    # the JAX backends in test_torch_schedule.py, test_torch_context_parallel.py
    # and test_torch_moe.py)
    for kw, err, words in (
            ({"mesh_cfg": MeshConfig(ep=2)}, ValueError, "ep>1 needs an MoE model"),
            ({"mesh_cfg": MeshConfig(tp=2), "microbatches": 2}, ValueError,
             "needs a pipeline"),
            ({"mesh_cfg": MeshConfig(pp=2), "sp_strategy": "ulysses"}, ValueError,
             "needs a context-parallel mesh"),
            ({"mesh_cfg": MeshConfig(sp=2, ep=2)}, ValueError,
             "does not compose with microbatching")):
        with pytest.raises(err, match=words):
            create_engine(MODEL, device="cpu", **kw)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_engine(MODEL)
