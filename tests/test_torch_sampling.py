"""PyTorch port vs JAX package: every sampling filter and penalty on the
same logits, and the greedy token.

The two RNGs draw different streams, so sampled tokens are never
compared; the filters are held to identical outputs (masked entries
exactly NEG_INF, kept entries to float32 rounding: rtol 1e-6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops import sampling as js  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import sampling as ts  # noqa: E402

V = 64


def _logits(seed, rows=3):
    return np.random.default_rng(seed).standard_normal((rows, V)).astype(np.float32) * 3


def same(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [0, 1, 5, V + 3])
def test_top_k_filter(k):
    x = _logits(k)
    same(ts.top_k_filter(torch.from_numpy(x), k), js.top_k_filter(jnp.asarray(x), jnp.int32(k)))


@pytest.mark.parametrize("p", [0.1, 0.9, 1.0])
def test_top_p_filter(p):
    x = _logits(int(p * 10))
    same(ts.top_p_filter(torch.from_numpy(x), p), js.top_p_filter(jnp.asarray(x), jnp.float32(p)))


@pytest.mark.parametrize("mp", [0.0, 0.05, 0.5])
def test_min_p_filter(mp):
    x = _logits(7)
    same(ts.min_p_filter(torch.from_numpy(x), mp), js.min_p_filter(jnp.asarray(x), jnp.float32(mp)))


def test_temperature_and_penalties():
    x = _logits(8)
    rng = np.random.default_rng(9)
    presence = rng.random((3, V)) < 0.3
    counts = rng.integers(0, 4, (3, V)).astype(np.int32)
    same(ts.apply_temperature(torch.from_numpy(x), 0.7),
         js.apply_temperature(jnp.asarray(x), 0.7))
    for pen in (0.0, 1.0, 1.3):
        same(ts.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(presence), pen),
             js.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(presence), jnp.float32(pen)))
    for f, p in ((0.0, 0.0), (0.5, 0.0), (0.3, 1.2)):
        same(ts.apply_oai_penalties(torch.from_numpy(x), torch.from_numpy(counts), f, p),
             js.apply_oai_penalties(jnp.asarray(x), jnp.asarray(counts), jnp.float32(f), jnp.float32(p)))


def test_greedy_token_with_bias_and_penalties():
    x = _logits(10)
    rng = np.random.default_rng(11)
    presence = rng.random((3, V)) < 0.3
    counts = rng.integers(0, 3, (3, V)).astype(np.int32)
    bias = np.zeros(V, np.float32)
    bias[17] = 5.0
    got = ts.sample_token(
        torch.Generator(), torch.from_numpy(x), 0.7, 50, 0.9, True, 0.0, 1.2,
        0.4, 0.2, presence=torch.from_numpy(presence),
        counts=torch.from_numpy(counts), bias=torch.from_numpy(bias),
    )
    want = js.sample_token(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.float32(0.7), jnp.int32(50),
        jnp.float32(0.9), jnp.bool_(True), jnp.float32(0.0), jnp.float32(1.2),
        jnp.float32(0.4), jnp.float32(0.2), presence=jnp.asarray(presence),
        counts=jnp.asarray(counts), bias=jnp.asarray(bias),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_draw_obeys_filters_and_seed():
    """A sampled token is always one top-k keeps, and a seed fixes it."""
    x = torch.from_numpy(_logits(12, rows=64))
    draw = lambda s: ts.sample_token(torch.Generator().manual_seed(s), x, 1.0, 3, 1.0, False)
    allowed = torch.topk(x, 3, dim=-1).indices
    tok = draw(5)
    assert (allowed == tok[:, None]).any(dim=-1).all()
    assert torch.equal(tok, draw(5))
    assert not torch.equal(tok, draw(6))


def test_top_n_probs():
    x = _logits(13)
    tp, ti = ts.top_n_probs(torch.from_numpy(x), 5)
    jp, ji = js.top_n_probs(jnp.asarray(x), 5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
