"""PyTorch port vs JAX package: norms, RoPE, masks and the plain attention.

Same numpy inputs (fixed seeds) through both, fp32. Tolerance rtol 1e-5,
atol 2e-5: the two frameworks sum in different orders on the CPU, so
results agree to float32 rounding, not bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops import attention as jat  # noqa: E402
from distributed_llm_inference_tpu.ops import norms as jn  # noqa: E402
from distributed_llm_inference_tpu.ops import rope as jr  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import attention as tat  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import norms as tn  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import rope as tr  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    close(tn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, unit_offset),
          jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, unit_offset))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 7, 12), (12,), (12,)))
    close(tn.layer_norm(*map(torch.from_numpy, (x, w, b))),
          jn.layer_norm(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("scaling,theta", [(None, 10000.0), ("llama3", 500000.0),
                                           ("linear", 1e6)])
def test_rope_tables_and_rotation(scaling, theta):
    rng = np.random.default_rng(2)
    positions = np.arange(3, 3 + 9, dtype=np.int32)
    kw = dict(scaling=scaling, scaling_factor=8.0, original_max_len=64)
    tc, ts = tr.rope_cos_sin(torch.from_numpy(positions), 32, theta, **kw)
    jc, js = jr.rope_cos_sin(jnp.asarray(positions), 32, theta, **kw)
    close(tc, jc)
    close(ts, js)
    q = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    tq, tk = tr.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    jq, jk = jr.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    close(tq, jq)
    close(tk, jk)


@pytest.mark.parametrize("window", [None, 5])
def test_masks(window):
    np.testing.assert_array_equal(
        tat.causal_mask(7, 6, 24, window).numpy(),
        np.asarray(jat.causal_mask(jnp.int32(7), 6, 24, window)),
    )
    vs = np.array([0, 4, 9], np.int32)
    np.testing.assert_array_equal(
        tat.ragged_causal_mask(7, 6, 24, torch.from_numpy(vs), window).numpy(),
        np.asarray(jat.ragged_causal_mask(jnp.int32(7), 6, 24, jnp.asarray(vs), window)),
    )


def test_update_kv_cache():
    rng = np.random.default_rng(3)
    ck, cv = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((2, 3, 2, 8)).astype(np.float32) for _ in range(2))
    tk, tv = tat.update_kv_cache(*(torch.from_numpy(a.copy()) for a in (ck, cv, kn, vn)), 5)
    jk, jv = jat.update_kv_cache(*map(jnp.asarray, (ck, cv, kn, vn)), jnp.int32(5))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        tat.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), 14)


@pytest.mark.parametrize("ragged,scale,softcap", [
    (False, None, None), (True, None, None), (False, 0.3, 20.0),
])
def test_attend(ragged, scale, softcap):
    rng = np.random.default_rng(4)
    B, T, H, KV, Dh, S, pos = 2, 5, 4, 2, 16, 24, 6
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, KV, S, Dh)).astype(np.float32) for _ in range(2))
    if ragged:
        vs = np.array([0, 3], np.int32)
        tm = tat.ragged_causal_mask(pos, T, S, torch.from_numpy(vs))
        jm = jat.ragged_causal_mask(jnp.int32(pos), T, S, jnp.asarray(vs))
    else:
        tm = tat.causal_mask(pos, T, S)
        jm = jat.causal_mask(jnp.int32(pos), T, S)
    got = tat.attend(torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
                     tm, scale=scale, softcap=softcap)
    want = jat.attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jm,
                      scale=scale, softcap=softcap)
    close(got, want)
