"""The flash kernel's plain twin vs the JAX package's Pallas `flash_attend`
(interpret mode on the CPU, as tests/conftest.py sets it). The CUDA
kernel vs its twin on the card is in test_torch_cuda.py.

CPU tolerance: rtol 1e-5, atol 2e-5 — that of tests/test_flash_attention.py
(fp32, summation order differs between a tiled online softmax and one
dense softmax)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops.flash_attention import flash_attend as jax_flash  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _inputs(seed, B, T, H, KV, Dh, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, S, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, S, Dh)).astype(np.float32))


# (B, T, H, KV, Dh, S, pos, valid_start, window, window_dyn, scale, softcap)
CASES = [
    (1, 16, 8, 2, 16, 64, 0, None, None, None, None, None),  # prefill at 0
    (2, 9, 4, 2, 8, 48, 13, None, None, None, None, None),  # chunk mid-sequence
    (2, 12, 4, 2, 8, 32, 4, [0, 6], None, None, None, None),  # left-padded rows
    (1, 20, 4, 1, 8, 64, 10, None, 7, None, None, None),  # static window
    (1, 20, 4, 2, 8, 64, 10, None, None, 6, None, None),  # per-layer window
    (1, 20, 4, 2, 8, 64, 10, None, None, -1, None, None),  # per-layer full
    (2, 8, 6, 3, 24, 40, 3, [2, 0], 5, None, 0.3, 20.0),  # all variants at once
]


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax_kernel(case):
    B, T, H, KV, Dh, S, pos, vs, window, wdyn, scale, softcap = case
    q, ck, cv = _inputs(B * 100 + T, B, T, H, KV, Dh, S)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        None if vs is None else jnp.asarray(vs, jnp.int32),
        None if wdyn is None else jnp.int32(wdyn),
        block_t=4, block_k=16, window=window, scale=scale, softcap=softcap,
    )
    got = fa.flash_attend(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), pos,
        None if vs is None else torch.tensor(vs, dtype=torch.int32),
        None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32),
        window=window, scale=scale, softcap=softcap,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_runs_twin_and_counts_no_launch():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 4, 2, 8, 16))
    before = fa.flash_attend.launches
    out = fa.flash_attend(q, ck, cv, 2)
    assert torch.equal(out, fa.flash_attend_plain(q, ck, cv, 2))
    assert fa.flash_attend.launches == before
    assert fa.resolve_kernel("cpu") is False
    assert fa.resolve_kernel("cuda") is True
    with pytest.raises(ValueError):
        fa.resolve_kernel("meta")
    # an int8 cache is KVQuant leaves (test_torch_kv_quant.py); a bare
    # int8 tensor has no scales
    with pytest.raises(TypeError, match="KVQuant"):
        fa.flash_attend(q, ck.to(torch.int8), cv.to(torch.int8), 2)
