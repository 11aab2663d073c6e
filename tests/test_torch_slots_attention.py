"""PyTorch port vs JAX package: `flash_attend_slots`, T=1 decode over the
dense slot-fleet cache.

The port's plain twin (what the wrapper runs on CPU tensors) against the
Pallas kernel in interpret mode on the same numpy inputs, at the JAX
test's shapes (tests/test_paged.py: B=3, H=8, KV=2, Dh=16, S=44 — not a
multiple of the 16-key tile —, pos 0 / 17 / 43), full causal and a
13-key window: fp32 within atol = rtol = 2e-5, bf16 within 1e-2 (the
JAX kernel rounds its fp32 result to bf16 once, the twin likewise). A
finished slot frozen at pos = S attends all S keys, as in the JAX
kernel. The wrapper's launch half runs against a stand-in library that
checks every argument against the declared C signature (the CPU never
runs that half otherwise)."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.ops import paged_attention as JA  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import paged_attention as PA  # noqa: E402

B, H, KV, DH, S = 3, 8, 2, 16, 44
BLOCK_K = 16
ATOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _inputs(seed, dtype_name, pos):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    ck = rng.standard_normal((B, KV, S, DH)).astype(np.float32)
    cv = rng.standard_normal((B, KV, S, DH)).astype(np.float32)
    dt_j = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    dt_t = getattr(torch, dtype_name)
    jax_in = [jnp.asarray(a).astype(dt_j) for a in (q, ck, cv)]
    # bf16 through the same rounding on both sides: JAX's cast, read back
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt_t)
                for a in jax_in]
    pos = np.asarray(pos, np.int32)
    return jax_in + [jnp.asarray(pos)], torch_in + [torch.from_numpy(pos)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("pos", [[0, 17, S - 1], [S, 30, S]], ids=["live", "at_S"])
def test_slots_twin_matches_pallas_kernel(dtype_name, window, pos):
    jin, tin = _inputs(5, dtype_name, pos)
    want = JA.flash_attend_slots(*jin, block_k=BLOCK_K, window=window,
                                 interpret=True)
    got = PA.flash_attend_slots(*tin, block_k=BLOCK_K, window=window)
    assert got.shape == (B, 1, H, DH) and got.dtype == tin[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL[dtype_name], rtol=ATOL[dtype_name])


def test_slots_twin_is_attend_with_the_slot_mask_and_ignores_block_k():
    """The twin is ops/attention.attend over slot_causal_mask; a row at
    pos >= S attends every key, and block_k does not change the result."""
    from distributed_llm_inference_tpu_torch.ops.attention import attend

    _, (q, ck, cv, _) = _inputs(6, "float32", [0, 0, 0])
    pos = torch.tensor([S, 5, 2 * S], dtype=torch.int32)
    got = PA.flash_attend_slots(q, ck, cv, pos, block_k=8)
    assert torch.equal(got, PA.flash_attend_slots_plain(q, ck, cv, pos, block_k=32))
    full = attend(q[:1], ck[:1], cv[:1], torch.ones(1, 1, S, dtype=torch.bool))
    torch.testing.assert_close(got[:1], full, atol=2e-6, rtol=0)
    torch.testing.assert_close(got[2:], attend(q[2:], ck[2:], cv[2:],
                                               torch.ones(1, 1, S, dtype=torch.bool)),
                               atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="window"):
        PA.flash_attend_slots(q, ck, cv, pos, window=0)


def test_wrapper_launch_half_matches_the_c_signature(monkeypatch):
    from test_torch_kv_quant import _StandInLibrary

    lib = _StandInLibrary(PA.SIGNATURES)
    monkeypatch.setattr(PA, "resolve_kernel", lambda device: True)
    monkeypatch.setattr(PA, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    _, (q, ck, cv, pos) = _inputs(7, "bfloat16", [0, 17, S - 1])
    before = PA.flash_attend_slots.launches
    for window in (None, 13):
        out = PA.flash_attend_slots(q, ck, cv, pos, block_k=BLOCK_K, window=window)
        assert out.shape == q.shape and out.dtype == q.dtype
        name, args = lib.calls[-1]
        assert name == "dli_flash_attend_slots"
        # dtype code, B, H, KV, S, Dh, then the window and the fixed scale
        assert args[4:10] == (1, B, H, KV, S, DH)
        assert args[11] == (13 if window else -1)
        assert args[12] == pytest.approx(DH ** -0.5)
    assert PA.flash_attend_slots.launches == before + 2
    with pytest.raises(ValueError, match="int32"):
        PA.flash_attend_slots(q, ck, cv, pos.long())
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant, quantize_chunk

    with pytest.raises(TypeError, match="raw cache"):
        PA.flash_attend_slots(q, KVQuant(*quantize_chunk(ck)),
                              KVQuant(*quantize_chunk(cv)), pos)
    assert PA.flash_attend_slots.launches == before + 2
