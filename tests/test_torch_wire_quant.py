"""PyTorch port vs JAX package: the int8 wire format (ops/wire_quant.py).

The same seeded numpy rows (gaussian rows, an outlier row, all-zero rows)
go through both packages' `quantize_rows`, in fp32 and as bf16 input: q
and s must be bit-equal. `wire_roundtrip` stays within one int8 step of
its input, `wire_bytes` equals the JAX formula, and the port's KV cache
quantizer `kv_quant.quantize_chunk` is `quantize_rows` (one
implementation for the cache and the wire, as in the JAX package).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from distributed_llm_inference_tpu.ops import wire_quant as JW  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import kv_quant as K  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import wire_quant as W  # noqa: E402


def _rows(seed: int, shape) -> np.ndarray:
    """Gaussian rows of `shape` [..., D]; the first row an outlier (one
    element 1e4 times the rest), the last two rows all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] *= 3.0
    flat[0, 1] = 1e4
    flat[-2:] = 0.0
    return x


SHAPES = [(4, 64), (2, 5, 128), (1, 1, 2048), (3, 7, 4, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_jax(shape, dtype):
    x = _rows(len(shape) * 7 + shape[-1], shape)
    if dtype == "bfloat16":
        xj = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        # both packages start from the same bf16 values
        np.testing.assert_array_equal(np.asarray(xj, np.float32), xt.float().numpy())
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = JW.quantize_rows(xj)
    qt, st = W.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(qt.shape) == shape and tuple(st.shape) == shape[:-1]
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wire_encode_decode_equal_jax(shape):
    """wire_encode / wire_decode / wire_roundtrip against the JAX
    functions: the dequantized fp32 rows bit-equal."""
    x = _rows(11 + shape[-1], shape)
    wj = JW.wire_encode(jnp.asarray(x))
    wt = W.wire_encode(torch.from_numpy(x))
    assert isinstance(wt, W.WireQuant) and "WireQuant" in repr(wt)
    np.testing.assert_array_equal(wt.q.numpy(), np.asarray(wj.q))
    back_j = JW.wire_decode(wj, jnp.float32)
    back_t = W.wire_decode(wt, torch.float32)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    np.testing.assert_array_equal(W.wire_roundtrip(torch.from_numpy(x)).numpy(),
                                  np.asarray(JW.wire_roundtrip(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roundtrip_within_one_step(dtype):
    """One wire crossing: shape and dtype kept, every element within half
    a step of its row measured in fp32 (within one step after the bf16
    restore), all-zero rows exactly zero."""
    x = torch.from_numpy(_rows(5, (2, 9, 256))).to(dtype)
    w = W.wire_encode(x)
    assert w.q.shape == x.shape and w.q.dtype == torch.int8
    assert w.s.shape == x.shape[:-1] and w.s.dtype == torch.float32
    back = W.wire_decode(w, x.dtype)
    assert back.shape == x.shape and back.dtype == dtype
    err32 = (W.wire_decode(w, torch.float32) - x.float()).abs()
    assert float((err32 - 0.5 * w.s[..., None]).max()) <= 1e-6 * float(w.s.max())
    err = (W.wire_roundtrip(x).float() - x.float()).abs()
    assert bool((err <= w.s[..., None]).all())
    assert float(back.reshape(-1, 256)[-2:].abs().max()) == 0.0


def test_outlier_row_keeps_its_own_scale():
    """Blowing up one token's row changes no OTHER row's round trip by a
    bit."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 32))
                         .astype(np.float32))
    spiked = x.clone()
    spiked[0, 2] *= 1e4
    base, spk = W.wire_roundtrip(x), W.wire_roundtrip(spiked)
    for t in (0, 1, 3):
        assert torch.equal(base[0, t], spk[0, t])
    assert float(spk[0, 2].abs().max()) > 1e3


@pytest.mark.parametrize("shape,itemsize,hops", [
    ((1, 1, 64), 4, 1), ((2, 3, 64), 4, 5), ((1, 13, 2048), 4, 2),
    ((8, 1, 2048), 2, 3), ((4, 16, 4, 64), 2, 1),
])
@pytest.mark.parametrize("quant", [False, True])
def test_wire_bytes_equal_jax(shape, itemsize, hops, quant):
    assert (W.wire_bytes(shape, itemsize, hops, quant=quant)
            == JW.wire_bytes(shape, itemsize, hops, quant=quant))


def test_wire_bytes_formula():
    # f32 [1, 1, 64]: 256 bytes raw vs 64 int8 + 4 scale
    assert W.wire_bytes((1, 1, 64), 4, 1, quant=False) == 256
    assert W.wire_bytes((1, 1, 64), 4, 1, quant=True) == 68


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_shares_the_wire_implementation(dtype):
    """quantize_chunk IS quantize_rows: a [B, T, KV, Dh] chunk gives the
    same bits through both, and the cache module holds no copy of its
    own."""
    import inspect

    x = torch.from_numpy(_rows(2, (2, 5, 4, 16))).to(dtype)
    q1, s1 = W.quantize_rows(x)
    q2, s2 = K.quantize_chunk(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert K.quantize_rows is W.quantize_rows
    assert "quantize_rows(x)" in inspect.getsource(K.quantize_chunk)
