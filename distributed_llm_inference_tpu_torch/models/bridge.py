"""Parameters for the port: carried over from the JAX package's pytree,
or drawn at random.

`params_from_numpy` takes the JAX package's parameter pytree with its
leaves as numpy arrays (`jax.tree.map(np.asarray, params)` on the JAX
side) and returns the same nested dictionary of torch tensors on
`device`, keeping the stacked [L, ...] layer layout, so the two packages
run the same weights. Quantized leaves of the JAX tree (its QTensor,
Q4Tensor and KVQuant, recognised by their q / s / g fields, as this
package imports nothing of the JAX one) become the port's classes with q
kept int8 and s fp32. `cache_from_numpy` and `slots_from_numpy` carry a
KV cache (dense or block pool, raw or int8) and the fleet's slot state
over the same way. Both families' trees carry over, an MoE tree's 4-D
expert banks (dense, or the JAX package's int8 QTensor banks with their
[L, E, out] scales) included. `params_to` moves a parameter dictionary
(from the converter or the checkpoint store) onto a device.
`init_params` draws random weights on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.kv_quant import KVQuant
from ..ops.quant import Q4Tensor, QTensor
from . import api as M

# leaves that keep float32 whatever the model dtype (as in the JAX tree)
_FP32_LEAVES = ("window_flag",)


def _quantized(leaf, device):
    """(q int8, s fp32) on `device` of a quantized leaf of the JAX tree,
    or None for a plain array."""
    if not (hasattr(leaf, "q") and hasattr(leaf, "s")):
        return None
    return (torch.from_numpy(np.array(leaf.q, dtype=np.int8)).to(device),
            torch.from_numpy(np.array(leaf.s, dtype=np.float32)).to(device))


def params_from_numpy(cfg: ModelConfig, tree: dict, device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX pytree (numpy leaves, any float dtype including
    ml_dtypes' bfloat16) as torch tensors of `dtype` (default cfg's) on
    `device`; QTensor / Q4Tensor leaves (the JAX quantize_params output)
    keep their int8 data and fp32 scales."""
    dtype = dtype or cfg.torch_dtype

    def convert(name, leaf):
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        qs = _quantized(leaf, device)
        if qs is not None:
            return Q4Tensor(*qs, leaf.g) if hasattr(leaf, "g") else QTensor(*qs)
        # via fp32 (exact for bf16); np.array copies, so the tensor owns
        # writable memory whatever the JAX side handed over
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        return t.to(device=device,
                    dtype=torch.float32 if name in _FP32_LEAVES else dtype)

    return {k: convert(k, v) for k, v in tree.items()}


def cache_from_numpy(cfg: ModelConfig, cache: dict, device,
                     dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's KV cache ({"k", "v"} leaves as numpy arrays, or
    KVQuant leaves of numpy int8 data and fp32 scales) as torch tensors of
    `dtype` (default cfg's) or KVQuant leaves on `device`, so a test can
    start both packages from the same cache: the dense fleet's [L, B, KV,
    S, Dh] cache or the block pool [L, N, KV, bs, Dh] alike."""
    dtype = dtype or cfg.torch_dtype

    def convert(leaf):
        qs = _quantized(leaf, device)
        if qs is not None:
            return KVQuant(*qs)
        return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return {name: convert(leaf) for name, leaf in cache.items()}


def slots_from_numpy(state, sparams, device):
    """The JAX package's (SlotState, SlotParams) with numpy leaves as the
    port's, field for field, in the port's dtypes on `device`."""
    from ..engine import generate as G

    state_dt = (torch.int32, torch.int32, torch.bool, torch.int32, torch.bool,
                torch.int32)
    st = G.SlotState(*(torch.from_numpy(np.array(a)).to(device=device, dtype=dt)
                       for a, dt in zip(state, state_dt)))
    sp = G.SlotParams(*(torch.from_numpy(np.array(a)).to(device=device, dtype=dt)
                        for a, dt in zip(sparams, G.SLOT_PARAM_DTYPES)))
    return st, sp


def params_to(params: dict, device) -> dict:
    """The parameter dictionary on `device` (leaves already there are kept,
    not copied); QTensor / Q4Tensor leaves move their data and scales."""

    def move(leaf):
        if isinstance(leaf, dict):
            return {k: move(v) for k, v in leaf.items()}
        if isinstance(leaf, Q4Tensor):
            return Q4Tensor(leaf.q.to(device), leaf.s.to(device), leaf.g)
        if isinstance(leaf, QTensor):
            return QTensor(leaf.q.to(device), leaf.s.to(device))
        return leaf.to(device)

    return move(params)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random weights on the generator's device (see llama.init_params)."""
    return M.init_params(cfg, generator)
