"""Parameters for the port: carried over from the JAX package's pytree,
or drawn at random.

`params_from_numpy` takes the JAX package's parameter pytree with its
leaves as numpy arrays (`jax.tree.map(np.asarray, params)` on the JAX
side) and returns the same nested dictionary of torch tensors on
`device`, keeping the stacked [L, ...] layer layout, so the two packages
run the same weights. `init_params` draws random weights on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from . import api as M

# leaves that keep float32 whatever the model dtype (as in the JAX tree)
_FP32_LEAVES = ("window_flag",)


def params_from_numpy(cfg: ModelConfig, tree: dict, device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX pytree (numpy leaves, any float dtype including
    ml_dtypes' bfloat16) as torch tensors of `dtype` (default cfg's) on
    `device`."""
    dtype = dtype or cfg.torch_dtype

    def convert(name, leaf):
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        # via fp32 (exact for bf16); np.array copies, so the tensor owns
        # writable memory whatever the JAX side handed over
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        return t.to(device=device,
                    dtype=torch.float32 if name in _FP32_LEAVES else dtype)

    return {k: convert(k, v) for k, v in tree.items()}


def pool_from_numpy(cfg: ModelConfig, pool: dict, device,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's block pool ({"k", "v"} leaves [L, N, KV, bs, Dh]
    as numpy arrays) as torch tensors of `dtype` (default cfg's) on
    `device`, so a test can start both packages from the same pool."""
    dtype = dtype or cfg.torch_dtype
    return {
        name: torch.from_numpy(np.array(leaf, dtype=np.float32)).to(
            device=device, dtype=dtype)
        for name, leaf in pool.items()
    }


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


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random weights on the generator's device (see llama.init_params)."""
    return M.init_params(cfg, generator)
