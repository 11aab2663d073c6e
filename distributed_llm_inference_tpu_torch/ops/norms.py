"""Normalization ops (the JAX package's ops/norms.py in PyTorch).

Accumulation is in float32 whatever the activation dtype, matching HF
LlamaRMSNorm, and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
    unit_offset: bool = False,
) -> torch.Tensor:
    """RMSNorm: x / rms(x) * weight, variance in fp32.

    unit_offset=True multiplies by (1 + weight) instead (HF GemmaRMSNorm —
    the checkpoint stores w with neutral value 0, not 1)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm with affine params (GPT-2 family), fp32 accumulation."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * (var + eps) ** -0.5
    return (xf * weight.float() + bias.float()).to(x.dtype)
