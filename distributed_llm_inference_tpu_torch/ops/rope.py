"""Rotary position embeddings (the JAX package's ops/rope.py in PyTorch).

HF "rotate_half" semantics: inverse frequencies over even indices, angles
tiled twice, rotation by concat(-x2, x1); tables in float32.
"""

from __future__ import annotations

import math

import torch


def llama3_scaled_inv_freq(
    inv_freq: torch.Tensor,
    factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_len: int,
) -> torch.Tensor:
    """Llama-3.1/3.2 "llama3" rope_scaling of the inverse frequencies
    (transformers' `_compute_llama3_parameters`): wavelengths longer than
    original_max_len/low_freq_factor slow by `factor`, shorter than
    original_max_len/high_freq_factor are kept, the band between
    interpolates."""
    wavelen = 2.0 * math.pi / inv_freq
    low_freq_wavelen = original_max_len / low_freq_factor
    high_freq_wavelen = original_max_len / high_freq_factor
    smooth = (original_max_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    scaled = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, smoothed)
    return torch.where(wavelen < high_freq_wavelen, inv_freq, scaled)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    *,
    scaling: str | None = None,
    scaling_factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_len: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions [...] -> each [..., head_dim],
    float32, on the positions' device."""
    exponents = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling == "llama3":
        inv_freq = llama3_scaled_inv_freq(
            inv_freq, scaling_factor, low_freq_factor, high_freq_factor,
            original_max_len,
        )
    elif scaling == "linear":
        # HF "linear" rope_scaling: every frequency divides by the factor
        inv_freq = inv_freq / scaling_factor
    elif scaling is not None:
        raise ValueError(f"unsupported rope scaling {scaling!r}")
    angles = positions.float()[..., None] * inv_freq  # [..., head_dim/2]
    angles = torch.cat([angles, angles], dim=-1)  # [..., head_dim]
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [B,T,H,Dh] and k [B,T,KV,Dh]; cos/sin [T, Dh] or
    [B, T, Dh], broadcast over the head axis. Math in fp32."""
    if cos.dim() == 2:  # [T, Dh] -> [1, T, 1, Dh]
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:  # [B, T, Dh] -> [B, T, 1, Dh]
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos_b + _rotate_half(qf) * sin_b
    k_out = kf * cos_b + _rotate_half(kf) * sin_b
    return q_out.to(q.dtype), k_out.to(k.dtype)
