"""GPT-2 family decoder in PyTorch: the JAX package's models/gpt2.py.

The same stacked-layer dictionary as models/llama.py (a Python loop over
the layer axis where the JAX package scans; the KV cache written in
place), with GPT-2's architecture: LayerNorm with bias, learned absolute
position embeddings, MHA with qkv biases, a gelu_new MLP, the tied LM
head. Cache writes and attention go through llama's `default_attn_hook`
seam (GPT-2 is GQA with a group of one), so the paged pool, the int8
cache and the flash kernel ride it as they ride llama.

Params:
  embed      [V, D]      pos_embed [P, D]
  layers:
    ln1_w/ln1_b [L, D]   ln2_w/ln2_b [L, D]
    wq/wk/wv [L, D, D]   bq/bk/bv [L, D]
    wo [L, D, D]         bo [L, D]
    w_fc [L, D, F]  b_fc [L, F]  w_proj [L, F, D]  b_proj [L, D]
  final_norm_w / final_norm_b [D]
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import ModelConfig
from ..ops.attention import causal_mask, slot_causal_mask
from ..ops.norms import layer_norm
from ..ops.quant import matmul as mm
from . import llama

Params = dict
KVCache = dict


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximate GELU (HF activation 'gelu_new'), fp32."""
    xf = x.float()
    c = math.sqrt(2.0 / math.pi)
    out = 0.5 * xf * (1.0 + torch.tanh(c * (xf + 0.044715 * xf ** 3)))
    return out.to(x.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random weights (normal 0.02, positions 0.01, as the JAX init draws
    them) on the generator's device in cfg.dtype. The numbers differ from
    the JAX package's for the same seed: the two RNGs differ."""
    device = generator.device
    dt = cfg.torch_dtype
    L, D, Fd, V, P = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size, cfg.max_seq_len

    def normal(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * scale).to(dt)

    def fill(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "embed": normal((V, D)),
        "pos_embed": normal((P, D), 0.01),
        "layers": {
            "ln1_w": fill((L, D), 1.0), "ln1_b": fill((L, D), 0.0),
            "ln2_w": fill((L, D), 1.0), "ln2_b": fill((L, D), 0.0),
            "wq": normal((L, D, D)), "wk": normal((L, D, D)), "wv": normal((L, D, D)),
            "bq": fill((L, D), 0.0), "bk": fill((L, D), 0.0), "bv": fill((L, D), 0.0),
            "wo": normal((L, D, D)), "bo": fill((L, D), 0.0),
            "w_fc": normal((L, D, Fd)), "b_fc": fill((L, Fd), 0.0),
            "w_proj": normal((L, Fd, D)), "b_proj": fill((L, D), 0.0),
        },
        "final_norm_w": fill((D,), 1.0),
        "final_norm_b": fill((D,), 0.0),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: Optional[int] = None,
                  n_layers: Optional[int] = None, device=None) -> KVCache:
    """llama's cache layout: MHA is GQA with n_kv_heads == n_heads."""
    return llama.init_kv_cache(cfg, batch, max_seq=max_seq, n_layers=n_layers,
                               device=device)


def decoder_layer(cfg, lp, x, cache_k, cache_v, pos, mask, attn_hook=None,
                  tp_group=None):
    """One GPT-2 block on a chunk x [B,T,D] at offset pos (an int, or a
    per-row [B] tensor). tp_group: the row-sharded wo / w_proj partial
    outputs are summed over it BEFORE their replicated biases are added
    (inside the sum they would be added tp times). Returns (x, cache_k,
    cache_v)."""
    B, T, D = x.shape
    Dh = cfg.head_dim
    H = lp["wq"].shape[-1] // Dh

    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
    q = (mm(h, lp["wq"]) + lp["bq"]).reshape(B, T, H, Dh)
    k = (mm(h, lp["wk"]) + lp["bk"]).reshape(B, T, H, Dh)
    v = (mm(h, lp["wv"]) + lp["bv"]).reshape(B, T, H, Dh)

    hook = attn_hook or llama.default_attn_hook
    attn, cache_k, cache_v = hook(cfg, q, k, v, cache_k, cache_v, pos, mask,
                                  None, None, None)
    attn_out = mm(attn.reshape(B, T, H * Dh), lp["wo"])
    if tp_group is not None:
        attn_out = tp_group.psum(attn_out)
    x = x + attn_out + lp["bo"]

    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
    mlp_out = mm(gelu_new(mm(h, lp["w_fc"]) + lp["b_fc"]), lp["w_proj"])
    if tp_group is not None:
        mlp_out = tp_group.psum(mlp_out)
    x = x + mlp_out + lp["b_proj"]
    return x, cache_k, cache_v


def forward_layers(cfg, layers, x, cache, pos, valid_start=None, ep_axis=None,
                   attn_hook=None, attn_seq_len=None, lora_pages=None,
                   tp_group=None):
    """Run the stacked GPT-2 blocks over a chunk. pos: the chunk's offset
    (an int), or a per-row int32 [B] tensor (slots mode: every slot starts
    at position 0, so learned absolute positions stay exact). attn_hook /
    attn_seq_len: the shared seam (paged pool, int8 cache). valid_start,
    ep_axis and lora_pages are refused: learned absolute positions are not
    shift-invariant, gpt2 has no MoE and no LoRA leaves. tp_group: see
    decoder_layer."""
    if lora_pages is not None:
        raise ValueError(
            f"lora_pages (runtime adapters) requires the llama family; "
            f"got {cfg.arch!r}"
        )
    if valid_start is not None:
        raise NotImplementedError(
            "gpt2 does not support ragged (valid_start) batches: learned "
            "absolute position embeddings are not shift-invariant"
        )
    if ep_axis is not None:
        raise NotImplementedError("gpt2 has no MoE layers (ep_axis)")
    slots = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if not slots:
        pos = int(pos)
    T = x.shape[1]
    S = attn_seq_len if attn_seq_len is not None else cache["k"].shape[3]
    if cfg.attn_impl == "kernel" and T > 1 and attn_hook is None and not slots:
        mask = None  # the kernel derives its mask from pos
    elif slots and attn_hook is not None:
        mask = None  # the paged hooks derive their masks from pos / meta
    elif slots:
        mask = slot_causal_mask(pos, T, S)
    else:
        mask = causal_mask(pos, T, S, device=x.device)
    for i in range(cache["k"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        x, _, _ = decoder_layer(cfg, lp, x, cache["k"][i], cache["v"][i], pos,
                                mask, attn_hook, tp_group)
    return x, cache


def _positions(P: int, positions: torch.Tensor) -> torch.Tensor:
    """Row indices of pos_embed, as the JAX gather takes them: a negative
    index counts from the end, then every index clamps into [0, P). A
    padding or finished row's placeholder position never leaves the table
    (on the card an out-of-range gather faults)."""
    positions = torch.where(positions < 0, positions + P, positions)
    return positions.clamp(0, P - 1).long()


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor, pos=0) -> torch.Tensor:
    """Token + learned position embeddings [B, T] -> [B, T, D]. pos: the
    chunk's offset (an int), or a per-row [B] tensor (slots mode)."""
    T = tokens.shape[1]
    pe = params["pos_embed"]
    x = params["embed"][tokens]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        ar = torch.arange(T, dtype=torch.int32, device=pos.device)
        return x + pe[_positions(pe.shape[0], pos[:, None] + ar[None, :])]
    ar = torch.arange(T, dtype=torch.int64, device=tokens.device)
    return x + pe[_positions(pe.shape[0], int(pos) + ar)][None]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + the tied head: [B, T, D] -> [B, T, V] fp32."""
    x = layer_norm(x, params["final_norm_w"], params["final_norm_b"], cfg.norm_eps)
    return (x @ params["embed"].T).float()


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: KVCache, pos: int):
    """Full-model chunk forward: (logits [B,T,V] fp32, cache)."""
    x = embed(cfg, params, tokens, pos)
    x, cache = forward_layers(cfg, params["layers"], x, cache, pos)
    return unembed(cfg, params, x), cache
