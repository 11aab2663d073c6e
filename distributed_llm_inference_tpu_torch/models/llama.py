"""Llama-family decoder in PyTorch: the dense branch of the JAX package's
models/llama.py.

Parameters are a plain dictionary with the JAX package's layout, per-layer
tensors STACKED on a leading layer axis (models/bridge.py carries the JAX
pytree over as it is), and `forward_layers` is a Python loop over that
axis where the JAX package scans. The KV cache has the same stacked
layout and is written in place.

Params (L = n_layers, D = dim, H/KV heads, Dh = head_dim, F = ffn_dim,
V = vocab):
  embed       [V, D]
  layers:
    attn_norm [L, D]      mlp_norm [L, D]
    wq [L, D, H*Dh]  wk [L, D, KV*Dh]  wv [L, D, KV*Dh]  wo [L, H*Dh, D]
    w_gate [L, D, F]  w_up [L, D, F]  w_down [L, F, D]
    (+ bq/bk/bv, q_norm/k_norm, attn_post_norm/mlp_post_norm,
       window_flag, per the config flags)
  final_norm  [D]
  lm_head     [D, V]   (absent when tie_embeddings)

The projections and the untied LM head may be quantized (ops/quant.py:
QTensor int8 or Q4Tensor int4 leaves, sliced per layer like the dense
ones) and go through ops/quant.matmul; the KV cache may be int8
(ops/kv_quant.KVQuant leaves, cfg.kv_quant="int8"). With the adapter
pool's paged lora_{leaf}_{a,b} leaves [L, P, in, r] / [L, P, r, out]
(engine/adapters.py, always dense) and per-row `lora_pages`, every
projection adds its row's low-rank delta.

With cfg.n_experts the FFN is the MoE block (`moe_ffn`, Mixtral and
Qwen3-MoE): a router [L, D, E] and expert banks w_gate / w_up [L, E, D,
F], w_down [L, E, F, D], dense or int8 QTensor banks (ops/quant.
expert_einsum).

Tensor parallelism: with `tp_group` (a parallel/comm.Group), the layer
holds its tp rank's columns of wq / wk / wv / w_gate / w_up and rows of
wo / w_down, and sums the attention output and the FFN output over the
group, as the JAX package psums them. Pipeline stages need no update
gate in the port: a rank runs its stage's layers once, on the activation
it received (parallel/pipeline.py). Over an expert mesh (`ep_axis`, an
ep Group where the JAX package names the mesh axis) the layer holds its
ep rank's share of each expert bank, and moe_ffn sums the shares'
outputs over the group, as the JAX package psums them over ep.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import (
    attend,
    causal_mask,
    ragged_causal_mask,
    slot_causal_mask,
    update_kv_cache,
    update_kv_cache_slots,
)
from ..ops.flash_attention import flash_attend
from ..ops.kv_quant import KVQuant, init_quant_cache
from ..ops.kv_quant import dequantize as kv_dequantize
from ..ops.kv_quant import update_cache as kv_update
from ..ops.kv_quant import update_cache_slots as kv_update_slots
from ..ops.norms import rms_norm
from ..ops.quant import expert_einsum as eem
from ..ops.quant import matmul as mm
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.sampling import stable_top

Params = dict
KVCache = dict  # {"k": [L, B, KV, S, Dh], "v": [L, B, KV, S, Dh]}
# the profiler range over moe_ffn's expert products (parallel/pipeline.py's
# profile reports its device milliseconds per rank)
EXPERTS_RANGE = "moe_ffn.experts"



def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random weights (scaled normal, as the JAX init_params draws them),
    made on the generator's device in cfg.dtype, dense whatever cfg.quant
    says (runtime.create_engine quantizes them, as the JAX package does).
    An MoE config's expert banks are drawn one layer at a time into the
    stacked leaf, so no fp32 copy of a whole bank is ever held. The numbers
    differ from the JAX package's for the same seed: the two RNGs differ."""
    device = generator.device
    dt = cfg.torch_dtype
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * scale).to(dt)

    def norm_init(shape):
        # unit-offset norms (Gemma) multiply by (1 + w): neutral init is 0
        fill = torch.zeros if cfg.norm_unit_offset else torch.ones
        return fill(shape, dtype=dt, device=device)

    def bank(shape, scale):
        # [L, E, in, out], drawn layer by layer
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], scale)
        return out

    s = D ** -0.5
    layers = {
        "wq": normal((L, D, H * Dh), s),
        "wk": normal((L, D, KV * Dh), s),
        "wv": normal((L, D, KV * Dh), s),
        "wo": normal((L, H * Dh, D), s),
    }
    if cfg.n_experts:  # the MoE FFN: a router and the expert banks
        E = cfg.n_experts
        layers.update(
            w_router=normal((L, D, E), s),
            w_gate=bank((L, E, D, Fd), s),
            w_up=bank((L, E, D, Fd), s),
            w_down=bank((L, E, Fd, D), Fd ** -0.5),
        )
    else:
        layers.update(
            w_gate=normal((L, D, Fd), s),
            w_up=normal((L, D, Fd), s),
            w_down=normal((L, Fd, D), Fd ** -0.5),
        )
    params = {"embed": normal((V, D), 0.02), "layers": layers,
              "final_norm": norm_init((D,))}
    if cfg.pre_norms:
        layers["attn_norm"] = norm_init((L, D))
        layers["mlp_norm"] = norm_init((L, D))
    if cfg.post_norms:
        layers["attn_post_norm"] = norm_init((L, D))
        layers["mlp_post_norm"] = norm_init((L, D))
    wf = make_window_flags(cfg, device)
    if wf is not None:
        layers["window_flag"] = wf
    if cfg.attn_qkv_bias:
        layers["bq"] = torch.zeros((L, H * Dh), dtype=dt, device=device)
        layers["bk"] = torch.zeros((L, KV * Dh), dtype=dt, device=device)
        layers["bv"] = torch.zeros((L, KV * Dh), dtype=dt, device=device)
    if cfg.use_qk_norm:
        q_dim, k_dim = (H * Dh, KV * Dh) if cfg.qk_norm_dim == "proj" else (Dh, Dh)
        layers["q_norm"] = norm_init((L, q_dim))
        layers["k_norm"] = norm_init((L, k_dim))
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), s)
    return params


def make_window_flags(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """[L] float per-layer sliding-window flag for mixed attention
    patterns (Gemma-2 "even": even layers slide; Gemma-3: an explicit
    layer_types tuple), or None when the pattern is uniform."""
    if cfg.attn_window is None:
        return None
    if cfg.attn_window_layer_types is not None:
        return torch.tensor(cfg.attn_window_layer_types, dtype=torch.float32,
                            device=device)
    if cfg.attn_window_pattern != "even":
        return None
    idx = torch.arange(cfg.n_layers, device=device)
    return (idx % 2 == 0).float()


def kernel_window(cfg: ModelConfig, window_flag):
    """This layer's window for the attention kernel: (static, dynamic),
    exactly one live. Uniform configs keep the static cfg.attn_window;
    mixed patterns give a one-element int32 device tensor — the layer's
    width when flagged, -1 (= full causal) otherwise — so the kernel
    reads it on the device and the host never syncs on the flag."""
    if window_flag is None:
        return cfg.attn_window, None
    width = torch.where(window_flag > 0, cfg.attn_window, -1)
    return None, width.to(torch.int32).reshape(1)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: Optional[int] = None,
                  n_layers: Optional[int] = None, device=None) -> KVCache:
    """Zeroed static-shape KV cache, stacked on the layer axis: raw in
    cfg.dtype, or int8 data + per-(token, head) fp32 scales (KVQuant
    leaves) under cfg.kv_quant="int8"."""
    S = max_seq or cfg.max_seq_len
    L = n_layers if n_layers is not None else cfg.n_layers
    if cfg.kv_quant == "int8":
        return init_quant_cache(L, batch, cfg.n_kv_heads, S, cfg.head_dim,
                                device=device)
    shape = (L, batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
    }


def default_attn_hook(cfg, q, k, v, cache_k, cache_v, pos, mask, update_gate=None,
                      valid_start=None, window_flag=None):
    """Cache write + attention for the dense single-device case. Returns
    (attn [B,T,H,Dh], cache_k, cache_v); the caches are updated in place.

    attn_impl="kernel" routes T>1 chunks (prefill, chunked extend) to the
    flash kernel; T=1 decode always takes the plain einsum, the gate the
    JAX package keeps for its Pallas kernel. Per-row positions (slots
    mode: pos an int32 [B] tensor) write each row at its own offset and
    always take the plain einsum, as in the JAX package.

    An int8 cache (KVQuant leaves) quantizes on write; T>1 chunks at a
    scalar pos go to the flash kernel, which dequantizes in its tile
    prologue; T=1 steps and per-row positions dequantize, then attend, as
    the JAX package does."""
    slots = isinstance(pos, torch.Tensor) and pos.dim() == 1
    int8 = isinstance(cache_k, KVQuant)
    if int8:
        upd = kv_update_slots if slots else kv_update
        upd(cache_k, k, pos)
        upd(cache_v, v, pos)
    elif slots:
        update_kv_cache_slots(cache_k, cache_v, k, v, pos)
    else:
        update_kv_cache(cache_k, cache_v, k, v, pos)
    if cfg.attn_impl == "kernel" and not slots and q.shape[1] > 1:
        w, wd = kernel_window(cfg, window_flag)
        attn = flash_attend(
            q, cache_k, cache_v, pos, valid_start, wd, window=w,
            scale=cfg.query_scale, softcap=cfg.attn_softcap,
        )
    else:
        attn = attend(
            q, kv_dequantize(cache_k) if int8 else cache_k,
            kv_dequantize(cache_v) if int8 else cache_v, mask,
            scale=cfg.query_scale, softcap=cfg.attn_softcap,
        )
    return attn, cache_k, cache_v


def _gelu_tanh(x):
    """gelu_pytorch_tanh (Gemma's hidden activation)."""
    return F.gelu(x, approximate="tanh")


def moe_ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor,
            ep_axis=None) -> torch.Tensor:
    """The sparse MoE FFN on a (normed) chunk h [B, T, D], exactly as the
    JAX package computes it (HF MixtralSparseMoeBlock semantics): an fp32
    softmax over the router logits, top-k, the selected weights
    renormalised when cfg.moe_renormalize (Qwen3-MoE's norm_topk_prob),
    then every expert's SwiGLU output for every token and a masked
    weighted sum. All on the device: the top-k and the expert weights
    are never read back, so a launch stays one graph.

    lp holds this layer's router w_router [D, E] and banks w_gate / w_up
    [E, D, F], w_down [E, F, D], dense or int8 QTensor. With ep_axis
    (a parallel/comm.Group) the banks hold the rank's E / ep experts:
    the rank computes their share for every token, and one psum over the
    group sums the shares."""
    k = cfg.n_experts_per_tok
    probs = torch.softmax((h @ lp["w_router"]).float(), dim=-1)  # [B, T, E]
    # jax.lax.top_k's order: a bf16 router's tie at the k-th place picks
    # the same expert in both packages
    topw, topi = stable_top(probs, k)
    if cfg.moe_renormalize:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    # each selected expert's weight at its index, 0 elsewhere (the JAX
    # one-hot sum, whose every other term is an exact 0)
    weights = torch.zeros_like(probs).scatter(-1, topi, topw).to(h.dtype)
    if ep_axis is not None:
        e_loc = lp["w_router"].shape[-1] // ep_axis.size
        weights = weights[..., ep_axis.rank * e_loc:(ep_axis.rank + 1) * e_loc]
    # a profiler range (on the card, its device span: the bank products)
    with torch.profiler.record_function(EXPERTS_RANGE):
        gate = F.silu(eem("btd,edf->btef", h, lp["w_gate"]).float()).to(h.dtype)
        up = eem("btd,edf->btef", h, lp["w_up"])
        down = eem("btef,efd->bted", gate * up, lp["w_down"])
        out = torch.einsum("bted,bte->btd", down, weights)
    if ep_axis is not None:
        out = ep_axis.psum(out)
    return out


def decoder_layer(
    cfg: ModelConfig,
    lp: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: int,
    cos,
    sin,
    mask,
    tp_group=None,
    attn_hook=None,
    valid_start: Optional[torch.Tensor] = None,
    ep_axis=None,
    lora_pages=None,
):
    """One decoder block on a chunk x [B,T,D] at offset `pos`; lp holds
    this layer's params (no leading L axis). Returns (x, cache_k, cache_v).

    Covers every dense config flag: qkv bias (Qwen2), qk-norm per head
    (Qwen3/Gemma-3) or over the projection (OLMo-2), pre/post norms
    (Gemma-2 sandwich, OLMo-2 post-only), unit-offset norms, softcaps,
    static or per-layer windows, dual RoPE tables, Granite multipliers.

    lora_pages: optional [B] integer adapter-pool page ids (engine/
    adapters.AdapterPool), a device tensor, so one launch (and one CUDA
    graph) serves any adapter mix. When lp carries the paged
    lora_{leaf}_{a,b} leaves, every projection adds its row's low-rank
    delta (x @ a[page]) @ b[page]. Page 0 is the base page: its rows
    SELECT the undisturbed base product (torch.where, never + 0.0, which
    would turn a -0.0 into +0.0), bit-identical to the program without
    adapters.

    tp_group: this layer's tp shard sums its row-projection outputs (wo,
    w_down) over the group (parallel/comm.Group.psum); None off a tp mesh.
    ep_axis: this layer's expert share sums moe_ffn's output over the
    group; None off an ep mesh.
    """
    if cfg.n_experts and tp_group is not None:
        raise NotImplementedError(
            "MoE + tensor parallelism is not wired yet: shard experts "
            "over ep instead of splitting each expert over tp"
        )
    B, T, D = x.shape
    Dh = cfg.head_dim
    H = lp["wq"].shape[-1] // Dh
    KV = lp["wk"].shape[-1] // Dh
    uo = cfg.norm_unit_offset

    if isinstance(mask, tuple):
        # Gemma-2/3 mixed attention: (full, windowed) masks built once per
        # chunk; this layer's window_flag picks its own
        mask_full, mask_win = mask
        mask = torch.where(lp["window_flag"] > 0, mask_win, mask_full)

    on_page = None if lora_pages is None else (lora_pages > 0)[:, None, None]

    def lmm(hh, leaf):
        # mm: a dense leaf or a QTensor / Q4Tensor alike; the paged LoRA
        # delta rides on top where the leaves are installed
        out = mm(hh, lp[leaf])
        a = lp.get(f"lora_{leaf}_a")
        if on_page is None or a is None:
            return out
        u = torch.bmm(hh, a[lora_pages])  # [B, T, r]
        d = torch.bmm(u, lp[f"lora_{leaf}_b"][lora_pages])  # [B, T, out]
        return torch.where(on_page, out + d.to(out.dtype), out)

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps, unit_offset=uo) \
        if cfg.pre_norms else x
    q, k, v = lmm(h, "wq"), lmm(h, "wk"), lmm(h, "wv")
    if cfg.attn_qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.use_qk_norm and cfg.qk_norm_dim == "proj":
        # OLMo-2: RMSNorm over the WHOLE projection before the head split
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps, unit_offset=uo)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps, unit_offset=uo)
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, KV, Dh)
    v = v.reshape(B, T, KV, Dh)
    if cfg.use_qk_norm and cfg.qk_norm_dim == "head":
        # Qwen3/Gemma-3: per-head RMSNorm over head_dim, before RoPE
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps, unit_offset=uo)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps, unit_offset=uo)
    if isinstance(cos, tuple):
        # Gemma-3 dual RoPE: sliding layers use the local table
        flag = lp["window_flag"] > 0
        cos = torch.where(flag, cos[1], cos[0])
        sin = torch.where(flag, sin[1], sin[0])
    q, k = apply_rope(q, k, cos, sin)

    hook = attn_hook or default_attn_hook
    attn, cache_k, cache_v = hook(
        cfg, q, k, v, cache_k, cache_v, pos, mask, None, valid_start,
        lp.get("window_flag"),
    )
    attn_out = lmm(attn.reshape(B, T, H * Dh), "wo")
    if tp_group is not None:
        attn_out = tp_group.psum(attn_out)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, lp["attn_post_norm"], cfg.norm_eps, unit_offset=uo)
    if cfg.residual_multiplier is not None:  # Granite
        attn_out = attn_out * torch.tensor(cfg.residual_multiplier, dtype=x.dtype)
    x = x + attn_out

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps, unit_offset=uo) \
        if cfg.pre_norms else x
    if cfg.n_experts:
        mlp_out = moe_ffn(cfg, lp, h, ep_axis)
    else:
        act = F.silu if cfg.act == "silu" else _gelu_tanh
        gate = act(lmm(h, "w_gate").float()).to(h.dtype)
        mlp_out = lmm(gate * lmm(h, "w_up"), "w_down")
        if tp_group is not None:
            mlp_out = tp_group.psum(mlp_out)
    if cfg.post_norms:
        mlp_out = rms_norm(mlp_out, lp["mlp_post_norm"], cfg.norm_eps, unit_offset=uo)
    if cfg.residual_multiplier is not None:  # Granite
        mlp_out = mlp_out * torch.tensor(cfg.residual_multiplier, dtype=x.dtype)
    x = x + mlp_out
    return x, cache_k, cache_v


def forward_layers(
    cfg: ModelConfig,
    layers: Params,
    x: torch.Tensor,
    cache: KVCache,
    pos: int,
    tp_group=None,
    attn_hook=None,
    valid_start: Optional[torch.Tensor] = None,
    ep_axis=None,
    attn_seq_len: Optional[int] = None,
    lora_pages=None,
):
    """Run the stacked layers over a chunk, one Python iteration per
    layer. x: [B, T, D]; cache k/v: [L, B, KV, S, Dh] (written in place
    by the hook). pos: the chunk's first absolute position, an int — or,
    in slots mode (continuous batching), an int32 [B] tensor on x's
    device with each row's own position: RoPE and the causal mask go per
    row, and pos is never read back to the host. valid_start: optional
    int32 [B] — first real slot per row of a left-padded batch.
    attn_seq_len: the mask's logical length when it is not the cache
    leaf's sequence axis (the paged hooks of engine/paged.py, whose leaf
    is the block pool). tp_group: see decoder_layer. Returns (x, cache)."""
    slots = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if not slots:
        pos = int(pos)
    T = x.shape[1]
    S = attn_seq_len if attn_seq_len is not None else cache["k"].shape[3]
    device = x.device
    if slots:
        positions = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                                device=device)[None, :]
    else:
        positions = pos + torch.arange(T, dtype=torch.int32, device=device)
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta,
        scaling=cfg.rope_scaling,
        scaling_factor=cfg.rope_scaling_factor,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_len=cfg.rope_original_max_len,
    )
    if cfg.rope_local_theta is not None:
        # Gemma-3: sliding layers rotate with their own UNSCALED local theta
        cos_l, sin_l = rope_cos_sin(positions, cfg.head_dim, cfg.rope_local_theta)
        cos, sin = (cos, cos_l), (sin, sin_l)

    def make_mask(window):
        if slots:
            return slot_causal_mask(pos, T, S, window)
        if valid_start is None:
            return causal_mask(pos, T, S, window, device=device)
        return ragged_causal_mask(pos, T, S, valid_start, window)

    if lora_pages is not None:
        # one index conversion per launch step: int64 gathers in every layer
        lora_pages = lora_pages.long()
    if cfg.attn_impl == "kernel" and T > 1 and attn_hook is None and not slots:
        mask = None  # the kernel derives its mask from pos / valid_start / window
    elif slots and attn_hook is not None:
        mask = None  # the paged hooks derive their masks from pos / meta
    elif cfg.attn_window is not None and (
        cfg.attn_window_pattern == "even"
        or cfg.attn_window_layer_types is not None
    ):
        # Gemma-2/3 mixed attention: both masks built once per chunk
        mask = (make_mask(None), make_mask(cfg.attn_window))
    else:
        mask = make_mask(cfg.attn_window)

    for i in range(cache["k"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        x, _, _ = decoder_layer(
            cfg, lp, x, cache["k"][i], cache["v"][i], pos, cos, sin, mask,
            tp_group=tp_group, attn_hook=attn_hook, valid_start=valid_start,
            ep_axis=ep_axis, lora_pages=lora_pages,
        )
    return x, cache


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor, pos=0) -> torch.Tensor:
    """Token embedding lookup [B, T] -> [B, T, D]; Gemma scales by
    sqrt(dim) and Granite by embed_multiplier, in the activation dtype."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.dim ** 0.5, dtype=x.dtype)
    if cfg.embed_multiplier is not None:
        x = x * torch.tensor(cfg.embed_multiplier, dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm + LM head: [B, T, D] -> [B, T, V] fp32 logits, with
    Gemma-2's final softcap and Granite's logits divider."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 unit_offset=cfg.norm_unit_offset)
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].T).float()
    else:
        logits = mm(x, params["lm_head"]).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.logits_divider is not None:
        logits = logits / cfg.logits_divider
    return logits


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: KVCache, pos: int):
    """Full-model chunk forward: tokens [B,T] at offset pos -> (logits
    [B,T,V] fp32, cache). One call == prefill; a T=1 call == decode step."""
    x = embed(cfg, params, tokens)
    x, cache = forward_layers(cfg, params["layers"], x, cache, pos)
    return unembed(cfg, params, x), cache
