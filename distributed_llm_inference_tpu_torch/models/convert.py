"""HuggingFace checkpoints to the port's params: the JAX package's
models/convert.py, and a safetensors writer.

  * `config_from_hf` maps a transformers config (or config.json read
    without transformers, `_JsonConfig`) of every model_type the JAX
    converter takes to the port's ModelConfig;
  * `llama_params_from_state_dict` / `gpt2_params_from_state_dict` turn a
    HF state dict (torch tensors or numpy arrays) into the stacked-layer
    parameter dictionary of models/llama.py / models/gpt2.py, array for
    array what the JAX converter makes (projections transposed to [in,
    out], fused projections split, MoE experts stacked [L, E, in, out]);
  * `load_hf_checkpoint(dir)` reads config.json and the safetensors
    files (one, a sharded index, or every *.safetensors present) with
    the zero-copy mmap reader below: no torch model is ever built and
    `transformers` is not needed.

The reader returns numpy views. BF16 has no numpy dtype without
`ml_dtypes`, which the card's machine lacks: a BF16 tensor's bits come
back in a uint16 carrier whose dtype is marked `BF16` (`is_bf16`),
widened exactly to float32 by `as_float32`; where such bits become a
tensor they are viewed as torch.bfloat16.

CLI (conversion to the local checkpoint store, models/checkpoint.py; the
tokenizer files of the source directory are copied beside it):
  python -m distributed_llm_inference_tpu_torch.models.convert \
      --in <hf_checkpoint_dir> --out <ckpt_dir> [--dtype bfloat16] [--name N]
"""

from __future__ import annotations

import glob
import json
import mmap
import os
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ModelConfig

def _leaf(t, dt: torch.dtype) -> torch.Tensor:
    """A state-dict value (a torch tensor, a numpy array, or BF16 bits in
    the carrier) as a CPU tensor of dtype dt, with the JAX converter's
    values: widened to float32, then rounded to nearest even. BF16 bits
    asked for as bfloat16 are taken as they are (the same values, with no
    float32 copy)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t if t.dtype == dt and dt in (torch.float32, torch.bfloat16) \
            else t.float().to(dt)
    if is_bf16(t) and dt == torch.bfloat16:
        # a copy: the reader's arrays are read-only views of the file
        return torch.from_numpy(np.array(t).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(as_float32(np.asarray(t)))).to(dt)


def config_from_hf(hf_cfg: Any, name: str = "converted", dtype: str = "float32") -> ModelConfig:
    """Map a transformers LlamaConfig/GPT2Config/Qwen2Config (or a
    `_JsonConfig`) to the port's ModelConfig, as the JAX converter does."""
    mt = getattr(hf_cfg, "model_type", "llama")
    if mt == "gpt2":
        return ModelConfig(
            name=name,
            arch="gpt2",
            vocab_size=hf_cfg.vocab_size,
            dim=hf_cfg.n_embd,
            n_layers=hf_cfg.n_layer,
            n_heads=hf_cfg.n_head,
            n_kv_heads=hf_cfg.n_head,
            ffn_dim=hf_cfg.n_inner if hf_cfg.n_inner is not None else 4 * hf_cfg.n_embd,
            max_seq_len=hf_cfg.n_positions,
            norm_eps=hf_cfg.layer_norm_epsilon,
            tie_embeddings=True,
            use_learned_pos=True,
            dtype=dtype,
            eos_token_id=hf_cfg.eos_token_id if hf_cfg.eos_token_id is not None else 50256,
            bos_token_id=hf_cfg.bos_token_id if hf_cfg.bos_token_id is not None else 50256,
            pad_token_id=hf_cfg.eos_token_id if hf_cfg.eos_token_id is not None else 50256,
        )
    # Qwen2 carries a sliding_window value but gates it off by default
    window = getattr(hf_cfg, "sliding_window", None)
    if mt == "qwen2" and not getattr(hf_cfg, "use_sliding_window", False):
        window = None
    # Gemma / Gemma-2 (llama-family variants): unit-offset RMSNorm, GeGLU,
    # sqrt(dim)-scaled embeddings, explicit head_dim, tied embeddings;
    # Gemma-2 adds sandwich norms, logit softcaps, query_pre_attn_scalar,
    # and sliding window on even-indexed layers only.
    gemma_kw = {}
    if mt in ("gemma", "gemma2"):
        gemma_kw = dict(
            norm_unit_offset=True,
            act="gelu_tanh",
            embed_scale=True,
            head_dim_override=getattr(hf_cfg, "head_dim", None),
            chat_template="gemma",
        )
        if mt == "gemma2":
            gemma_kw.update(
                post_norms=True,
                attn_softcap=getattr(hf_cfg, "attn_logit_softcapping", None),
                final_softcap=getattr(hf_cfg, "final_logit_softcapping", None),
                query_scale_override=getattr(
                    hf_cfg, "query_pre_attn_scalar", None
                ),
                attn_window_pattern="even",
            )
        else:
            window = None  # gemma-1 is full-causal everywhere
    elif mt == "phi3":
        # llama semantics with fused projections (split at load time) and
        # the <|user|>/<|assistant|>/<|end|> chat format
        gemma_kw = dict(chat_template="phi3")
    elif mt == "qwen3":
        # Qwen3: per-head q/k RMSNorm before RoPE, explicit head_dim
        # (often != dim/n_heads), NO qkv biases (dropped from Qwen2)
        gemma_kw = dict(
            use_qk_norm=True,
            head_dim_override=getattr(hf_cfg, "head_dim", None),
        )
    elif mt in ("gemma3_text", "gemma3"):
        if mt == "gemma3" or not hasattr(hf_cfg, "num_hidden_layers"):
            raise ValueError(
                "multimodal gemma3 checkpoints are not supported; convert "
                "the text model (model_type gemma3_text)"
            )
        # Gemma-3 text: gemma-2 bones (unit norms, GeGLU, embed scale,
        # sandwich norms, query scale) MINUS softcaps, PLUS unit-offset
        # qk-norm, an explicit 5-sliding:1-full layer pattern, and dual
        # RoPE (local theta on sliding layers; optional linear scaling on
        # the global table)
        raw_types = tuple(getattr(hf_cfg, "layer_types", ()) or ())
        unknown_types = set(raw_types) - {
            "sliding_attention", "full_attention"
        }
        if unknown_types:
            raise ValueError(
                f"gemma3 layer_types has unsupported entries "
                f"{sorted(unknown_types)} — converting would silently "
                f"treat them as full attention"
            )
        layer_types = tuple(
            1 if t == "sliding_attention" else 0 for t in raw_types
        ) or None
        if layer_types is None:
            # released gemma-3 config.json files carry the pattern as
            # sliding_window_pattern=p (every p-th layer full) instead of
            # an explicit layer_types list; Gemma3TextConfig derives one
            # in __init__ but the raw-JSON checkpoint path does not
            p_every = getattr(hf_cfg, "sliding_window_pattern", None)
            if p_every:
                layer_types = tuple(
                    1 if (i + 1) % int(p_every) else 0
                    for i in range(hf_cfg.num_hidden_layers)
                )
        rs = getattr(hf_cfg, "rope_scaling", None)
        g3_rope = {}
        if isinstance(rs, dict) and rs:
            if rs.get("rope_type", rs.get("type")) != "linear":
                raise ValueError(
                    f"gemma3 rope_scaling {rs!r} unsupported (linear only)"
                )
            g3_rope = dict(
                rope_scaling="linear",
                rope_scaling_factor=float(rs.get("factor", 8.0)),
            )
        gemma_kw = dict(
            norm_unit_offset=True,
            act="gelu_tanh",
            embed_scale=True,
            post_norms=True,
            use_qk_norm=True,
            head_dim_override=getattr(hf_cfg, "head_dim", None),
            query_scale_override=getattr(
                hf_cfg, "query_pre_attn_scalar", None
            ),
            attn_window_layer_types=layer_types,
            rope_local_theta=getattr(hf_cfg, "rope_local_base_freq", None),
            chat_template="gemma",
            **g3_rope,
        )
    elif mt == "granite":
        # IBM Granite: llama structure + four scalar multipliers
        gemma_kw = dict(
            embed_multiplier=float(getattr(hf_cfg, "embedding_multiplier", 1.0)),
            residual_multiplier=float(getattr(hf_cfg, "residual_multiplier", 1.0)),
            attn_scale_override=float(getattr(hf_cfg, "attention_multiplier", 1.0)),
            logits_divider=float(getattr(hf_cfg, "logits_scaling", 1.0)),
        )
    elif mt == "olmo2":
        # OLMo-2: NO pre-sublayer norms (the residual adds
        # norm(sublayer(x))), RMSNorm over the WHOLE q/k projection
        gemma_kw = dict(
            pre_norms=False,
            post_norms=True,
            use_qk_norm=True,
            qk_norm_dim="proj",
        )
    elif mt == "qwen3_moe":
        # Qwen3-MoE: qwen3 attention + a Mixtral-shaped expert bank with
        # its own intermediate size and an optional top-k renormalization
        if getattr(hf_cfg, "mlp_only_layers", None) or getattr(
            hf_cfg, "decoder_sparse_step", 1
        ) != 1:
            raise ValueError(
                "qwen3_moe checkpoints with dense layers (mlp_only_layers "
                "/ decoder_sparse_step != 1) are not supported: the "
                "stacked-layer scan assumes a uniform layer shape"
            )
        gemma_kw = dict(
            use_qk_norm=True,
            head_dim_override=getattr(hf_cfg, "head_dim", None),
            moe_renormalize=bool(getattr(hf_cfg, "norm_topk_prob", False)),
        )
    # Phi-3 instruct ends its turn with <|end|> (32007), but config.json
    # only carries the scalar eos 32000 (the extra stops live in
    # generation_config.json, which a weights-only conversion never sees) —
    # without it generation sails past end-of-turn into hallucinated
    # follow-on turns. Guarded by vocab size so tiny test configs are
    # unaffected.
    extra_stops = tuple(_eos_list(hf_cfg)[1:])
    if mt == "phi3" and hf_cfg.vocab_size > 32007 and 32007 not in extra_stops:
        extra_stops += (32007,)
    # Llama-3.1/3.2 "llama3" rope_scaling: affects frequencies at every
    # position, so silently ignoring it would convert a checkpoint into one
    # that produces wrong logits everywhere. Unsupported types fail loudly.
    rs = getattr(hf_cfg, "rope_scaling", None) or {}
    rs_type = rs.get("rope_type", rs.get("type")) if isinstance(rs, dict) else None
    rope_kw = {}
    if mt in ("gemma3_text", "gemma3"):
        rs_type = None  # gemma3 parsed its (linear) scaling above
    if rs_type in (None, "default"):
        pass
    elif rs_type == "llama3":
        rope_kw = dict(
            rope_scaling="llama3",
            rope_scaling_factor=float(rs.get("factor", 8.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_len=int(
                rs.get("original_max_position_embeddings", 8192)
            ),
        )
    else:
        raise ValueError(
            f"unsupported rope_scaling type {rs_type!r} (supported: llama3)"
        )
    # expert count: Mixtral names it num_local_experts, Qwen3-MoE
    # num_experts; experts may use their own intermediate size
    n_experts = (
        getattr(hf_cfg, "num_local_experts", None)
        or (getattr(hf_cfg, "num_experts", None) if mt == "qwen3_moe" else None)
        or 0
    )
    ffn_dim = hf_cfg.intermediate_size
    if mt == "qwen3_moe":
        ffn_dim = hf_cfg.moe_intermediate_size
    return ModelConfig(
        name=name,
        arch="llama",
        n_experts=n_experts,
        n_experts_per_tok=getattr(hf_cfg, "num_experts_per_tok", None) or 2,
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        ffn_dim=ffn_dim,
        max_seq_len=hf_cfg.max_position_embeddings,
        norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        **rope_kw,
        # Mistral-style sliding window (HF: None/absent = full causal)
        attn_window=window,
        **gemma_kw,
        # Qwen2-style q/k/v biases: Qwen2 has them unconditionally; Llama
        # exposes the optional `attention_bias` flag
        attn_qkv_bias=bool(getattr(hf_cfg, "attention_bias", False)) or mt == "qwen2",
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        dtype=dtype,
        # HF eos_token_id may be a LIST (Llama-3.1's [128001,128008,128009],
        # gemma-it's [1,107]): the first is the primary eos, the rest become
        # extra stop tokens so chat turns actually terminate
        eos_token_id=_eos_list(hf_cfg)[0],
        stop_token_ids=extra_stops,
        bos_token_id=hf_cfg.bos_token_id if hf_cfg.bos_token_id is not None else 1,
        pad_token_id=hf_cfg.pad_token_id if hf_cfg.pad_token_id is not None else 0,
    )


def _eos_list(hf_cfg) -> list:
    e = hf_cfg.eos_token_id
    if e is None:
        return [2]
    if isinstance(e, (list, tuple)):
        return list(e) if e else [2]
    return [e]


def llama_params_from_state_dict(sd: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """Convert a HF llama-family `state_dict()` into the stacked params.

    torch Linear stores weight as [out, in]; the port's matmuls are x @ W
    with W [in, out], so every projection is transposed once here."""
    from .llama import make_window_flags

    dt = cfg.torch_dtype
    L = cfg.n_layers
    p = lambda k: _leaf(sd[k], dt)  # noqa: E731

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        mats = [p(fmt.format(i)) for i in range(L)]
        return torch.stack([m.T if transpose else m for m in mats]).contiguous()

    # Phi-3 fuses q/k/v into qkv_proj [(H+2KV)*Dh, D] and gate/up into
    # gate_up_proj [2F, D]: split into the canonical stacked leaves
    fused_qkv = "model.layers.0.self_attn.qkv_proj.weight" in sd
    fused_gate_up = "model.layers.0.mlp.gate_up_proj.weight" in sd
    H, KV, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim

    def stack_rows(fmt: str, lo: int, hi: int) -> torch.Tensor:
        """Stack rows [lo:hi) of a fused [out, in] projection, transposed."""
        return torch.stack([p(fmt.format(i))[lo:hi].T for i in range(L)]).contiguous()

    layers = {"wo": stack("model.layers.{}.self_attn.o_proj.weight", True)}
    params = {
        "embed": p("model.embed_tokens.weight").contiguous(),
        "layers": layers,
        "final_norm": p("model.norm.weight").contiguous(),
    }
    if cfg.pre_norms:
        layers["attn_norm"] = stack("model.layers.{}.input_layernorm.weight", False)
        # Gemma-2 renames the MLP pre-norm: post_attention_layernorm is the
        # ATTENTION post-norm and pre_feedforward_layernorm the MLP pre-norm
        layers["mlp_norm"] = stack(
            "model.layers.{}.pre_feedforward_layernorm.weight" if cfg.post_norms
            else "model.layers.{}.post_attention_layernorm.weight", False)
    if fused_qkv:
        qkv = "model.layers.{}.self_attn.qkv_proj.weight"
        layers["wq"] = stack_rows(qkv, 0, H * Dh)
        layers["wk"] = stack_rows(qkv, H * Dh, (H + KV) * Dh)
        layers["wv"] = stack_rows(qkv, (H + KV) * Dh, (H + 2 * KV) * Dh)
    else:
        layers["wq"] = stack("model.layers.{}.self_attn.q_proj.weight", True)
        layers["wk"] = stack("model.layers.{}.self_attn.k_proj.weight", True)
        layers["wv"] = stack("model.layers.{}.self_attn.v_proj.weight", True)
    if cfg.post_norms:
        layers["attn_post_norm"] = stack(
            "model.layers.{}.post_attention_layernorm.weight", False)
        layers["mlp_post_norm"] = stack(
            "model.layers.{}.post_feedforward_layernorm.weight", False)
    wf = make_window_flags(cfg)
    if wf is not None:
        layers["window_flag"] = wf
    if cfg.n_experts:
        # the expert bank and router, under either naming: Mixtral
        # (block_sparse_moe, w1 = gate / w3 = up / w2 = down) or Qwen3-MoE
        # (mlp.experts.E.gate_proj / up_proj / down_proj, mlp.gate)
        if "model.layers.0.block_sparse_moe.gate.weight" in sd:
            moe_pref = "model.layers.{}.block_sparse_moe"
            names = {"gate": "w1", "up": "w3", "down": "w2"}
        else:
            moe_pref = "model.layers.{}.mlp"
            names = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}

        def stack_experts(role: str) -> torch.Tensor:
            # [L, E, in, out], filled one expert at a time
            def w(i, e):
                return p(f"{moe_pref.format(i)}.experts.{e}.{names[role]}.weight").T

            first = w(0, 0)
            out = torch.empty((L, cfg.n_experts, *first.shape), dtype=dt)
            for i in range(L):
                for e in range(cfg.n_experts):
                    out[i, e] = w(i, e)
            return out

        layers.update(
            w_router=stack(moe_pref + ".gate.weight", True),
            w_gate=stack_experts("gate"),
            w_up=stack_experts("up"),
            w_down=stack_experts("down"),
        )
    elif fused_gate_up:
        gu = "model.layers.{}.mlp.gate_up_proj.weight"
        layers.update(
            w_gate=stack_rows(gu, 0, F),
            w_up=stack_rows(gu, F, 2 * F),
            w_down=stack("model.layers.{}.mlp.down_proj.weight", True),
        )
    else:
        layers.update(
            w_gate=stack("model.layers.{}.mlp.gate_proj.weight", True),
            w_up=stack("model.layers.{}.mlp.up_proj.weight", True),
            w_down=stack("model.layers.{}.mlp.down_proj.weight", True),
        )
    if cfg.attn_qkv_bias:
        layers["bq"] = stack("model.layers.{}.self_attn.q_proj.bias", False)
        layers["bk"] = stack("model.layers.{}.self_attn.k_proj.bias", False)
        layers["bv"] = stack("model.layers.{}.self_attn.v_proj.bias", False)
    elif "model.layers.0.self_attn.q_proj.bias" in sd:
        raise ValueError(
            "checkpoint has q/k/v projection biases but cfg.attn_qkv_bias is "
            "False — converting would silently drop them"
        )
    if cfg.use_qk_norm:
        layers["q_norm"] = stack("model.layers.{}.self_attn.q_norm.weight", False)
        layers["k_norm"] = stack("model.layers.{}.self_attn.k_norm.weight", False)
    elif "model.layers.0.self_attn.q_norm.weight" in sd:
        raise ValueError(
            "checkpoint has q/k norms but cfg.use_qk_norm is False — "
            "converting would silently drop them"
        )
    if not cfg.tie_embeddings:
        params["lm_head"] = p("lm_head.weight").T.contiguous()
    return params


def gpt2_params_from_state_dict(sd: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """Convert a HF GPT-2 `state_dict()` into the stacked params. GPT-2's
    Conv1D weights are already [in, out] (no transpose); the fused qkv
    projection c_attn [D, 3D] is split."""
    dt = cfg.torch_dtype
    L, D = cfg.n_layers, cfg.dim

    def p(k):
        return _leaf(sd[k], dt).contiguous()

    def stack(fmt: str) -> torch.Tensor:
        return torch.stack([p(fmt.format(i)) for i in range(L)])

    c_attn_w = stack("transformer.h.{}.attn.c_attn.weight")  # [L, D, 3D]
    c_attn_b = stack("transformer.h.{}.attn.c_attn.bias")  # [L, 3D]
    return {
        "embed": p("transformer.wte.weight"),
        "pos_embed": p("transformer.wpe.weight"),
        "layers": {
            "ln1_w": stack("transformer.h.{}.ln_1.weight"),
            "ln1_b": stack("transformer.h.{}.ln_1.bias"),
            "ln2_w": stack("transformer.h.{}.ln_2.weight"),
            "ln2_b": stack("transformer.h.{}.ln_2.bias"),
            "wq": c_attn_w[:, :, :D].contiguous(),
            "wk": c_attn_w[:, :, D: 2 * D].contiguous(),
            "wv": c_attn_w[:, :, 2 * D:].contiguous(),
            "bq": c_attn_b[:, :D].contiguous(),
            "bk": c_attn_b[:, D: 2 * D].contiguous(),
            "bv": c_attn_b[:, 2 * D:].contiguous(),
            "wo": stack("transformer.h.{}.attn.c_proj.weight"),
            "bo": stack("transformer.h.{}.attn.c_proj.bias"),
            "w_fc": stack("transformer.h.{}.mlp.c_fc.weight"),
            "b_fc": stack("transformer.h.{}.mlp.c_fc.bias"),
            "w_proj": stack("transformer.h.{}.mlp.c_proj.weight"),
            "b_proj": stack("transformer.h.{}.mlp.c_proj.bias"),
        },
        "final_norm_w": p("transformer.ln_f.weight"),
        "final_norm_b": p("transformer.ln_f.bias"),
    }


def _params_from_state_dict(sd: Mapping[str, Any], cfg: ModelConfig) -> dict:
    if cfg.arch == "gpt2":
        return gpt2_params_from_state_dict(sd, cfg)
    return llama_params_from_state_dict(sd, cfg)


def params_from_hf_model(hf_model: Any, dtype: str = "float32"):
    """(cfg, params) from an in-memory transformers model instance."""
    cfg = config_from_hf(
        hf_model.config,
        name=getattr(hf_model.config, "name_or_path", "") or "converted",
        dtype=dtype,
    )
    return cfg, _params_from_state_dict(hf_model.state_dict(), cfg)


# the BF16 carrier: uint16 bits, marked so that a genuine U16/I16 tensor
# is never taken for one
BF16 = np.dtype(np.uint16, metadata={"safetensors": "BF16"})

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def is_bf16(a: np.ndarray) -> bool:
    """True for an array in the BF16 carrier."""
    return (a.dtype.metadata or {}).get("safetensors") == "BF16"


def as_float32(a: np.ndarray) -> np.ndarray:
    """float32 values of an array: BF16 bits widened exactly (a bfloat16
    is the top half of a float32), anything else cast."""
    if is_bf16(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def to_bf16(a: np.ndarray) -> np.ndarray:
    """float values rounded to bfloat16 (to nearest even, as torch casts),
    in the BF16 carrier."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16).view(BF16)


def _st_dtype(name: str) -> np.dtype:
    if name == "BF16":
        return BF16
    try:
        return np.dtype(_ST_DTYPES[name])
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


def _st_name(a: np.ndarray) -> str:
    if is_bf16(a):
        return "BF16"
    for name, dt in _ST_DTYPES.items():
        if a.dtype == np.dtype(dt):
            return name
    raise ValueError(f"no safetensors dtype for {a.dtype}")


def load_safetensors_file(path: str) -> dict:
    """Read one .safetensors file into {name: np.ndarray} (zero-copy mmap
    views; the file mapping stays alive as long as the arrays do)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    header_len = int.from_bytes(mm[:8], "little")
    header = json.loads(mm[8: 8 + header_len].decode("utf-8"))
    base = 8 + header_len
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = _st_dtype(meta["dtype"])
        shape = meta["shape"]
        o0, o1 = meta["data_offsets"]
        n = int(np.prod(shape)) if shape else 1
        if o1 - o0 != n * dt.itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} length {o1 - o0} != "
                f"prod(shape)*itemsize {n * dt.itemsize}"
            )
        out[name] = np.frombuffer(mm, dtype=dt, count=n, offset=base + o0).reshape(shape)
    return out


def save_safetensors_file(path: str, tensors: dict) -> None:
    """Write {name: np.ndarray} as one .safetensors file (little-endian,
    names in sorted order, the header padded to 8 bytes). Arrays in the
    BF16 carrier are written as BF16."""
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        a = tensors[name]
        data = np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _st_name(a), "shape": list(a.shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for data in blobs:
            f.write(data)


def load_safetensors_dir(path: str) -> dict:
    """State dict from a HF checkpoint dir: `model.safetensors`, a sharded
    `model.safetensors.index.json`, or any *.safetensors files present."""
    index = os.path.join(path, "model.safetensors.index.json")
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        sd = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(load_safetensors_file(os.path.join(path, shard)))
        missing = set(weight_map) - set(sd)
        if missing:
            raise ValueError(f"{index}: shards missing tensors {sorted(missing)[:5]}")
        return sd
    if os.path.exists(single):
        return load_safetensors_file(single)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd = {}
    for fp in files:
        sd.update(load_safetensors_file(fp))
    return sd


class _JsonConfig:
    """Attribute view over config.json, as a transformers config reads:
    the token-id attributes (and n_inner) read as None when unset; every
    other absent key raises AttributeError, so the getattr probes of
    config_from_hf fall back to their real defaults and a checkpoint
    missing a required key fails loudly."""

    _NONE_DEFAULTED = frozenset(
        {"eos_token_id", "bos_token_id", "pad_token_id", "n_inner"}
    )

    def __init__(self, d: dict):
        self.__dict__.update(d)

    def __getattr__(self, name):  # only called when not in __dict__
        if name in self._NONE_DEFAULTED:
            return None
        raise AttributeError(
            f"config.json has no {name!r} (and it has no None default)"
        )


def load_hf_checkpoint(path: str, name: str = None, dtype: str = "float32"):
    """(cfg, params) from a HF checkpoint directory on disk: config.json
    plus safetensors weights (what `save_pretrained(...,
    safe_serialization=True)` writes). The params are CPU tensors."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    cfg = config_from_hf(
        _JsonConfig(raw), name=name or os.path.basename(os.path.normpath(path)),
        dtype=dtype,
    )
    sd = load_safetensors_dir(path)
    # HF omits lm_head.weight from tied checkpoints even where the config
    # says untied-capable: trust the tensors over the flag
    if cfg.arch == "llama" and not cfg.tie_embeddings and "lm_head.weight" not in sd:
        cfg = cfg.replace(tie_embeddings=True)
    return cfg, _params_from_state_dict(sd, cfg)


# the tokenizer files the CLI carries beside a converted store
TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
    "vocab.json", "merges.txt", "tokenizer.model",
)


def main(argv=None) -> int:
    """CLI: convert a HF checkpoint dir into the local checkpoint store."""
    import argparse
    import shutil

    from .checkpoint import save_params

    ap = argparse.ArgumentParser(
        prog="python -m distributed_llm_inference_tpu_torch.models.convert",
        description="Convert a HuggingFace safetensors checkpoint into the "
        "stacked-layer local checkpoint store (models/checkpoint.py).",
    )
    ap.add_argument("--in", dest="src", required=True, help="HF checkpoint dir")
    ap.add_argument("--out", dest="dst", required=True, help="output ckpt dir")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--name", default=None, help="model name recorded in the config")
    args = ap.parse_args(argv)

    cfg, params = load_hf_checkpoint(args.src, name=args.name, dtype=args.dtype)
    save_params(args.dst, cfg, params)
    # the serving CLI loads tokenizer files found in --checkpoint DIR
    # (strictly), so a converted store serves real text with no extra flag
    copied = []
    for fname in TOKENIZER_FILES:
        src_f = os.path.join(args.src, fname)
        if os.path.exists(src_f):
            shutil.copy2(src_f, os.path.join(args.dst, fname))
            copied.append(fname)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel() for v in tree.values())

    print(json.dumps({
        "model": cfg.name, "arch": cfg.arch, "n_layers": cfg.n_layers,
        "n_params": int(count(params)), "dtype": cfg.dtype, "out": args.dst,
        "tokenizer_files": copied,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
