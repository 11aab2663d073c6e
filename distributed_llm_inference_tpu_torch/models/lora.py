"""LoRA adapters: merge-at-load and the runtime pool's stacked factors
(the JAX package's models/lora.py in numpy and PyTorch).

A PEFT-format adapter directory (`adapter_config.json` +
`adapter_model.safetensors`) is served two ways:

  * `merge_lora` bakes ONE adapter into the dense weights at load,

        W' = W + (lora_alpha / r) * B @ A     (per layer, per module)

    before quantization, so every launch runs unchanged (`--lora`);
  * `load_lora_stacked` reads it into per-layer stacked, rank-padded
    factors with the scale folded into b, which engine/adapters.AdapterPool
    writes into a page of the resident model's lora_* leaves: many
    adapters share one base, selected per row inside the launches
    (models/llama.decoder_layer's `lora_pages`).

Both accept and reject the same adapters (`_check_adapter_cfg` and the
unknown-tensor sweep) and share the fp32 delta math, so a runtime page
serves the same greedy stream as the merged weights.

PEFT tensor naming (peft >= 0.5 `save_pretrained`):
    base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight  [r, in]
    base_model.model.model.layers.{i}.self_attn.q_proj.lora_B.weight  [out, r]
The stacked leaves hold W.T relative to HF ([in, out]), so the merged
delta is (scale * B @ A).T.

`write_peft_adapter` writes such a directory from numpy factors (the
tests and chip_smoke.py make their adapters with it; nothing is
downloaded).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.logging import get_logger
from .convert import as_float32, load_safetensors_file, save_safetensors_file, to_bf16

log = get_logger("lora")

# PEFT target_modules name -> the stacked leaf
_MODULE_TO_LEAF = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}

_PREFIXES = (
    "base_model.model.model.layers.{}.self_attn.{}",
    "base_model.model.model.layers.{}.mlp.{}",
)


def load_lora_adapter(path: str) -> tuple[dict, dict]:
    """Read a PEFT adapter dir -> (adapter_config, {tensor_name: np.ndarray})."""
    cfg_path = os.path.join(path, "adapter_config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{path} has no adapter_config.json (expected a PEFT-format "
            f"adapter directory)"
        )
    with open(cfg_path) as f:
        acfg = json.load(f)
    tensor_path = os.path.join(path, "adapter_model.safetensors")
    if not os.path.exists(tensor_path):
        raise FileNotFoundError(f"{path} has no adapter_model.safetensors")
    return acfg, load_safetensors_file(tensor_path)


def _check_adapter_cfg(acfg: dict) -> tuple[int, float]:
    """(rank, merge scale) after rejecting every PEFT variant that changes
    the delta's math, not just its naming: a silently wrong adapter is the
    worst failure a weights loader can have. Shared by both loaders, so
    they accept and reject the same adapters."""
    r = int(acfg["r"])
    if acfg.get("use_dora"):
        raise ValueError(
            "DoRA adapters (use_dora=true) are not supported: the "
            "magnitude normalization changes the merge math"
        )
    if acfg.get("alpha_pattern"):
        raise ValueError("per-module alpha_pattern adapters are not supported")
    if acfg.get("layers_to_transform") is not None:
        raise ValueError(
            "layers_to_transform adapters (partial-layer) are not supported"
        )
    if acfg.get("modules_to_save"):
        raise ValueError(
            f"adapter carries fully fine-tuned modules_to_save="
            f"{acfg['modules_to_save']} — merging only the LoRA deltas "
            f"would silently drop them"
        )
    if acfg.get("bias", "none") != "none":
        raise ValueError(
            f"bias={acfg['bias']!r} adapters are not supported (trained "
            f"bias tensors would be dropped)"
        )
    if acfg.get("use_rslora"):
        # rank-stabilized LoRA: scale = alpha / sqrt(r)
        scale = float(acfg.get("lora_alpha", r)) / (r ** 0.5)
    else:
        scale = float(acfg.get("lora_alpha", r)) / r
    return r, scale


def _module_factors(tensors: dict, module: str, n_layers: int, r: int):
    """[(A [r, in], B [out, r]) float32 per layer] of one target module, or
    None when the adapter does not target it. The module is detected by
    ANY layer's tensor, so a partial-layer adapter gets its accurate
    error here."""
    for pref in _PREFIXES:
        if any(pref.format(i, module) + ".lora_A.weight" in tensors
               for i in range(n_layers)):
            break
    else:
        return None
    out = []
    for i in range(n_layers):
        a = tensors.get(pref.format(i, module) + ".lora_A.weight")
        b = tensors.get(pref.format(i, module) + ".lora_B.weight")
        if a is None or b is None:
            raise ValueError(
                f"adapter is missing {module} lora_A/lora_B for layer "
                f"{i} (partial-layer adapters are not supported)"
            )
        if a.shape[0] != r or b.shape[1] != r:
            raise ValueError(
                f"layer {i} {module}: rank mismatch (adapter_config r="
                f"{r}, tensors {a.shape} / {b.shape})"
            )
        out.append((as_float32(a), as_float32(b)))
    return out


def _check_consumed(tensors: dict, modules: set, what: str):
    """ANY tensor a loader did not consume is an error: fine-tuned heads,
    bias terms, magnitude vectors, unsupported targets alike."""
    unknown = {
        n for n in tensors
        if not any(f".{m}.lora_A." in n or f".{m}.lora_B." in n for m in modules)
    }
    if unknown:
        raise ValueError(
            f"adapter has tensors the {what} would silently drop, e.g. "
            f"{sorted(unknown)[:3]}"
        )


def merge_lora(cfg: ModelConfig, params: dict, adapter_path: str) -> dict:
    """Merge a PEFT LoRA adapter into stacked params (the single-adapter
    path; the runtime pool goes through load_lora_stacked). Runs BEFORE
    quantization, in fp32, each merged leaf cast back to its dtype. Raises
    on adapters that target modules the params lack, on rank or shape
    mismatches, and on already-quantized params (quantizing first would
    merge into nothing). Returns new dicts; the input is not modified."""
    from ..ops.quant import Q4Tensor, QTensor

    if cfg.arch != "llama":
        raise ValueError(f"LoRA merging is wired for the llama family; got {cfg.arch!r}")
    acfg, tensors = load_lora_adapter(adapter_path)
    r, scale = _check_adapter_cfg(acfg)
    layers = dict(params["layers"])
    merged = set()
    for module, leaf in _MODULE_TO_LEAF.items():
        factors = _module_factors(tensors, module, cfg.n_layers, r)
        if factors is None:
            continue
        if leaf not in layers:
            raise ValueError(f"adapter targets {module} but params have no {leaf!r} leaf")
        w = layers[leaf]
        if isinstance(w, (QTensor, Q4Tensor)):
            raise ValueError(
                "params are already quantized — merge the LoRA adapter "
                "BEFORE quantization (create_engine does this when both "
                "are requested)"
            )
        # W' = W + scale * (B @ A) in fp32, on the weight's device; the
        # stacked leaves hold W.T [in, out]
        a = torch.from_numpy(np.stack([a for a, _ in factors])).to(w.device)
        b = torch.from_numpy(np.stack([b for _, b in factors])).to(w.device)
        delta = torch.bmm(scale * b, a).transpose(1, 2)
        if tuple(delta.shape) != tuple(w.shape):
            raise ValueError(
                f"{leaf}: adapter delta shape {tuple(delta.shape)} != weight "
                f"shape {tuple(w.shape)}"
            )
        layers[leaf] = (w.float() + delta.to(w.dtype).float()).to(w.dtype)
        merged.add(module)
    if not merged:
        raise ValueError(
            f"adapter at {adapter_path} targets none of the supported "
            f"modules {sorted(_MODULE_TO_LEAF)}"
        )
    _check_consumed(tensors, merged, "merge")
    log.info("lora_merged", adapter=adapter_path, r=r, scale=scale,
             modules=sorted(merged))
    return {**params, "layers": layers}


def load_lora_stacked(cfg: ModelConfig, adapter_path: str, max_rank: int) -> dict:
    """Read a PEFT adapter into the runtime pool's host tensors: {leaf:
    (a, b)} with a = A^T stacked [L, in, max_rank] and b = scale * B^T
    stacked [L, max_rank, out] (np.float32; the pool writes them in the
    model dtype). Zero rank-padding makes every adapter the pool's rank
    (padded columns add exactly 0), and the folded scale makes the delta
    (x @ a) @ b == scale * x @ A^T @ B^T, merge_lora's W' transposed.
    Accepts and rejects what merge_lora does, plus the pool's rank bound."""
    if cfg.arch != "llama":
        raise ValueError(f"LoRA adapters are wired for the llama family; got {cfg.arch!r}")
    acfg, tensors = load_lora_adapter(adapter_path)
    r, scale = _check_adapter_cfg(acfg)
    if r > max_rank:
        raise ValueError(
            f"adapter rank {r} exceeds the adapter pool rank {max_rank} "
            f"(EngineConfig.adapter_rank) — raise the pool rank or use "
            f"merge-at-load (--lora) for this adapter"
        )
    out: dict = {}
    for module, leaf in _MODULE_TO_LEAF.items():
        factors = _module_factors(tensors, module, cfg.n_layers, r)
        if factors is None:
            continue
        a_stack, b_stack = [], []
        for a, b in factors:
            # A [r, in] -> a = A.T [in, r]; B [out, r] -> b = scale * B.T [r, out]
            a_p = np.zeros((a.shape[1], max_rank), np.float32)
            a_p[:, :r] = a.T
            b_p = np.zeros((max_rank, b.shape[0]), np.float32)
            b_p[:r, :] = scale * b.T
            a_stack.append(a_p)
            b_stack.append(b_p)
        out[leaf] = (np.stack(a_stack, axis=0), np.stack(b_stack, axis=0))
    if not out:
        raise ValueError(
            f"adapter at {adapter_path} targets none of the supported "
            f"modules {sorted(_MODULE_TO_LEAF)}"
        )
    modules = {m for m, leaf in _MODULE_TO_LEAF.items() if leaf in out}
    _check_consumed(tensors, modules, "runtime loader")
    log.info("lora_stacked_loaded", adapter=adapter_path, r=r, scale=scale,
             pool_rank=max_rank, modules=sorted(modules))
    return out


def write_peft_adapter(path: str, factors: dict, *, r: int, lora_alpha: float,
                       use_rslora: bool = False, bf16: bool = False) -> str:
    """Write a PEFT-format adapter directory: factors = {PEFT module name
    ("q_proj", ..., "down_proj"): (A [L, r, in], B [L, out, r])} as numpy
    arrays, stored F32 (or BF16, rounded to nearest even). Returns path."""
    os.makedirs(path, exist_ok=True)
    tensors = {}
    for module, (a, b) in factors.items():
        pref = _PREFIXES[0 if module in ("q_proj", "k_proj", "v_proj", "o_proj") else 1]
        for i in range(a.shape[0]):
            for name, val in (("lora_A", a[i]), ("lora_B", b[i])):
                val = np.ascontiguousarray(val, np.float32)
                tensors[f"{pref.format(i, module)}.{name}.weight"] = (
                    to_bf16(val) if bf16 else val)
    save_safetensors_file(os.path.join(path, "adapter_model.safetensors"), tensors)
    acfg = {"peft_type": "LORA", "task_type": "CAUSAL_LM", "r": r,
            "lora_alpha": lora_alpha, "target_modules": sorted(factors),
            "use_rslora": use_rslora, "bias": "none", "lora_dropout": 0.0}
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(acfg, f)
    return path
