"""The local checkpoint store: the JAX package's models/checkpoint.py
(`save_params`, `load_params`), in the same format, so a store that
either package writes loads in the other.

Format: one `.npy` per leaf of the parameter dictionary (slash-joined
key paths, `/` -> `__`) plus `manifest.json` holding the ModelConfig and
each leaf's logical dtype. bfloat16 leaves are stored as their raw uint16
bit patterns and re-viewed on load. Neither `ml_dtypes` nor `jax` is
used: a bfloat16 tensor's bits travel through int16 views. The manifest
names the attention route in the JAX package's words ("xla" / "pallas"
for the port's "plain" / "kernel"). Leaves load as CPU tensors; the
caller moves them (runtime.create_engine does).

The sharded and per-stage loads of the JAX module (`load_params_sharded`,
`load_stage_params`) belong to multi-GPU serving and are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import ModelConfig

_MANIFEST = "manifest.json"
# the port's attention routes in the words the JAX package's config takes
_ATTN_TO_STORE = {"plain": "xla", "kernel": "pallas"}
_ATTN_FROM_STORE = {v: k for k, v in _ATTN_TO_STORE.items()}
# config fields that JSON carries as lists
_TUPLE_FIELDS = ("stop_token_ids", "attn_window_layer_types")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _leaf_file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype) of a tensor leaf."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(
            f"the checkpoint store holds dense tensors; got {type(leaf).__name__} "
            f"(save before quantizing)"
        )
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_params(path: str, cfg: ModelConfig, params: dict) -> None:
    """Write params + config to `path` (created if needed)."""
    os.makedirs(path, exist_ok=True)
    leaves = {}
    for key, leaf in _flatten(params).items():
        arr, logical = _to_numpy(leaf)
        np.save(os.path.join(path, _leaf_file(key)), arr)
        leaves[key] = {"dtype": logical}
    raw = dataclasses.asdict(cfg)
    raw["attn_impl"] = _ATTN_TO_STORE.get(raw["attn_impl"], raw["attn_impl"])
    manifest = {"config": raw, "leaves": leaves}
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def _read_manifest(path: str) -> tuple[ModelConfig, dict]:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    raw = manifest["config"]
    # JSON round-trips tuples as lists; coerce tuple-typed fields back so
    # the loaded config compares equal to the saved one
    for k in _TUPLE_FIELDS:
        if isinstance(raw.get(k), list):
            raw[k] = tuple(raw[k])
    raw["attn_impl"] = _ATTN_FROM_STORE.get(raw.get("attn_impl"), "plain")
    return ModelConfig(**raw), manifest["leaves"]


def _load_leaf(path: str, key: str, logical: str) -> torch.Tensor:
    """Read one leaf as a CPU tensor of its logical dtype (bfloat16 from
    its uint16 bits; any other leaf is stored in its own dtype)."""
    arr = np.load(os.path.join(path, _leaf_file(key)))
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_params(path: str) -> tuple[ModelConfig, dict]:
    """Full restore: (cfg, params) with CPU tensor leaves."""
    cfg, leaves = _read_manifest(path)
    flat = {k: _load_leaf(path, k, meta["dtype"]) for k, meta in leaves.items()}
    return cfg, _unflatten(flat)
