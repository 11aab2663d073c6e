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

Partial loads read the `.npy` leaves through `np.load(mmap_mode="r")`
and copy out only the rows and columns they keep: `load_stage_params`
(one pipeline stage's layers and its role's shared leaves, the JAX
function) and `load_params_sharded` (one mesh rank's shard, equal to
parallel/partition.shard_params of the full load: its stage's layers,
its tp columns or rows, its ep experts, its vocab shard zero-padded as
pad_vocab pads it). A stage's layer rows, a tp row cut and an ep share
are contiguous runs of a leaf's file, so the pages of the other ranks'
share are never touched. A tp column cut is not: a rank's columns are a
run inside every row, so its copy touches every page of its stage's
rows (for leaves whose rows are a page or less).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, stage_layer_range

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


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """An array (or a memory map of one) as a tensor of its logical dtype,
    without a copy (bfloat16 from its uint16 bits). A read-only map's
    tensor is only sliced and copied, never written."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        if logical == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)


def _load_leaf(path: str, key: str, logical: str,
               rows: Optional[tuple] = None) -> torch.Tensor:
    """Read one leaf as a CPU tensor of its logical dtype (any leaf but a
    bfloat16 one is stored in its own dtype); `rows` (lo, hi): only those
    rows of the leading axis, read off a memory map."""
    file = os.path.join(path, _leaf_file(key))
    if rows is None:
        return _tensor(np.load(file), logical)
    arr = np.load(file, mmap_mode="r")
    return _tensor(np.ascontiguousarray(arr[rows[0]:rows[1]]), logical)


def load_config(path: str) -> ModelConfig:
    """The store's ModelConfig alone (its manifest)."""
    return _read_manifest(path)[0]


def load_params(path: str) -> tuple[ModelConfig, dict]:
    """Full restore: (cfg, params) with CPU tensor leaves."""
    cfg, leaves = _read_manifest(path)
    flat = {k: _load_leaf(path, k, meta["dtype"]) for k, meta in leaves.items()}
    return cfg, _unflatten(flat)


def load_stage_params(path: str, pp: int, stage: int, *,
                      load_embed: Optional[bool] = None,
                      load_head: Optional[bool] = None) -> tuple[ModelConfig, dict]:
    """Restore one pipeline stage's shard (the JAX function): `layers/*`
    sliced to stage_layer_range(n_layers, pp, stage) off a memory map;
    shared leaves filtered by role. The first stage embeds, the last one
    holds the final norm and the head (and `embed` too on a tied-head
    model, but never `pos_embed`, which only the first stage's embedding
    reads); load_embed / load_head override the roles."""
    cfg, leaves = _read_manifest(path)
    start, end = stage_layer_range(cfg.n_layers, pp, stage)
    first, last = stage == 0, stage == pp - 1
    explicit_embed = load_embed  # None = the role's default below
    if load_embed is None:
        load_embed = first or (last and cfg.tie_embeddings)
    if load_head is None:
        load_head = last
    flat = {}
    for key, meta in leaves.items():
        if key.startswith("layers/"):
            flat[key] = _load_leaf(path, key, meta["dtype"], (start, end))
            continue
        if key == "pos_embed":
            want = first if explicit_embed is None else explicit_embed
        elif key == "embed":
            want = load_embed
        elif key in ("lm_head", "final_norm", "final_norm_w", "final_norm_b"):
            want = load_head
        else:
            want = True  # an unknown shared leaf: kept everywhere
        if want:
            flat[key] = _load_leaf(path, key, meta["dtype"])
    return cfg, _unflatten(flat)


def load_params_sharded(path: str, mesh_cfg, rank: int,
                        stats: Optional[dict] = None) -> tuple[ModelConfig, dict, dict]:
    """One mesh rank's shard straight off the store: (cfg, shared, layers),
    equal to parallel/partition.shard_params of the full load at the rank's
    (stage, tp, ep) coordinates. Every leaf is a memory map; the rank keeps
    (and so reads) only its stage's layer rows, its tp slice of each by
    the partition rules, its ep share of each expert bank, and its vocab
    shard of embed / lm_head (the padding past the vocab is zeros, read
    from nowhere). `stats`, when given, gets "shard_bytes": the bytes of
    the store the shard holds (the pages the load touches are those, but
    for tp column cuts: see the module's docstring)."""
    from ..parallel.mesh import AXIS_EP, AXIS_PP, AXIS_TP, rank_coords
    from ..parallel.partition import layer_tp_rule, shard_layer_leaf, validate_mesh
    from ..parallel.vocab import VOCAB_SHARDED, padded_vocab

    cfg, leaves = _read_manifest(path)
    pp, tp, ep = mesh_cfg.pp, mesh_cfg.tp, mesh_cfg.ep
    c = rank_coords(mesh_cfg, rank)
    s, t, e = c[AXIS_PP], c[AXIS_TP], c[AXIS_EP]
    validate_mesh(cfg, pp, tp, ep)
    rng = stage_layer_range(cfg.n_layers, pp, s)
    V_pad = padded_vocab(cfg.vocab_size, pp)
    shared, layers = {}, {}
    n_held = 0
    for key, meta in leaves.items():
        mm = _tensor(np.load(os.path.join(path, _leaf_file(key)), mmap_mode="r"),
                     meta["dtype"])
        if key.startswith("layers/"):
            name = key.split("/", 1)[1]
            # narrow views of the map; the shard's own copy reads its bytes
            leaf = shard_layer_leaf(mm, layer_tp_rule(cfg, name), rng, t, tp, e, ep)
            layers[name] = leaf
            n_held += leaf.numel() * leaf.element_size()
        elif key in VOCAB_SHARDED:
            axis = VOCAB_SHARDED[key]
            n = V_pad // pp
            lo = s * n
            real = max(0, min(n, mm.shape[axis] - lo))
            shape = list(mm.shape)
            shape[axis] = n
            leaf = torch.zeros(shape, dtype=mm.dtype)
            if real:
                leaf.narrow(axis, 0, real).copy_(mm.narrow(axis, lo, real))
            shared[key] = leaf
            n_held += real * (leaf.numel() // n) * leaf.element_size()
        else:
            shared[key] = mm.clone()
            n_held += mm.numel() * mm.element_size()
    if stats is not None:
        stats["shard_bytes"] = n_held
    return cfg, shared, layers
