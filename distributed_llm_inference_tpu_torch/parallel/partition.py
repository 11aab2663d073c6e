"""Parameter and KV partitioning over the (dp, pp, sp, tp, ep) mesh (the
JAX package's parallel/partition.py).

The JAX package annotates shardings and lets XLA place each shard; here
a rank cuts its own shard out of the whole tree (`shard_params`): the
stacked layer leaves [L, ...] keep the rank's stage's layers, and within
a stage the Megatron split takes the rank's tp slice of each leaf
(column-sharded wq / wk / wv / w_gate / w_up and their biases, row-
sharded wo / w_down, whose partial products the decoder layer sums over
the tp group). An MoE model's expert banks [L, E, in, out] (dense or
int8) shard their E axis over ep, the router whole on every rank; the
decoder layer's moe_ffn sums its experts' share over the ep group.
Embedding rows and LM-head columns shard their vocab dim
over pp (parallel/vocab.py); norms and position rows replicate. The KV
cache [L, B, KV, S, Dh] shards layers over pp, batch over dp and kv heads
over tp; the block pool [L, N, KV, bs, Dh] layers over pp and kv heads
over tp, its blocks whole on every rank (the block tables and the slot
state are the same on every rank). Both replicate over ep; the context
backend's cache (parallel/context.py) shards its slots over sp.

Uneven splits: the JAX mesh needs an even layer axis, so it pads each
stage with all-zero layers that pass the activation through unchanged
(its pad_stacked_layers, up to `padded_layers_per_stage`). A rank of the
port runs only its stage's real layers, `stage_layer_range`, and needs no
padding: its pool and cache hold exactly those layers, so the shadow of
a block gathered over the stages is the single device's (the gather pads
the shorter stages to padded_layers_per_stage and cuts after).

Paged LoRA adapter leaves (engine/adapters.py) [L, P, in, r] / [L, P,
r, out] shard their layers over pp and, within a stage, so that each
rank's delta (h @ a) @ b is its share of the base projection's output,
added before the projection's tp sum (the JAX lora specs): a column-
sharded base's `a` replicates and its `b` shards its out dim with the
base columns; a row-sharded base's `a` shards its in dim with the base
rows (h arrives input-sharded) and its `b` replicates.

int4 leaves (Q4Tensor) split the contraction axis into (groups, g/2): a
row-sharded int4 weight shards whole groups, so the cut falls on scale-
group boundaries (validate_mesh checks that the groups divide).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig, stage_layer_range
from ..ops.kv_quant import KVQuant
from ..ops.quant import Q4Tensor, QTensor
from .mesh import AXIS_PP, AXIS_TP
from .vocab import VOCAB_SHARDED, pad_vocab, vocab_shard

COL, ROW, EXPERT = "col", "row", "expert"
# a row-sharded base's lora `a` [L, P, in, r]: its in dim (axis 2) over tp
LORA_IN = "lora_in"

# per stacked layer leaf: how tp shards it (COL: the output dim, ROW: the
# input dim, None: replicated over tp); the layer axis always over pp
_LLAMA_LAYER_TP = {
    "attn_norm": None, "mlp_norm": None, "attn_post_norm": None,
    "mlp_post_norm": None, "window_flag": None,
    "wq": COL, "wk": COL, "wv": COL,
    "bq": COL, "bk": COL, "bv": COL,
    # per-head q/k norms [L, Dh]: heads shard, head_dim does not
    "q_norm": None, "k_norm": None,
    "wo": ROW,
    "w_gate": COL, "w_up": COL, "w_down": ROW,
}

_GPT2_LAYER_TP = {
    "ln1_w": None, "ln1_b": None, "ln2_w": None, "ln2_b": None,
    "wq": COL, "wk": COL, "wv": COL, "bq": COL, "bk": COL, "bv": COL,
    "wo": ROW, "bo": None,
    "w_fc": COL, "b_fc": COL, "w_proj": ROW, "b_proj": None,
}

_FAMILY_LAYER_TP = {"llama": _LLAMA_LAYER_TP, "gpt2": _GPT2_LAYER_TP}

# the MoE FFN's router and expert banks: whole on every tp rank (MoE and
# tp > 1 are refused); EXPERT: the bank's E axis (1) over ep, the router
# whole on every rank (the JAX _MOE_LAYER_SPECS)
_MOE_LAYER_TP = {"w_router": None, "w_gate": EXPERT, "w_up": EXPERT,
                 "w_down": EXPERT}


def validate_mesh(cfg: ModelConfig, pp: int, tp: int, ep: int = 1,
                  params: Optional[dict] = None) -> None:
    """Divisibility invariants for a (pp, tp, ep) factorization, as the
    JAX package checks them; with `params`, also that every row-sharded
    int4 leaf's groups divide over tp."""
    if not 1 <= pp <= cfg.n_layers:
        raise ValueError(f"pp={pp} must be in [1, n_layers={cfg.n_layers}]")
    if cfg.n_heads % tp != 0:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
    if tp > 1 and cfg.use_qk_norm and cfg.qk_norm_dim == "proj":
        raise NotImplementedError(
            "qk_norm_dim='proj' (OLMo-2) does not compose with tp>1: the "
            "norm's mean-of-squares spans the whole projection, which a "
            "column shard cannot compute locally"
        )
    if cfg.n_kv_heads % tp != 0:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}")
    if cfg.ffn_dim % tp != 0:
        raise ValueError(f"ffn_dim={cfg.ffn_dim} not divisible by tp={tp}")
    if ep > 1 and not cfg.n_experts:
        raise ValueError("ep>1 needs an MoE model (cfg.n_experts > 0)")
    if cfg.n_experts:
        if cfg.n_experts % ep != 0:
            raise ValueError(
                f"n_experts={cfg.n_experts} not divisible by ep={ep}"
            )
        if tp > 1:
            raise NotImplementedError(
                "MoE + tensor parallelism is not wired yet: shard experts "
                "over ep instead of splitting each expert over tp"
            )
    if params is not None and tp > 1:
        for name, leaf in params["layers"].items():
            if isinstance(leaf, Q4Tensor) and layer_tp_rule(cfg, name) == ROW \
                    and leaf.q.shape[1] % tp:
                raise ValueError(
                    f"{name}: {leaf.q.shape[1]} int4 scale groups not "
                    f"divisible by tp={tp}")


def split_params(params: dict) -> tuple[dict, dict]:
    """(shared, layers): embeddings / final norm / head, and the stacked
    per-layer leaves."""
    shared = {k: v for k, v in params.items() if k != "layers"}
    return shared, params["layers"]


def padded_layers_per_stage(n_layers: int, pp: int) -> int:
    """Stacked-layer slots each stage holds on the JAX mesh after no-op
    padding."""
    return -(-n_layers // pp)


def layer_tp_rule(cfg: ModelConfig, name: str):
    """COL, ROW, EXPERT or None for the stacked layer leaf `name`."""
    rules = dict(_FAMILY_LAYER_TP[cfg.arch])
    if cfg.n_experts:
        rules.update(_MOE_LAYER_TP)
    if name.startswith("lora_"):
        # lora_{base}_{a|b}: by its base projection's rule
        base, factor = name[len("lora_"):-2], name[-1]
        if factor == "a":
            return LORA_IN if rules[base] == ROW else None
        return COL if rules[base] == COL else None
    if name not in rules:
        raise KeyError(f"no partition rule for layer param {name!r}")
    return rules[name]


def _cut(t: torch.Tensor, axis: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A slice in storage of its own: a contiguous slice is a view that
    would keep the whole tree's storage alive."""
    return t.clone(memory_format=torch.contiguous_format)


def shard_layer_leaf(leaf, rule, layer_range: tuple, tp_rank: int, tp: int,
                     ep_rank: int = 0, ep: int = 1):
    """A rank's shard of one stacked layer leaf: layers [lo, hi) of its
    stage, then its tp slice by `rule` (dense leaves: COL the last axis,
    ROW axis 1; QTensor q [L, in, out] / s [L, out]: the scale shards with
    the columns and replicates for a row split; Q4Tensor q [L, G, g/2,
    out] / s [L, G, out]: a row split takes whole scale groups), or for
    an EXPERT bank its ep share of the experts (axis 1 of the data and of
    an int8 bank's scales [L, E, out])."""
    lo, hi = layer_range

    def layers(t):
        return t[lo:hi]

    if rule == EXPERT:
        def experts(t):
            t = layers(t)
            return _own(_cut(t, 1, ep_rank, ep) if ep > 1 else t)

        if isinstance(leaf, QTensor):
            return QTensor(experts(leaf.q), experts(leaf.s))
        return experts(leaf)

    if isinstance(leaf, Q4Tensor):
        q, s = layers(leaf.q), layers(leaf.s)
        if tp > 1 and rule == COL:
            q, s = _cut(q, -1, tp_rank, tp), _cut(s, -1, tp_rank, tp)
        elif tp > 1 and rule == ROW:
            q, s = _cut(q, 1, tp_rank, tp), _cut(s, 1, tp_rank, tp)
        return Q4Tensor(_own(q), _own(s), leaf.g)
    if isinstance(leaf, QTensor):
        q, s = layers(leaf.q), layers(leaf.s)
        if tp > 1 and rule == COL:
            q, s = _cut(q, -1, tp_rank, tp), _cut(s, -1, tp_rank, tp)
        elif tp > 1 and rule == ROW:
            q = _cut(q, 1, tp_rank, tp)
        return QTensor(_own(q), _own(s))
    t = layers(leaf)
    if tp > 1 and rule == COL:
        t = _cut(t, -1, tp_rank, tp)
    elif tp > 1 and rule == ROW:
        t = _cut(t, 1, tp_rank, tp)
    elif tp > 1 and rule == LORA_IN:
        t = _cut(t, 2, tp_rank, tp)
    return _own(t)


def adapter_update_shard(cfg: ModelConfig, leaf: str, a, b, layer_range: tuple,
                         tp_rank: int, tp: int) -> tuple:
    """A rank's cut of one adapter's factors for a page write (engine/
    adapters.py): a [L, in, r] and b [L, r, out] host arrays (no page axis)
    cut to layers [lo, hi) and to the rank's share by the lora rules."""
    lo, hi = layer_range
    a, b = a[lo:hi], b[lo:hi]
    if tp > 1:
        if layer_tp_rule(cfg, f"lora_{leaf}_a") == LORA_IN:
            n = a.shape[1] // tp
            a = a[:, tp_rank * n:(tp_rank + 1) * n]
        if layer_tp_rule(cfg, f"lora_{leaf}_b") == COL:
            n = b.shape[-1] // tp
            b = b[..., tp_rank * n:(tp_rank + 1) * n]
    return a, b


def shard_layers(cfg: ModelConfig, layers: dict, stage: int, pp: int,
                 tp_rank: int = 0, tp: int = 1, ep_rank: int = 0,
                 ep: int = 1) -> dict:
    """The stacked layer leaves of (stage, tp_rank, ep_rank): the stage's
    real layers, each leaf's tp slice, each expert bank's ep share."""
    rng = stage_layer_range(cfg.n_layers, pp, stage)
    return {k: shard_layer_leaf(v, layer_tp_rule(cfg, k), rng, tp_rank, tp,
                                ep_rank, ep)
            for k, v in layers.items()}


def shared_specs(shared: dict) -> dict:
    """{leaf: vocab axis sharded over pp, or None (replicated)} — the JAX
    shared_specs as axis indices."""
    return {k: VOCAB_SHARDED.get(k) for k in shared}


def shard_shared(cfg: ModelConfig, shared: dict, stage: int, pp: int) -> dict:
    """The shared leaves of pp rank `stage`: embed / lm_head padded to a
    multiple of pp and cut to the rank's vocab shard on the axis of
    shared_specs, the rest whole."""
    padded = pad_vocab(cfg, shared, pp)
    specs = shared_specs(padded)
    return {k: (vocab_shard(v, specs[k], stage, pp) if specs[k] is not None
                else _own(v)) for k, v in padded.items()}


def shard_params(cfg: ModelConfig, params: dict, stage: int, pp: int,
                 tp_rank: int = 0, tp: int = 1, ep_rank: int = 0,
                 ep: int = 1) -> tuple[dict, dict]:
    """(shared, layers) of the rank at (stage, tp_rank, ep_rank)."""
    validate_mesh(cfg, pp, tp, ep, params=params)
    shared, layers = split_params(params)
    return (shard_shared(cfg, shared, stage, pp),
            shard_layers(cfg, layers, stage, pp, tp_rank, tp, ep_rank, ep))


# -- the KV cache and the block pool --------------------------------------------
# Specs as the JAX PartitionSpecs, one mesh axis (or None) per dim of each
# leaf; an int8 leaf's scales drop the head_dim axis.


def _leaf_specs(cfg, p5: tuple) -> dict:
    if getattr(cfg, "kv_quant", None) is None:
        return {"k": p5, "v": p5}
    leaf = (p5, p5[:4])  # KVQuant (q, s)
    return {"k": leaf, "v": leaf}


def pool_spec(cfg) -> dict:
    """Block pool [L, N, KV, bs, Dh]: layers over pp, kv heads over tp, the
    blocks whole on every rank."""
    return _leaf_specs(cfg, (AXIS_PP, None, AXIS_TP, None, None))


def shadow_block_spec(cfg) -> dict:
    """Stacked shadow blocks [N, L, KV, bs, Dh]: the layer axis (after the
    gather's transpose) over pp, kv heads over tp."""
    return _leaf_specs(cfg, (None, AXIS_PP, AXIS_TP, None, None))


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a tp rank's attention and caches see: its share of the
    heads and of the FFN, head_dim pinned to the model's."""
    if tp == 1:
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                       ffn_dim=cfg.ffn_dim // tp, head_dim_override=cfg.head_dim)


def init_sharded_cache(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
                       tp: int = 1, device=None) -> dict:
    """A rank's zeroed KV cache shard: its stage's `n_layers`, its dp
    share `batch` of the rows, its kv heads."""
    from ..models import api as M

    return M.init_kv_cache(local_config(cfg, tp), batch, max_seq=max_seq,
                           n_layers=n_layers, device=device)


def init_sharded_pool(cfg: ModelConfig, n_blocks: int, block_size: int,
                      n_layers: int, tp: int = 1, device=None) -> dict:
    """A rank's zeroed block pool shard: its stage's `n_layers`, every
    block, its kv heads."""
    from ..engine import paged as EP

    return EP.init_pool(local_config(cfg, tp), n_blocks, block_size,
                        n_layers=n_layers, device=device)


def pool_layer_slice(tree: dict, lo: int, hi: int, tp_rank: int, tp: int,
                     layer_axis: int = 1) -> dict:
    """Shadow-layout blocks [N, L, KV, bs(, Dh)] cut to layers [lo, hi) and
    the rank's kv heads (axis layer_axis + 1)."""
    def cut(t):
        t = t.narrow(layer_axis, lo, hi - lo)
        if tp > 1:
            t = _cut(t, layer_axis + 1, tp_rank, tp)
        return t.contiguous()

    return {n: (KVQuant(cut(l.q), cut(l.s)) if isinstance(l, KVQuant) else cut(l))
            for n, l in tree.items()}
