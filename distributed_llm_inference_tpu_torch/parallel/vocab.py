"""Vocab-sharded embedding and LM head over the pipeline axis (the JAX
package's parallel/vocab.py).

Both ends of the model shard their VOCAB dimension over `pp`, so a rank
holds 1/pp of the embedding and of the head:

  * embed [V, D] shards rows: a lookup gathers the ids that land in this
    rank's shard (the others contribute zeros) and sums over the pp group;
    each id lives in exactly one shard, so the sum adds one real row to
    zeros and equals the replicated lookup;
  * lm_head [D, V] (or the tied embed, transposed) shards columns: each
    rank computes its [..., V/pp] slice of the logits and the slices are
    gathered in rank order.

V is padded up to a multiple of pp at shard time (pad_vocab): pad rows
and pad columns are zero and the pad logits are cut off after the
gather, so they can never be sampled.

`group` is the rank's pp Group (parallel/comm.py); a group of one rank
sums and gathers nothing it does not hold.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models.gpt2 import _positions
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import Q4Tensor, QTensor
from ..ops.quant import matmul as mm

# shared leaves sharded on a vocab dim (leaf name -> vocab axis index of
# the dense leaf)
VOCAB_SHARDED = {"embed": 0, "lm_head": 1}


def padded_vocab(vocab_size: int, pp: int) -> int:
    return -(-vocab_size // pp) * pp


def _pad(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    if n == 0:
        return x
    shape = list(x.shape)
    shape[axis] = n
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pad_vocab(cfg: ModelConfig, shared: dict, pp: int) -> dict:
    """Zero-pad the vocab dim of embed / lm_head to a multiple of pp. A
    quantized lm_head pads its int columns and their scales with zeros."""
    V_pad = padded_vocab(cfg.vocab_size, pp)
    if V_pad == cfg.vocab_size:
        return shared
    out = dict(shared)
    for name, axis in VOCAB_SHARDED.items():
        if name not in shared:
            continue
        x = shared[name]
        if isinstance(x, QTensor):  # q [D, V], s [V]
            n = V_pad - x.q.shape[axis]
            out[name] = QTensor(_pad(x.q, axis, n), _pad(x.s, 0, n))
        elif isinstance(x, Q4Tensor):  # q [G, g/2, V], s [G, V]
            n = V_pad - x.q.shape[-1]
            out[name] = Q4Tensor(_pad(x.q, -1, n), _pad(x.s, -1, n), x.g)
        else:
            out[name] = _pad(x, axis, V_pad - x.shape[axis])
    return out


def vocab_shard(leaf, axis: int, rank: int, pp: int):
    """Rank `rank`'s slice of a (padded) vocab-sharded leaf; a quantized
    head's scales shard with its columns."""
    def cut(t, ax):
        n = t.shape[ax] // pp
        return t.narrow(ax, rank * n, n).clone(memory_format=torch.contiguous_format)

    if isinstance(leaf, QTensor):
        return QTensor(cut(leaf.q, axis), cut(leaf.s, 0))
    if isinstance(leaf, Q4Tensor):
        return Q4Tensor(cut(leaf.q, -1), cut(leaf.s, -1), leaf.g)
    return cut(leaf, axis)


def embed_sharded(cfg: ModelConfig, shared: dict, tokens: torch.Tensor, pos,
                  group) -> torch.Tensor:
    """[B, T] ids -> [B, T, D] activations on every rank of the pp group.
    shared["embed"] is the LOCAL [V_pad/pp, D] row shard; equal to
    models/*.embed on the whole table."""
    e = shared["embed"]
    V_loc = e.shape[0]
    idx = tokens.long() - group.rank * V_loc
    valid = (idx >= 0) & (idx < V_loc)
    x = e[idx.clamp(0, V_loc - 1)]
    x = group.psum(torch.where(valid[..., None], x, x.new_zeros(())))
    if cfg.embed_scale:  # gemma: sqrt(dim) in the activation dtype
        x = x * torch.tensor(cfg.dim ** 0.5, dtype=x.dtype)
    if cfg.embed_multiplier is not None:  # granite
        x = x * torch.tensor(cfg.embed_multiplier, dtype=x.dtype)
    if cfg.use_learned_pos:  # gpt2: the replicated position rows, once
        pe = shared["pos_embed"]
        T = tokens.shape[1]
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            ar = torch.arange(T, dtype=torch.int32, device=pos.device)
            return x + pe[_positions(pe.shape[0], pos[:, None] + ar[None, :])]
        ar = torch.arange(T, dtype=torch.int64, device=tokens.device)
        return x + pe[_positions(pe.shape[0], int(pos) + ar)][None]
    return x


def unembed_sharded(cfg: ModelConfig, shared: dict, x: torch.Tensor,
                    group) -> torch.Tensor:
    """[B, T, D] (the same on every rank) -> [B, T, V] fp32 logits on every
    rank: the final norm, the head on the local column shard, and the
    slices gathered in rank order; equal to models/*.unembed."""
    if cfg.arch == "gpt2":
        h = layer_norm(x, shared["final_norm_w"], shared["final_norm_b"], cfg.norm_eps)
    else:
        h = rms_norm(x, shared["final_norm"], cfg.norm_eps,
                     unit_offset=cfg.norm_unit_offset)
    if cfg.tie_embeddings:
        lg = (h @ shared["embed"].T).float()
    else:
        lg = mm(h, shared["lm_head"]).float()
    lg = group.all_gather(lg, dim=-1)[..., : cfg.vocab_size]
    if cfg.final_softcap is not None:  # gemma-2
        lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
    if cfg.logits_divider is not None:  # granite
        lg = lg / cfg.logits_divider
    return lg
