"""Family dispatch: one functional interface over the model families.

The engine calls these; cfg.arch picks the family (llama: RMSNorm, RoPE,
GQA, SwiGLU or the MoE FFN; gpt2: LayerNorm, learned positions, MHA,
gelu_new). Both share the stacked-layer parameter and KV-cache layout and
the attention hook seam, so the engine and the fleets are family-agnostic.

On a mesh rank (parallel/pipeline.py) the parameters are a StageParams
tree whose `stage` attribute is the rank's stage: embed, forward_layers
and unembed then run the stage's shard with its collectives (the
vocab-sharded embedding and head, the stage's layers between the ranks
before and after it), so every program of engine/generate.py and
engine/paged.py runs on a rank unchanged.
"""

from __future__ import annotations

from ..config import ModelConfig
from . import gpt2, llama

_FAMILIES = {"llama": llama, "gpt2": gpt2}


def family(cfg: ModelConfig):
    if cfg.arch not in _FAMILIES:
        raise ValueError(f"unknown model arch {cfg.arch!r}")
    return _FAMILIES[cfg.arch]


def init_params(cfg, generator):
    return family(cfg).init_params(cfg, generator)


def init_kv_cache(cfg, batch, max_seq=None, n_layers=None, device=None):
    return family(cfg).init_kv_cache(
        cfg, batch, max_seq=max_seq, n_layers=n_layers, device=device
    )


def embed(cfg, params, tokens, pos=0):
    stage = getattr(params, "stage", None)
    if stage is not None:
        return stage.embed(tokens, pos)
    return family(cfg).embed(cfg, params, tokens, pos)


def forward_layers(cfg, layers, x, cache, pos, valid_start=None,
                   attn_hook=None, attn_seq_len=None, lora_pages=None):
    """pos: an int, or an int32 [B] tensor of per-row positions (slots
    mode); attn_hook / attn_seq_len: the paged hooks of engine/paged.py;
    lora_pages: [B] int32 adapter-pool pages (see llama.forward_layers;
    llama only, as valid_start is: gpt2's forward_layers refuses both)."""
    stage = getattr(layers, "stage", None)
    if stage is not None:
        return stage.forward_layers(
            x, cache, pos, valid_start=valid_start, attn_hook=attn_hook,
            attn_seq_len=attn_seq_len, lora_pages=lora_pages,
        )
    return family(cfg).forward_layers(
        cfg, layers, x, cache, pos, valid_start=valid_start,
        attn_hook=attn_hook, attn_seq_len=attn_seq_len, lora_pages=lora_pages,
    )


def unembed(cfg, params, x):
    stage = getattr(params, "stage", None)
    if stage is not None:
        return stage.unembed(x)
    return family(cfg).unembed(cfg, params, x)


def forward(cfg, params, tokens, cache, pos):
    return family(cfg).forward(cfg, params, tokens, cache, pos)
