"""Family dispatch: one functional interface over the model families.

The engine calls these; cfg.arch picks the family. The llama family is
ported; gpt2 raises until its port, ROADMAP.md "Other families and loading".
"""

from __future__ import annotations

from ..config import ModelConfig
from . import llama

_FAMILIES = {"llama": llama}


def family(cfg: ModelConfig):
    if cfg.arch == "gpt2":
        raise NotImplementedError(
            "the gpt2 family (models/gpt2.py) is not ported to PyTorch yet "
            "(ROADMAP.md \"Other families and loading\")"
        )
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
    return family(cfg).embed(cfg, params, tokens, pos)


def forward_layers(cfg, layers, x, cache, pos, valid_start=None,
                   attn_hook=None, attn_seq_len=None, lora_pages=None):
    """pos: an int, or an int32 [B] tensor of per-row positions (slots
    mode); attn_hook / attn_seq_len: the paged hooks of engine/paged.py;
    lora_pages: [B] int32 adapter-pool pages (see llama.forward_layers)."""
    return family(cfg).forward_layers(
        cfg, layers, x, cache, pos, valid_start=valid_start,
        attn_hook=attn_hook, attn_seq_len=attn_seq_len, lora_pages=lora_pages,
    )


def unembed(cfg, params, x):
    return family(cfg).unembed(cfg, params, x)


def forward(cfg, params, tokens, cache, pos):
    return family(cfg).forward(cfg, params, tokens, cache, pos)
