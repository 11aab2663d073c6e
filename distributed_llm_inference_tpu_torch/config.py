"""Model / engine / mesh configuration for the PyTorch port.

The same dataclasses and field names as the JAX package's config.py, so a
reader finds each counterpart: one ModelConfig covers every registry
preset, EngineConfig carries the serving knobs, SamplingConfig the request
defaults. Differences:

  * dtypes resolve to torch dtypes (`ModelConfig.torch_dtype`);
  * `attn_impl` is "plain" (einsum + mask in PyTorch, the counterpart of
    "xla") or "kernel" (the hand-written CUDA flash kernel of
    ops/flash_attention.py, the counterpart of "pallas");
  * EngineConfig keeps only the fields the solo engine and the
    continuous paged fleet read; other knobs arrive with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

ATTN_IMPLS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only causal LM.

    Field for field the JAX package's ModelConfig (see its comments for
    the per-family meaning of each knob); only attn_impl's values differ.
    """

    name: str = "tinyllama-1.1b"
    arch: str = "llama"  # "llama" | "gpt2"
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    ffn_dim: int = 5632
    max_seq_len: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[str] = None  # None | "llama3" | "linear"
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    rope_local_theta: Optional[float] = None
    attn_window: Optional[int] = None
    attn_window_pattern: str = "all"  # "all" | "even"
    attn_window_layer_types: Optional[tuple] = None
    head_dim_override: Optional[int] = None
    norm_unit_offset: bool = False
    act: str = "silu"  # "silu" | "gelu_tanh"
    embed_scale: bool = False
    embed_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    attn_scale_override: Optional[float] = None
    logits_divider: Optional[float] = None
    post_norms: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale_override: Optional[float] = None
    attn_qkv_bias: bool = False
    use_qk_norm: bool = False
    qk_norm_dim: str = "head"  # "head" | "proj"
    pre_norms: bool = True
    moe_renormalize: bool = True
    n_experts: int = 0
    n_experts_per_tok: int = 2
    tie_embeddings: bool = False
    use_learned_pos: bool = False
    dtype: str = "float32"  # "float32" | "bfloat16"
    quant: Optional[str] = None
    kv_quant: Optional[str] = None
    # "plain": einsum + mask attention; "kernel": the CUDA flash kernel
    # for T>1 chunks (T=1 decode always stays plain, as in the JAX
    # package's pallas gate)
    attn_impl: str = "plain"
    eos_token_id: int = 2
    bos_token_id: int = 1
    pad_token_id: int = 0
    stop_token_ids: tuple = ()
    chat_template: Optional[str] = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be 'plain' or 'kernel', got {self.attn_impl!r}"
            )
        if self.act not in ("silu", "gelu_tanh"):
            raise ValueError(f"act must be 'silu' or 'gelu_tanh', got {self.act!r}")
        if self.chat_template not in (None, "tinyllama", "gemma", "phi3",
                                      "none", "hf"):
            raise ValueError(
                f"chat_template must be None, 'tinyllama', 'gemma', 'phi3', "
                f"'none', or 'hf', got {self.chat_template!r}"
            )
        if self.qk_norm_dim not in ("head", "proj"):
            raise ValueError(
                f"qk_norm_dim must be 'head' or 'proj', got "
                f"{self.qk_norm_dim!r}"
            )
        if not self.pre_norms and not self.post_norms:
            raise ValueError(
                "pre_norms=False needs post_norms=True (a block with no "
                "norms at all matches no supported architecture)"
            )
        if self.attn_window_pattern not in ("all", "even"):
            raise ValueError(
                f"attn_window_pattern must be 'all' or 'even', got "
                f"{self.attn_window_pattern!r}"
            )
        if self.quant not in (None, "int8", "int4"):
            raise ValueError(
                f"quant must be None, 'int8', or 'int4', got {self.quant!r}"
            )
        if self.kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {self.kv_quant!r}"
            )
        if self.rope_scaling not in (None, "llama3", "linear"):
            raise ValueError(
                f"rope_scaling must be None, 'llama3', or 'linear', got "
                f"{self.rope_scaling!r}"
            )
        if self.attn_window_layer_types is not None:
            if len(self.attn_window_layer_types) != self.n_layers:
                raise ValueError(
                    f"attn_window_layer_types has "
                    f"{len(self.attn_window_layer_types)} entries for "
                    f"{self.n_layers} layers"
                )
            if self.attn_window is None:
                raise ValueError(
                    "attn_window_layer_types needs attn_window set"
                )
        if self.rope_local_theta is not None and (
            self.attn_window is None
            or (self.attn_window_pattern == "all"
                and self.attn_window_layer_types is None)
        ):
            raise ValueError(
                "rope_local_theta needs a per-layer window pattern "
                "(attn_window_layer_types or attn_window_pattern='even')"
            )
        if self.arch == "gpt2" and self.n_kv_heads != self.n_heads:
            raise ValueError(
                f"gpt2 is MHA: n_kv_heads ({self.n_kv_heads}) must equal "
                f"n_heads ({self.n_heads})"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be divisible by n_kv_heads "
                f"({self.n_kv_heads})"
            )
        if self.n_experts:
            if self.arch != "llama":
                raise ValueError("MoE (n_experts > 0) is llama-family only")
            if not 1 <= self.n_experts_per_tok <= self.n_experts:
                raise ValueError(
                    f"n_experts_per_tok ({self.n_experts_per_tok}) must be in "
                    f"[1, n_experts={self.n_experts}]"
                )

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def all_stop_ids(self) -> tuple:
        """eos + extra stop tokens, for host-side stop checks."""
        return (self.eos_token_id,) + tuple(self.stop_token_ids)

    @property
    def query_scale(self) -> float:
        """Attention score scale (Gemma-2 query_pre_attn_scalar**-0.5;
        Granite's attention_multiplier is a direct multiplier)."""
        if self.attn_scale_override is not None:
            return float(self.attn_scale_override)
        base = self.query_scale_override or self.head_dim
        return float(base) ** -0.5

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh (data, pipeline, sequence, tensor, expert).
    The port serves the single device only; create_engine rejects any
    other shape until the multi-GPU slice ports parallel/."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    @property
    def is_trivial(self) -> bool:
        return self.n_devices == 1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Per-request sampling parameters (the reference /generate defaults:
    temperature 0.7, top_k 50, top_p 0.9, max_tokens 20)."""

    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    max_new_tokens: int = 20
    greedy: bool = False
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving settings: the subset of the JAX EngineConfig that the solo
    engine and the continuous paged fleet read; same names, same
    defaults."""

    # Prompt-length buckets: prompts right-pad to the smallest bucket that
    # fits, and prompts longer than the largest are chunk-prefilled in
    # largest-bucket chunks — the same chunk boundaries as the JAX engine,
    # so the two produce token-identical greedy output.
    prefill_buckets: tuple = (64, 128, 256, 512, 1024, 2048)
    # Per-request wall-clock deadline in seconds (None = unlimited).
    request_deadline_s: Optional[float] = None
    # Prefix KV cache: not ported yet (the engines reject > 0).
    prefix_cache_entries: int = 0
    # Runtime LoRA adapter pages: not ported yet (the engine rejects > 0).
    adapter_slots: int = 0
    # Ragged paged ingest: the paged fleet prefills straight into the
    # block pool in flat-token launches (engine/paged.py). False: each
    # prompt is prefilled whole on a bucketed batch-1 scratch cache and
    # scattered into its blocks (engine/paged.insert_slot_paged).
    ragged_prefill: bool = True
    # Flat-token launch width of the ragged ingest programs, rounded up
    # to a whole number of query tiles (8).
    ragged_width: int = 64
    # Chunked prefill: each scheduler step is ONE mixed launch of every
    # decode row plus budget-sliced prompt chunks (engine/scheduler.py).
    # False: whole-prefill admission, each prompt landing in ragged
    # launches of its own before its slot decodes.
    chunked_prefill: bool = True
    # Per-step flat-token budget of the mixed launch (rounded up to whole
    # query tiles, and to one prefill tile above the decode fleet).
    step_token_budget: int = 128
    # SLO classes: (name, ttft_target_s, tpot_target_s, weight,
    # sheddable). The fleet apportions the prefill budget by weight x
    # urgency and sheds a sheddable class over its target; the solo
    # engine only validates and echoes the class.
    slo_classes: tuple = (
        ("interactive", 0.5, 0.1, 4.0, True),
        ("standard", 2.0, 0.5, 2.0, True),
        ("batch", 30.0, 2.0, 1.0, False),
    )
    # Class assigned when a request carries no slo_class field.
    slo_default_class: str = "standard"
    # KV preemption under pool pressure (engine/continuous.py
    # _preempt_for): when the pool cannot place an admission, the fleet
    # evicts the lowest-SLO-weight / youngest decoding request and
    # re-admits it later as a continuation prefill (prompt + its fetched
    # tokens), greedy bit-identical.
    #   "swap"      — the JAX default; with no KV shadow (not ported: the
    #                 fleet's kv_shadow raises) it drops and recomputes,
    #                 exactly as the JAX fleet does without a shadow;
    #   "recompute" — always drop the KV and re-prefill on resume;
    #   "off"       — never preempt: admission waits for a release.
    # The fleet validates it (ValueError for any other value).
    preempt_policy: str = "swap"
    # Livelock guard: a request preempted this many times becomes immune
    # (it keeps its blocks until completion; admission waits instead).
    max_preemptions_per_req: int = 2
    # Replica specialization label ("prefill" | "decode" | "mixed"),
    # reported on /health.
    replica_class: str = "mixed"
    # Per-tenant prefill-budget weights, ((tenant, weight), ...): within
    # each SLO class's tile grant the chunked-prefill scheduler splits
    # across tenants by these weights (FIFO within a tenant). Unlisted
    # tenants weigh 1.0; empty = every tenant equal.
    tenant_weights: tuple = ()
    # Tenant admission quota: one tenant's queued share of the fleet's
    # bounded queue may not exceed this fraction (beyond a small absolute
    # floor); the over-quota tenant sheds with 429 + Retry-After before
    # other tenants starve. 1.0 disables the quota.
    tenant_max_queue_share: float = 0.5

    def __post_init__(self):
        if not (0.0 < self.tenant_max_queue_share <= 1.0):
            raise ValueError(
                f"tenant_max_queue_share must be in (0, 1], got "
                f"{self.tenant_max_queue_share}"
            )
        for entry in self.tenant_weights:
            name, w = entry
            if not name or float(w) <= 0:
                raise ValueError(
                    f"tenant_weights entries need a name and a positive "
                    f"weight, got {entry!r}"
                )


def resolve_attn_impl(cfg: ModelConfig, requested: Optional[str],
                      device) -> ModelConfig:
    """Apply an --attn-impl request to a model config.

    "plain" / "kernel": explicit. "auto": the CUDA flash kernel when the
    model runs on a CUDA device, the plain path on the CPU (where the
    kernel's wrapper could only run its plain twin). None: keep the
    config's own setting.
    """
    if requested is None:
        return cfg
    if requested in ATTN_IMPLS:
        return cfg.replace(attn_impl=requested)
    if requested != "auto":
        raise ValueError(
            f"attn_impl request must be 'auto', 'plain', or 'kernel'; got "
            f"{requested!r}"
        )
    kind = torch.device(device).type
    return cfg.replace(attn_impl="kernel" if kind == "cuda" else "plain")
