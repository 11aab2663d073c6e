"""Top-level factory: model name -> ready InferenceEngine on one device.

The counterpart of the JAX package's runtime.create_engine for the single
device. It runs on the card unless the caller asks for the CPU
(device="cpu", as the tests do); with no CUDA device it raises rather
than fall back. Params handed over (the converter's, the checkpoint
store's, or the JAX package's carried by models/bridge.py) are moved to
the device. Weights are quantized here when the config asks for it,
as in the JAX package, after a LoRA adapter is merged into them (`lora`,
merge-at-load) and before the runtime adapter pool's leaves are
installed (EngineConfig.adapter_slots > 0). `draft_model` attaches a
smaller same-tokenizer model for two-model speculation (the solo engine's
`speculative` requests, and the fleet's draft-model speculation).
A mesh (`mesh_cfg`) selects its backend in the JAX runtime's order:
`microbatches > 1` the 1F1B schedule (parallel/schedule.py), sp > 1 the
context-parallel backend (parallel/context.py, `sp_strategy` "ring" or
"ulysses"), any other mesh (dp, pp, tp, and ep on an MoE model) the
pipeline backend (parallel/pipeline.py), with the JAX runtime's checks in
its order and words. `build_mesh` spawns one worker process per further
rank, on the CUDA cards round-robin (ranks share a card when there are
fewer cards than ranks) or, asked for the CPU, on the CPU; params=None
draws each rank's weights from `seed` on its own device. Adapters and
two-model speculation on a mesh raise the not-ported error naming the
ROADMAP heading.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .config import EngineConfig, MeshConfig, ModelConfig, resolve_attn_impl
from .engine.adapters import AdapterPool, install_adapter_leaves
from .engine.engine import InferenceEngine, SingleDeviceBackend
from .models import api as M
from .models.bridge import params_to
from .models.lora import merge_lora
from .models.registry import get_model_config
from .ops.quant import quantize_params
from .parallel.mesh import build_mesh, default_devices, not_ported


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return device


def create_engine(
    model: str | ModelConfig = "tinyllama-1.1b",
    *,
    mesh_cfg: MeshConfig = MeshConfig(),
    engine_cfg: EngineConfig = EngineConfig(),
    microbatches: int = 1,
    params: Any = None,
    dtype: Optional[str] = None,
    quant: Optional[str] = None,
    kv_quant: Optional[str] = None,
    attn_impl: Optional[str] = None,
    tokenizer: Any = None,
    seed: int = 0,
    sp_strategy: str = "ring",
    draft_model: Optional[str | ModelConfig] = None,
    draft_params: Any = None,
    lora: Optional[str] = None,
    device="cuda",
) -> InferenceEngine:
    """Build an engine: on one device, or over a dp = 1 pp / tp mesh
    (create_backend). params=None draws random weights from `seed` on the
    device; pass params_from_numpy(...) to run the
    JAX package's weights. quant ("int8" | "int4") quantizes the weights
    after they are made or handed over (leaves already quantized stay as
    they are); kv_quant="int8" gives the engine an int8 KV cache.
    attn_impl: "plain" | "kernel" | "auto" (the kernel on a CUDA device)
    | None (the config's own). lora: a PEFT adapter directory merged into
    the weights before quantization. engine_cfg.adapter_slots > 0 installs
    the paged runtime LoRA leaves (engine/adapters.py) after quantization
    and hangs an AdapterPool off engine.adapters; its merged_source is
    `lora`, so the merged adapter cannot also be registered. draft_model
    (a registry name or a ModelConfig, in `dtype` when given) attaches a
    draft through engine.set_draft: draft_params, or random weights from
    seed + 1."""
    if mesh_cfg.dp > 1:
        # the serving engine decodes batch=1, which cannot shard over dp;
        # batched dp decode is a backend-level capability (create_backend)
        raise NotImplementedError(
            "dp>1 is not available through the batch-1 serving engine; "
            "use create_backend() for dp-sharded batched decode"
        )
    if not mesh_cfg.is_trivial and draft_model is not None:
        raise not_ported("two-model speculation on a mesh")
    cfg, backend = create_backend(
        model, mesh_cfg=mesh_cfg, microbatches=microbatches, params=params,
        dtype=dtype, quant=quant, kv_quant=kv_quant, attn_impl=attn_impl,
        seed=seed, sp_strategy=sp_strategy, lora=lora,
        wire_quant=engine_cfg.pp_wire_quant,
        adapter_slots=engine_cfg.adapter_slots,
        adapter_rank=engine_cfg.adapter_rank, device=device,
    )
    engine = InferenceEngine(cfg, backend=backend, tokenizer=tokenizer,
                             engine_cfg=engine_cfg, seed=seed)
    if hasattr(backend, "attach_wire_metrics"):
        backend.attach_wire_metrics(engine.metrics)
    slots = engine_cfg.adapter_slots
    if slots:
        engine.adapters = AdapterPool(cfg, backend, slots, engine_cfg.adapter_rank,
                                      registry=engine.metrics, merged_source=lora)
    if draft_model is not None:
        dcfg = (get_model_config(draft_model) if isinstance(draft_model, str)
                else draft_model)
        if dtype is not None:
            dcfg = dcfg.replace(dtype=dtype)
        engine.set_draft(dcfg, draft_params, seed=seed + 1)
    return engine


def create_backend(
    model: str | ModelConfig = "tinyllama-1.1b",
    *,
    mesh_cfg: MeshConfig = MeshConfig(),
    microbatches: int = 1,
    params: Any = None,
    dtype: Optional[str] = None,
    quant: Optional[str] = None,
    kv_quant: Optional[str] = None,
    attn_impl: Optional[str] = None,
    seed: int = 0,
    sp_strategy: str = "ring",
    lora: Optional[str] = None,
    wire_quant: Optional[str] = None,
    adapter_slots: int = 0,
    adapter_rank: int = 8,
    device="cuda",
):
    """Build a compute backend alone (no engine around it), as the JAX
    create_backend does: the single device for a trivial mesh; the 1F1B
    schedule when microbatches > 1; the context-parallel backend when
    sp > 1; the pipeline backend for any other mesh (batched callers use
    its interface directly: batch % (dp * microbatches) == 0), its ranks
    on `device`'s type (the cards round-robin). wire_quant ("int8")
    quantizes every inter-stage hand-off; ignored on the single device.
    Returns (cfg, backend)."""
    if sp_strategy != "ring" and mesh_cfg.sp <= 1:
        # before any backend branch: --sp-strategy ulysses without an sp
        # ring would otherwise run with no sequence parallelism at all
        raise ValueError(
            f"sp_strategy={sp_strategy!r} needs a context-parallel mesh "
            f"(sp > 1); got sp={mesh_cfg.sp}"
        )
    if mesh_cfg.sp > 1 and (microbatches > 1 or mesh_cfg.ep > 1):
        raise ValueError(
            "sp (context parallel) does not compose with microbatching/"
            "ep yet: the 1F1B schedule and expert dispatch assume "
            "whole-sequence activations per stage"
        )
    device = resolve_device(device)
    cfg = get_model_config(model) if isinstance(model, str) else model
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if quant is not None:
        cfg = cfg.replace(quant=quant)
    if kv_quant is not None:
        cfg = cfg.replace(kv_quant=kv_quant)
    cfg = resolve_attn_impl(cfg, attn_impl, device)
    if adapter_slots and (microbatches > 1 or mesh_cfg.sp > 1):
        raise ValueError(
            "adapter_slots > 0 (runtime LoRA serving) rides the "
            "single-device and pp/tp pipeline backends; the 1F1B "
            "and context-parallel backends carry no adapter pages"
        )
    if microbatches > 1:
        if mesh_cfg.pp < 2:
            raise ValueError(
                "microbatches > 1 needs a pipeline (pp >= 2): with one "
                "stage there is no bubble to fill and the round-robin "
                "schedule would only serialize the batch"
            )
        if cfg.arch != "llama":
            # the microbatched fleets are ragged (left-padded) batches
            raise NotImplementedError(
                f"microbatches > 1 serves ragged llama-family fleets only; "
                f"got arch={cfg.arch!r}"
            )
    if not mesh_cfg.is_trivial:
        if lora is not None or adapter_slots:
            raise not_ported("LoRA adapters on a mesh (the lora leaves' shards)")
        if microbatches > 1:
            from .parallel.schedule import MicrobatchPipelineBackend as backend_cls

            backend_cls.check(mesh_cfg, microbatches)
            kw = {"n_microbatches": microbatches}
        elif mesh_cfg.sp > 1:
            from .parallel.context import ContextParallelBackend as backend_cls

            backend_cls.check(cfg, mesh_cfg, sp_strategy)
            kw = {"sp_strategy": sp_strategy}
        else:
            from .parallel.pipeline import PipelineBackend as backend_cls

            kw = {}
        if params is not None:
            params = params_to(params, "cpu")
            if cfg.quant is not None:
                params = quantize_params(cfg, params)
        mesh = build_mesh(mesh_cfg, default_devices(mesh_cfg.n_devices, device))
        try:
            return cfg, backend_cls(cfg, params, mesh, wire_quant=wire_quant,
                                    seed=seed, **kw)
        except BaseException:
            mesh.close()
            raise
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed)
        )
    else:
        # the converter's and the store's leaves are CPU tensors
        params = params_to(params, device)
    if lora is not None:
        # merge BEFORE quantization: the delta lands in the dense weights
        params = merge_lora(cfg, params, lora)
    if cfg.quant is not None:
        params = quantize_params(cfg, params)
    if adapter_slots:
        # AFTER quantization: the paged lora leaves stay dense
        params = install_adapter_leaves(cfg, params, adapter_slots, adapter_rank)
    return cfg, SingleDeviceBackend(cfg, params, device)
