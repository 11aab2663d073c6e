"""PyTorch port vs JAX package: LoRA adapters on disk, merged and stacked.

PEFT-format adapter directories are written from seeded numpy factors by
the port's `write_peft_adapter` (F32, and one BF16 file), then read by
both packages on test-llama-tiny in fp32 (the JAX params, PRNGKey 0,
carried over by models/bridge.py):

  * `merge_lora`: every leaf equal to the JAX merge (atol 1e-6), the
    untargeted leaves untouched;
  * `load_lora_stacked`: every stacked tensor equal to the JAX one;
  * every rejection of `_check_adapter_cfg` and of the loaders, raised by
    both packages for the same directory;
  * the safetensors reader: BF16 through its uint16 carrier, values equal
    to the JAX reader's (ml_dtypes) and to the F32 file's after rounding;
  * `create_engine(lora=...)`: greedy output equal to the JAX engine's,
    raw and with the merged weights quantized to int8.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu import create_engine as jax_create_engine  # noqa: E402
from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import convert as JC  # noqa: E402
from distributed_llm_inference_tpu.models import lora as JL  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.models import convert as C  # noqa: E402
from distributed_llm_inference_tpu_torch.models import lora as L  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import quant as Q  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=256)
MERGE_ATOL = 1e-6
ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
ALL = ATTN + ("gate_proj", "up_proj", "down_proj")


def peft_factors(cfg, rank, seed, modules=ALL, scale=0.1):
    """Seeded numpy LoRA factors {PEFT module: (A [L, r, in], B [L, out, r])}
    at the config's widths; B is non-zero, so every delta moves."""
    D, Dh, H, KV, F = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    dims = {"q_proj": (D, H * Dh), "k_proj": (D, KV * Dh), "v_proj": (D, KV * Dh),
            "o_proj": (H * Dh, D), "gate_proj": (D, F), "up_proj": (D, F),
            "down_proj": (F, D)}
    rng = np.random.default_rng(seed)
    return {m: ((rng.standard_normal((cfg.n_layers, rank, dims[m][0])) * scale)
                .astype(np.float32),
                (rng.standard_normal((cfg.n_layers, dims[m][1], rank)) * scale)
                .astype(np.float32))
            for m in modules}


# name -> (rank, seed, modules, write_peft_adapter keywords)
VARIANTS = {
    "all_r4": (4, 1, ALL, dict(lora_alpha=8)),
    "attn_r8": (8, 2, ATTN, dict(lora_alpha=16)),
    "mlp_rslora": (4, 3, ("gate_proj", "down_proj"), dict(lora_alpha=8, use_rslora=True)),
    "all_bf16": (4, 4, ALL, dict(lora_alpha=4, bf16=True)),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    tcfg = get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def adapters(tmp_path_factory, model):
    _, _, tcfg, _ = model
    root = tmp_path_factory.mktemp("adapters")
    out = {}
    for name, (rank, seed, modules, kw) in VARIANTS.items():
        out[name] = L.write_peft_adapter(str(root / name),
                                         peft_factors(tcfg, rank, seed, modules),
                                         r=rank, **kw)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_merge_lora_equal_jax(model, adapters, variant):
    jcfg, jparams, tcfg, tparams = model
    jm = JL.merge_lora(jcfg, jparams, adapters[variant])
    tm = L.merge_lora(tcfg, tparams, adapters[variant])
    modules = VARIANTS[variant][2]
    targeted = {L._MODULE_TO_LEAF[m] for m in modules}
    for leaf, w in tm["layers"].items():
        np.testing.assert_allclose(w.numpy(), np.asarray(jm["layers"][leaf]),
                                   atol=MERGE_ATOL, rtol=0, err_msg=leaf)
        moved = not torch.equal(w, tparams["layers"][leaf])
        assert moved == (leaf in targeted), leaf
    # the input params are left as they were
    assert torch.equal(tparams["layers"]["wq"],
                       torch.from_numpy(np.array(jparams["layers"]["wq"])))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("max_rank", [8, 12])
def test_load_lora_stacked_equal_jax(model, adapters, variant, max_rank):
    jcfg, _, tcfg, _ = model
    js = JL.load_lora_stacked(jcfg, adapters[variant], max_rank)
    ts = L.load_lora_stacked(tcfg, adapters[variant], max_rank)
    assert sorted(ts) == sorted(js)
    for leaf in js:
        for a, b in zip(js[leaf], ts[leaf]):
            assert b.dtype == np.float32 and b.shape[2 if a is js[leaf][0] else 1] == max_rank
            np.testing.assert_array_equal(b, a, err_msg=leaf)


def _patched(src, dst, cfg_patch=None, drop=(), rename=None, extra=None):
    """A copy of the adapter dir at src with its config patched, tensors
    dropped, renamed or added."""
    os.makedirs(dst)
    with open(os.path.join(src, "adapter_config.json")) as f:
        acfg = json.load(f)
    acfg.update(cfg_patch or {})
    with open(os.path.join(dst, "adapter_config.json"), "w") as f:
        json.dump(acfg, f)
    tensors = {k: np.array(v) for k, v in
               C.load_safetensors_file(os.path.join(src, "adapter_model.safetensors")).items()
               if k not in drop}
    for old, new in (rename or {}).items():
        tensors[new] = tensors.pop(old)
    tensors.update(extra or {})
    C.save_safetensors_file(os.path.join(dst, "adapter_model.safetensors"), tensors)
    return dst


A0 = "base_model.model.model.layers.{}.self_attn.q_proj.lora_A.weight"
B0 = "base_model.model.model.layers.{}.self_attn.q_proj.lora_B.weight"
# name -> (patch keywords, match, loaders it applies to)
REJECTIONS = {
    "dora": (dict(cfg_patch={"use_dora": True}), "DoRA", "both"),
    "alpha_pattern": (dict(cfg_patch={"alpha_pattern": {"q_proj": 32}}), "alpha_pattern",
                      "both"),
    "layers_to_transform": (dict(cfg_patch={"layers_to_transform": [1]}),
                            "layers_to_transform", "both"),
    "modules_to_save": (dict(cfg_patch={"modules_to_save": ["lm_head"]}), "modules_to_save",
                        "both"),
    "bias": (dict(cfg_patch={"bias": "lora_only"}), "bias", "both"),
    "partial_layers": (dict(drop=(A0.format(1), B0.format(1))), "missing", "both"),
    "rank_mismatch": (dict(cfg_patch={"r": 2}), "rank mismatch", "both"),
    "unknown_tensor": (dict(extra={"base_model.model.lm_head.weight":
                                   np.zeros((4, 4), np.float32)}), "silently drop", "both"),
    "no_supported_module": (None, "none of the supported", "both"),
    "over_pool_rank": (dict(), "exceeds the adapter pool rank", "stacked"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejections_match_jax(model, adapters, tmp_path, case):
    """Each adapter the JAX loaders refuse, the port's refuse too, with the
    same exception type and message."""
    jcfg, jparams, tcfg, tparams = model
    kw, match, which = REJECTIONS[case]
    src = adapters["attn_r8"] if case == "over_pool_rank" else adapters["all_r4"]
    if case == "no_supported_module":
        # a q_proj-only adapter whose tensors name a module nobody serves
        src = L.write_peft_adapter(str(tmp_path / "q_only"),
                                   peft_factors(tcfg, 4, 9, ("q_proj",)),
                                   r=4, lora_alpha=8)
        kw = dict(rename={A0.format(i): A0.format(i).replace("q_proj", "x_proj")
                          for i in range(tcfg.n_layers)}
                  | {B0.format(i): B0.format(i).replace("q_proj", "x_proj")
                     for i in range(tcfg.n_layers)})
    d = _patched(src, str(tmp_path / case), **kw)
    calls = [("stacked", lambda m, c, p: m.load_lora_stacked(c, d, 4))]
    if which == "both":
        calls.append(("merge", lambda m, c, p: m.merge_lora(c, p, d)))
    for name, call in calls:
        with pytest.raises(ValueError, match=match) as jerr:
            call(JL, jcfg, jparams)
        with pytest.raises(ValueError, match=match) as terr:
            call(L, tcfg, tparams)
        assert str(terr.value) == str(jerr.value), name


@pytest.mark.parametrize("case", ["missing_dir", "missing_tensors", "quantized", "gpt2"])
def test_loader_refusals_match_jax(model, adapters, tmp_path, case):
    jcfg, jparams, tcfg, tparams = model
    d = adapters["all_r4"]
    if case == "missing_dir":
        d = str(tmp_path / "nope")
    elif case == "missing_tensors":
        os.makedirs(tmp_path / "cfg_only")
        with open(tmp_path / "cfg_only" / "adapter_config.json", "w") as f:
            json.dump({"r": 4}, f)
        d = str(tmp_path / "cfg_only")
    if case in ("missing_dir", "missing_tensors"):
        with pytest.raises(FileNotFoundError):
            JL.merge_lora(jcfg, jparams, d)
        with pytest.raises(FileNotFoundError):
            L.merge_lora(tcfg, tparams, d)
        with pytest.raises(FileNotFoundError):
            L.load_lora_stacked(tcfg, d, 8)
    elif case == "quantized":
        from distributed_llm_inference_tpu.ops.quant import quantize_params as jq

        qcfg = tcfg.replace(quant="int8")
        with pytest.raises(ValueError, match="quantized"):
            JL.merge_lora(jcfg, jq(jcfg.replace(quant="int8"), jparams, mode="int8"), d)
        with pytest.raises(ValueError, match="quantized"):
            L.merge_lora(qcfg, Q.quantize_params(qcfg, tparams), d)
    else:
        for m, cfg in ((JL, jcfg), (L, tcfg)):
            g = cfg.replace(arch="gpt2", n_kv_heads=cfg.n_heads)
            with pytest.raises(ValueError, match="llama"):
                m.merge_lora(g, {}, d)
            with pytest.raises(ValueError, match="llama"):
                m.load_lora_stacked(g, d, 8)


def test_bf16_file_reads_as_jax_does(model, adapters, tmp_path):
    """A BF16 safetensors file: the port's carrier is marked, widens to the
    values the JAX reader's ml_dtypes array holds, and equals the F32
    factors rounded to bfloat16; genuine I16 / U16 tensors stay unmarked."""
    _, _, tcfg, _ = model
    path = os.path.join(adapters["all_bf16"], "adapter_model.safetensors")
    mine, theirs = C.load_safetensors_file(path), JC.load_safetensors_file(path)
    assert sorted(mine) == sorted(theirs)
    raw = peft_factors(tcfg, 4, VARIANTS["all_bf16"][1])
    for name, arr in mine.items():
        assert C.is_bf16(arr) and arr.shape == theirs[name].shape
        np.testing.assert_array_equal(C.as_float32(arr), theirs[name].astype(np.float32))
    a = raw["q_proj"][0][0]
    want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(C.as_float32(mine[A0.format(0)]), want)
    plain = {"i16": np.arange(-3, 3, dtype=np.int16), "u8": np.arange(4, dtype=np.uint8),
             "f32": np.linspace(0, 1, 5, dtype=np.float32)}
    C.save_safetensors_file(str(tmp_path / "plain.safetensors"), plain)
    back = C.load_safetensors_file(str(tmp_path / "plain.safetensors"))
    theirs = JC.load_safetensors_file(str(tmp_path / "plain.safetensors"))
    for k, v in plain.items():
        assert not C.is_bf16(back[k])
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(theirs[k], v)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_create_engine_lora_greedy_equal_jax(model, adapters, quant):
    """create_engine(lora=...) merges before quantization in both packages:
    the solo engine's greedy output is the JAX engine's."""
    jcfg, jparams, tcfg, tparams = model
    d = adapters["all_r4"]
    jeng = jax_create_engine(jcfg, params=jparams, lora=d, quant=quant,
                             engine_cfg=JaxEngineConfig(prefill_buckets=(32, 64)))
    teng = create_engine(tcfg, params=tparams, lora=d, quant=quant, device="cpu",
                         engine_cfg=EngineConfig(prefill_buckets=(32, 64)))
    base = create_engine(tcfg, params=tparams, quant=quant, device="cpu",
                         engine_cfg=EngineConfig(prefill_buckets=(32, 64)))
    kw = dict(max_tokens=8, greedy=True, chat=False)
    for prompt in ("lora merge", "the quick brown fox"):
        jr, tr = jeng.generate(prompt, **kw), teng.generate(prompt, **kw)
        assert jr["status"] == tr["status"] == "success"
        assert tr["response"] == jr["response"], prompt
    # the merged adapter moves the output of at least one prompt
    assert any(teng.generate(p, **kw)["response"] != base.generate(p, **kw)["response"]
               for p in ("lora merge", "the quick brown fox"))
