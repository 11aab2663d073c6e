"""PyTorch port vs JAX package: the HF converter (models/convert.py) and the
local checkpoint store (models/checkpoint.py) on the CPU.

Tiny random transformers models are built in the test process, one per
`model_type` the JAX converter takes (llama, mistral, qwen2, qwen3,
qwen3_moe, mixtral, gemma, gemma2, gemma3_text, phi3, granite, olmo2,
gpt2). For each, `config_from_hf` gives the JAX package's config field
for field (the attention route in each package's own words) and the
state dict becomes the JAX converter's params array for array. Through
files: `load_hf_checkpoint` on `save_pretrained` directories (one file, a
sharded index, BF16 weights), the CLI (the store and the copied tokenizer
files), and stores written by either package loaded by the other."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from distributed_llm_inference_tpu.models import checkpoint as JS  # noqa: E402
from distributed_llm_inference_tpu.models import convert as JV  # noqa: E402
from distributed_llm_inference_tpu_torch.models import checkpoint as TS  # noqa: E402
from distributed_llm_inference_tpu_torch.models import convert as TV  # noqa: E402

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             pad_token_id=0, bos_token_id=1, eos_token_id=2)


def _hf_configs():
    """{model_type: a tiny transformers config} for every model_type the
    JAX converter takes."""
    T = transformers
    return {
        "llama": T.LlamaConfig(**SMALL, attention_bias=True,
                               rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                             "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                             "original_max_position_embeddings": 64}),
        "mistral": T.MistralConfig(**SMALL, sliding_window=32),
        "qwen2": T.Qwen2Config(**SMALL, tie_word_embeddings=True),
        "qwen3": T.Qwen3Config(**SMALL, head_dim=24),
        "qwen3_moe": T.Qwen3MoeConfig(**SMALL, head_dim=24, moe_intermediate_size=48,
                                      num_experts=4, num_experts_per_tok=2,
                                      norm_topk_prob=True),
        "mixtral": T.MixtralConfig(**SMALL, num_local_experts=4, num_experts_per_tok=2),
        "gemma": T.GemmaConfig(**SMALL, head_dim=16),
        "gemma2": T.Gemma2Config(**SMALL, head_dim=16, sliding_window=32,
                                 query_pre_attn_scalar=16),
        "gemma3_text": T.Gemma3TextConfig(**SMALL, head_dim=16, sliding_window=32,
                                          layer_types=["sliding_attention", "full_attention"]),
        "phi3": T.Phi3Config(**SMALL),
        "granite": T.GraniteConfig(**SMALL, embedding_multiplier=2.0,
                                   residual_multiplier=0.5, attention_multiplier=0.25,
                                   logits_scaling=4.0),
        "olmo2": T.Olmo2Config(**SMALL),
        "gpt2": T.GPT2Config(vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128),
    }


HF = _hf_configs()


def _model(hf_cfg, seed=0):
    torch.manual_seed(seed)
    m = transformers.AutoModelForCausalLM.from_config(hf_cfg)
    # HF leaves norms at 1 and some biases at 0: perturb every tensor so
    # each leaf's placement is checked
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return m.eval()


def _cfg_equal(tcfg, jcfg):
    """Field for field, the attention route mapped (port plain = JAX xla)."""
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert (t.pop("attn_impl"), j.pop("attn_impl")) == ("plain", "xla")
    assert t == j


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _params_equal(tparams, jparams):
    t, j = _flat(tparams), _flat(jparams)
    assert sorted(t) == sorted(j)
    for k in t:
        a = t[k]
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu", k
        want = np.asarray(j[k]).astype(np.float32)
        assert tuple(a.shape) == want.shape, k
        assert np.array_equal(a.float().numpy(), want), k


@pytest.mark.parametrize("model_type", sorted(HF))
def test_config_and_state_dict_equal_jax(model_type):
    """config_from_hf and the state dict's params, for every model_type,
    in float32 and bfloat16."""
    m = _model(HF[model_type])
    assert m.config.model_type == model_type
    for dtype in ("float32", "bfloat16"):
        tcfg, tparams = TV.params_from_hf_model(m, dtype=dtype)
        jcfg, jparams = JV.params_from_hf_model(m, dtype=dtype)
        _cfg_equal(tcfg, jcfg)
        _params_equal(tparams, jparams)
        assert all(v.dtype == tcfg.torch_dtype for k, v in _flat(tparams).items()
                   if not k.endswith("window_flag"))


def test_config_refusals_equal_jax():
    """The converter refuses what the JAX one refuses, in the same words."""
    bad = [
        transformers.LlamaConfig(**SMALL, rope_scaling={"rope_type": "yarn", "factor": 2.0}),
        transformers.Qwen3MoeConfig(**SMALL, num_experts=4, mlp_only_layers=[0]),
    ]
    for hf_cfg in bad:
        with pytest.raises(ValueError) as want:
            JV.config_from_hf(hf_cfg)
        with pytest.raises(ValueError) as got:
            TV.config_from_hf(hf_cfg)
        assert str(got.value) == str(want.value)


def _saved(tmp_path, model_type, dtype=None, name="hf"):
    m = _model(HF[model_type])
    d = str(tmp_path / name)
    if dtype is not None:
        m = m.to(dtype)
    m.save_pretrained(d, safe_serialization=True)
    return m, d


@pytest.mark.parametrize("model_type", ["llama", "gpt2", "qwen3_moe"])
def test_load_hf_checkpoint_equals_jax(tmp_path, model_type):
    """A save_pretrained directory read by both packages' loaders (the
    port's without transformers): the same config and arrays, and the
    in-memory conversion's."""
    m, d = _saved(tmp_path, model_type)
    tcfg, tparams = TV.load_hf_checkpoint(d, dtype="float32")
    jcfg, jparams = JV.load_hf_checkpoint(d, dtype="float32")
    _cfg_equal(tcfg, jcfg)
    _params_equal(tparams, jparams)
    _, mem = TV.params_from_hf_model(m, dtype="float32")
    _params_equal(tparams, jax.tree.map(np.asarray, jparams))
    assert all(torch.equal(a, b) for a, b in zip(_flat(tparams).values(), _flat(mem).values()))


def test_sharded_index_and_bf16_files(tmp_path):
    """A checkpoint split over two files with model.safetensors.index.json,
    written by the port's safetensors writer in BF16, loads to the same
    arrays in both packages and to the one-file load's."""
    m, d = _saved(tmp_path, "llama", dtype=torch.bfloat16)
    whole = TV.load_safetensors_dir(d)
    assert all(TV.is_bf16(a) for a in whole.values())
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    names = sorted(whole)
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        TV.save_safetensors_file(str(sharded / fname), {k: whole[k] for k in part})
        weight_map.update({k: fname for k in part})
    (sharded / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    shutil.copy(os.path.join(d, "config.json"), sharded / "config.json")
    for dtype in ("bfloat16", "float32"):
        tcfg, tparams = TV.load_hf_checkpoint(str(sharded), dtype=dtype)
        jcfg, jparams = JV.load_hf_checkpoint(str(sharded), dtype=dtype)
        _cfg_equal(tcfg.replace(name="x"), jcfg.replace(name="x"))
        _params_equal(tparams, jparams)
        _, one = TV.load_hf_checkpoint(d, dtype=dtype)
        assert all(torch.equal(a, b) for a, b in zip(_flat(tparams).values(), _flat(one).values()))
    # a shard that lost a tensor is refused
    weight_map["model.norm.weight"] = "model-00003-of-00002.safetensors"
    (sharded / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    with pytest.raises(FileNotFoundError):
        TV.load_hf_checkpoint(str(sharded))


def test_convert_cli_writes_a_store_both_packages_load(tmp_path, capsys):
    """`--in hf_dir --out store` writes the store and copies the tokenizer
    files; the JAX package's load_params and the port's read it to the
    in-memory conversion's arrays."""
    m, d = _saved(tmp_path, "gpt2")
    for f in ("tokenizer.json", "vocab.json", "merges.txt"):
        (tmp_path / "hf" / f).write_text("{}")
    out = str(tmp_path / "store")
    assert TV.main(["--in", d, "--out", out, "--dtype", "bfloat16", "--name", "g"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "gpt2" and summary["model"] == "g"
    assert sorted(summary["tokenizer_files"]) == ["merges.txt", "tokenizer.json", "vocab.json"]
    tcfg, tparams = TS.load_params(out)
    jcfg, jparams = JS.load_params(out)
    _cfg_equal(tcfg, jcfg)
    _params_equal(tparams, jparams)
    assert summary["n_params"] == sum(v.numel() for v in _flat(tparams).values())
    _, mem = TV.params_from_hf_model(m, dtype="bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(_flat(tparams).values(), _flat(mem).values()))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model_type,dtype", [("qwen3_moe", "float32"),
                                              ("gemma3_text", "bfloat16"),
                                              ("gpt2", "bfloat16")])
def test_store_written_by_either_package_loads_in_the_other(tmp_path, writer, model_type, dtype):
    m = _model(HF[model_type])
    tcfg, tparams = TV.params_from_hf_model(m, dtype=dtype)
    jcfg, jparams = JV.params_from_hf_model(m, dtype=dtype)
    d = str(tmp_path / "store")
    if writer == "jax":
        JS.save_params(d, jcfg, jparams)
    else:
        TS.save_params(d, tcfg, tparams)
    manifest = json.loads((tmp_path / "store" / "manifest.json").read_text())
    assert manifest["config"]["attn_impl"] == "xla"
    got_cfg, got = TS.load_params(d)
    assert got_cfg == tcfg
    assert all(torch.equal(a, b) for a, b in zip(_flat(got).values(), _flat(tparams).values()))
    jgot_cfg, jgot = JS.load_params(d)
    # the JAX reader turns back only stop_token_ids into a tuple (gemma-3's
    # layer types come back as a list), the port's every tuple field
    lists = {k: tuple(v) for k, v in dataclasses.asdict(jgot_cfg).items()
             if isinstance(v, list)}
    assert jgot_cfg.replace(**lists) == jcfg
    _cfg_equal(got_cfg, jgot_cfg.replace(**lists))
    _params_equal(got, jgot)
