"""The MoE FFN over the port's expert mesh (parallel/partition.py's ep
shards, models/llama.moe_ffn's sum over the ep group) against the JAX
package's PipelineBackend on the same mesh shape and the same weights (the
ep cases of tests/test_moe.py), on the CPU: each rank a process, gloo
groups.

Every world is module-scoped and shared; its finalizer joins every rank.

Tolerances: fp32 prefill logits within 1e-5 of the JAX program's (the
expert shares and the vocab shards sum in another order), greedy ids
equal.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu import MeshConfig as JaxMeshConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu.parallel import partition as JP  # noqa: E402
from distributed_llm_inference_tpu.runtime import create_backend as jax_backend  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import partition as TP  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.pipeline import PipelineBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

LOGITS_ATOL = 1e-5
TIMEOUT_S = 10.0
MODEL = "test-moe-tiny"  # 4 layers, 4 experts, top 2

# name -> (config overrides, mesh, quant)
WORLDS = {
    "ep4": ({}, dict(ep=4), None),
    "ep2": ({}, dict(ep=2), None),
    "pp2ep2": ({}, dict(pp=2, ep=2), None),
    "uneven": (dict(n_layers=3), dict(pp=2, ep=2), None),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class World:
    def __init__(self, name):
        ov, mesh, quant = WORLDS[name]
        self.jc = jax_cfg(MODEL, dtype="float32", eos_token_id=-1, **ov)
        self.tc = get_model_config(MODEL, dtype="float32", eos_token_id=-1, **ov)
        params = JM.init_params(self.jc, jax.random.PRNGKey(0))
        if quant:
            self.jc, self.tc = self.jc.replace(quant=quant), self.tc.replace(quant=quant)
            params = JQ.quantize_params(self.jc, params)
        self.params = params
        self.tparams = params_from_numpy(self.tc, _np(params), "cpu")
        self.mesh = mesh
        _, self.jb = jax_backend(self.jc, mesh_cfg=JaxMeshConfig(**mesh), params=params)
        n = MeshConfig(**mesh).n_devices
        self.tb = PipelineBackend(self.tc, self.tparams, build_mesh(
            MeshConfig(**mesh), ["cpu"] * n, timeout_s=TIMEOUT_S))


@pytest.fixture(scope="module")
def worlds(request):
    made = {}

    def get(name):
        if name not in made:
            made[name] = World(name)
        return made[name]

    def close():  # every mesh at once: each close waits for its ranks to exit
        with ThreadPoolExecutor() as ex:
            list(ex.map(lambda w: w.tb.close(), made.values()))

    request.addfinalizer(close)
    return get


def _tokens(cfg, B=2, plen=9, bucket=16, seed=2):
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, cfg.vocab_size, size=(B, plen))
    return np.pad(rows, ((0, 0), (0, bucket - plen)),
                  constant_values=cfg.pad_token_id).astype(np.int32)


def _runs(w, toks, plen=9, steps=6):
    s = JG.default_sampling(greedy=True)
    cache = w.jb.init_cache(toks.shape[0], 64)
    f, lg, cache = w.jb.prefill(jnp.asarray(toks), jnp.int32(plen), cache,
                                jax.random.PRNGKey(3), s)
    o, n, _ = w.jb.decode(f, cache, jnp.int32(plen), jnp.int32(steps), jax.random.PRNGKey(4),
                          s, max_steps=steps)
    want = tuple(np.asarray(t) for t in (f, lg, o, n))
    ts = G.default_sampling(greedy=True)
    cache = w.tb.init_cache(toks.shape[0], 64)
    f, lg, cache = w.tb.prefill(torch.from_numpy(toks).long(), plen, cache, torch.Generator(), ts)
    o, n, _ = w.tb.decode(f, cache, plen, steps, torch.Generator(), ts, max_steps=steps)
    return tuple(t.numpy() for t in (f, lg, o, n)), want


def _assert_equal(got, want):
    np.testing.assert_allclose(got[1], want[1], atol=LOGITS_ATOL, rtol=0)
    for g, x in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", ["ep4", "ep2", "pp2ep2"])
def test_expert_parallel_matches_jax(worlds, name):
    """ep-sharded expert banks (E / ep experts per rank), alone and under
    pp: prefill logits and greedy ids of the JAX PipelineBackend on the
    same mesh."""
    w = worlds(name)
    bank = w.tb._rank.stage.layers["w_gate"]
    bank = getattr(bank, "q", bank)
    assert bank.shape[1] == w.tc.n_experts // w.mesh["ep"]
    assert w.tb._rank.stage.layers["w_router"].shape[-1] == w.tc.n_experts
    _assert_equal(*_runs(w, _tokens(w.tc)))


def test_moe_uneven_pp_no_op_padding(worlds):
    """3 layers over pp 2 x ep 2: the port's stages run their real layers
    (2 and 1), the JAX mesh pads the shorter stage with no-op layers; the
    logits and ids agree."""
    w = worlds("uneven")
    assert [ln["layers"] for ln in w.tb.health()] == [[0, 1], [2]]
    _assert_equal(*_runs(w, _tokens(w.tc, B=1, plen=4, seed=5), plen=4))


def test_shards_equal_the_jax_device_shards(worlds):
    """Every rank's expert shard is the JAX mesh's device shard of the
    same bank, dense and int8 (data and scales): the E axis cut by ep, the
    router whole."""
    from distributed_llm_inference_tpu_torch.ops.quant import QTensor, quantize_params

    w = worlds("ep2")
    q8 = quantize_params(w.tc.replace(quant="int8"), w.tparams)
    jq8 = JQ.quantize_params(w.jc.replace(quant="int8"), w.params)
    for tree, jtree in ((w.tparams, w.params), (q8, jq8)):
        for name in ("w_gate", "w_down", "w_router"):
            rule = TP.layer_tp_rule(w.tc, name)
            # the JAX specs: the banks' axis 1 over ep, the router replicated
            assert (rule == TP.EXPERT) == (name != "w_router")
            for e in range(2):
                mine = TP.shard_layer_leaf(tree["layers"][name], rule,
                                           (0, w.tc.n_layers), 0, 1, e, 2)
                jleaf = jtree["layers"][name]
                pairs = ([(mine.q, jleaf.q), (mine.s, jleaf.s)] if isinstance(mine, QTensor)
                         else [(mine, jleaf)])
                for got, want in pairs:
                    want = np.asarray(want)
                    if rule == TP.EXPERT:
                        E = want.shape[1] // 2
                        want = want[:, e * E:(e + 1) * E]
                    np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_validation_for_experts():
    """validate_mesh's ep rules in the JAX package's words: ep > 1 needs
    an MoE model, n_experts divisible by ep, no MoE under tp."""
    dense = get_model_config("test-llama-tiny")
    moe = get_model_config(MODEL)
    jdense, jmoe = jax_cfg("test-llama-tiny"), jax_cfg(MODEL)
    for (c, jc), kw, err in (((dense, jdense), dict(pp=1, tp=1, ep=2), ValueError),
                             ((moe, jmoe), dict(pp=1, tp=1, ep=3), ValueError),
                             ((moe, jmoe), dict(pp=1, tp=2, ep=1), NotImplementedError)):
        with pytest.raises(err) as want:
            JP.validate_mesh(jc, **kw)
        with pytest.raises(err) as got:
            TP.validate_mesh(c, **kw)
        assert str(got.value) == str(want.value)
    TP.validate_mesh(moe, pp=2, tp=1, ep=4)


def test_moe_engine_end_to_end(worlds):
    """create_engine over ep 2: a served greedy request equal to the
    single device's engine on the same weights."""
    w = worlds("ep2")
    eng = create_engine(w.tc, mesh_cfg=MeshConfig(ep=2), params=w.tparams,
                        engine_cfg=EngineConfig(prefill_buckets=(32,), prefix_cache_entries=0),
                        device="cpu")
    try:
        assert eng.backend.name == "pipeline" and eng.backend.ep == 2
        single = InferenceEngine(w.tc, params=w.tparams, device="cpu",
                                 engine_cfg=EngineConfig(prefill_buckets=(32,),
                                                         prefix_cache_entries=0))
        a = single.generate("mixture of experts", max_tokens=5, greedy=True, chat=False)
        b = eng.generate("mixture of experts", max_tokens=5, greedy=True, chat=False)
        assert b["status"] == "success", b
        assert b["response"] == a["response"] and b["tokens_generated"] >= 1
    finally:
        eng.backend.close()


def test_paged_fleet_over_the_expert_mesh(worlds):
    """The continuous paged fleet over pp 2 x ep 2 (the plain ring's slot
    programs, the expert sum in every layer): three concurrent greedy
    requests, the ids of the same fleet on the single device."""
    w = worlds("pp2ep2")
    ecfg = EngineConfig(prefill_buckets=(32,), prefix_cache_entries=0)
    prompts = ["the quick brown fox", "mixture of experts", "a b c d e f"]

    def ids(engine):
        fleet = ContinuousEngine(engine, n_slots=2, chunk_steps=4, slot_max_seq=64,
                                 kv_pool_blocks=24, kv_block_size=8)
        out = {}
        try:
            ts = [threading.Thread(target=lambda i=i, p=p: out.update(
                {i: fleet.submit(p, max_tokens=8, greedy=True, chat=False)}))
                for i, p in enumerate(prompts)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
        finally:
            fleet.close()
        return [out[i]["token_ids"] for i in range(len(prompts))]

    mesh_engine = InferenceEngine(w.tc, backend=w.tb, engine_cfg=ecfg)
    single = InferenceEngine(w.tc, params=w.tparams, device="cpu", engine_cfg=ecfg)
    assert ids(mesh_engine) == ids(single)


def test_expert_ms_is_the_kernels_inside_the_range():
    """A rank profile's experts_ms is the union of the kernel intervals
    that fall inside the expert range's device spans, not the spans'
    length: the idle gaps inside a span and the kernels outside it do not
    count."""
    from distributed_llm_inference_tpu_torch.parallel.pipeline import _clip_ns, _union_ns

    kernels = [(0, 10), (5, 8), (12, 20), (25, 30), (40, 45)]
    spans = [(3, 13), (19, 26), (22, 24)]
    assert sorted(_clip_ns(kernels, spans)) == [(3, 10), (5, 8), (12, 13), (19, 20), (25, 26)]
    assert _union_ns(_clip_ns(kernels, spans)) == 10
    assert _union_ns(kernels) == 28
    assert _union_ns(_clip_ns(kernels, [])) == 0
