"""Runtime LoRA adapters and merge-at-load on the port's mesh (parallel/
partition.py's lora rules, PipelineBackend.write_adapter_page, the pages
threaded through every fleet program), on the CPU: each rank a process,
gloo groups.

test-llama-tiny in fp32 with no EOS, the JAX params (PRNGKey 0) carried
over by models/bridge.py, PEFT adapter directories written from seeded
numpy factors (tests/test_torch_lora.py's `peft_factors`):

  * the lora leaves' shards against the JAX lora PartitionSpecs, leaf by
    leaf, on pp = 2 x tp = 2;
  * an adapter wave through the pp = 2 and the tp = 2 paged fleets (three
    adapters over two pages: a swap, `ad-c` of q, v and down only taking
    the page of `ad-a`, an adapter of every projection) whose greedy ids
    equal the JAX single-device fleet's with a page per adapter, one
    request at a time and in a threaded wave;
  * `--lora` merge-at-load on pp = 2 equal to the single device's merge;
  * the 1F1B and context backends refusing adapter slots in the JAX words.

Tolerance: greedy ids equal (fp32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import adapters as JA  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.parallel import partition as JPT  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import adapters as A  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models import lora as L  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import partition as PT  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_backend, create_engine  # noqa: E402
from test_torch_continuous import IdTokenizer  # noqa: E402
from test_torch_lora import peft_factors  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
RANK = 4
KW = dict(max_tokens=6, greedy=True, chat=False)
PROMPTS = ["the quick brown fox jumps over the lazy dog", "pack my box"]
ENGINE = dict(prefix_cache_entries=0, prefill_buckets=(64, 128), step_token_budget=64)
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16, restart_backoff_s=0.01)
# name -> (rank, seed, modules (None: every projection), write_peft_adapter
# keywords)
ADAPTERS = {
    "ad-a": (4, 1, None, dict(lora_alpha=8)),
    "ad-b": (2, 2, None, dict(lora_alpha=4, use_rslora=True)),
    "ad-c": (4, 3, ("q_proj", "v_proj", "down_proj"), dict(lora_alpha=8)),
}
JOBS = [(p, ad) for p in PROMPTS for ad in (None, "ad-a", "ad-b", "ad-c")]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, port params, {adapter name: PEFT dir})."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    root = tmp_path_factory.mktemp("peft")
    dirs = {}
    for name, (rank, seed, modules, kw) in ADAPTERS.items():
        f = peft_factors(tcfg, rank, seed) if modules is None else \
            peft_factors(tcfg, rank, seed, modules)
        dirs[name] = L.write_peft_adapter(str(root / name), f, r=rank, **kw)
    return params, tparams, dirs


@pytest.fixture(scope="module")
def jax_ids(weights):
    """The JAX single-device fleet's greedy ids of every (prompt, adapter),
    one at a time, over a pool of a page per adapter: no page is reused, so
    each adapter's ids are its own (a JAX page swap keeps the evicted
    adapter's leaves that the incoming one does not target)."""
    params, _, dirs = weights
    eng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                    engine_cfg=JaxEngineConfig(**ENGINE), tokenizer=IdTokenizer())
    pool = JA.attach_adapter_pool(eng, slots=len(ADAPTERS), rank=RANK)
    for n in ADAPTERS:
        pool.register(n, dirs[n])
    fleet = JC.ContinuousEngine(eng, **FLEET)
    try:
        return {(p, ad): _ids(fleet.submit(p, **KW, **({"adapter": ad} if ad else {})))
                for p, ad in JOBS}
    finally:
        fleet.close()


def _ids(r) -> list:
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


def _wave(fleet, jobs):
    from concurrent.futures import ThreadPoolExecutor

    def run(job):
        p, ad = job
        # the unsheddable class: a loaded host cannot shed a member
        return fleet.submit(p, **KW, slo_class="batch", **({"adapter": ad} if ad else {}))

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(zip(jobs, ex.map(run, jobs)))


def test_lora_leaf_shards_follow_the_jax_specs(weights):
    """Every lora leaf's shard on pp = 2 x tp = 2 is the JAX
    PartitionSpec's block: a replicated / b over tp on its out axis for a
    column-sharded base, a over tp on its in axis / b replicated for a row-
    sharded one; the layers over pp."""
    _, tparams, _ = weights
    cfg = get_model_config(MODEL, **OVERRIDES)
    full = A.install_adapter_leaves(cfg, tparams, 2, RANK)
    for name, leaf in full["layers"].items():
        if name.startswith("lora_"):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1)))
    lora = {k: v for k, v in full["layers"].items() if k.startswith("lora_")}
    assert len(lora) == 14
    for name, leaf in lora.items():
        spec = JPT._LLAMA_LAYER_SPECS[name]
        for s in range(2):
            for t in range(2):
                got = PT.shard_layers(cfg, {name: leaf}, s, 2, t, 2)[name]
                want = leaf
                for axis, mesh_axis in enumerate(spec):
                    n = {"pp": 2, "tp": 2}.get(mesh_axis)
                    if n:
                        size = want.shape[axis] // n
                        want = want.narrow(axis, (s if mesh_axis == "pp" else t) * size,
                                           size)
                assert torch.equal(got, want), (name, s, t)


def test_adapter_update_shard_cuts_rows_and_columns():
    """A page write's cut: the rank's layers, then by the lora rules."""
    cfg = get_model_config(MODEL, **OVERRIDES)
    a = np.arange(cfg.n_layers * 8 * 2, dtype=np.float32).reshape(cfg.n_layers, 8, 2)
    b = np.arange(cfg.n_layers * 2 * 6, dtype=np.float32).reshape(cfg.n_layers, 2, 6)
    ga, gb = PT.adapter_update_shard(cfg, "wo", a, b, (1, 2), 1, 2)  # a row-sharded base
    np.testing.assert_array_equal(ga, a[1:2, 4:8])
    np.testing.assert_array_equal(gb, b[1:2])
    ga, gb = PT.adapter_update_shard(cfg, "wq", a, b, (0, 1), 1, 2)  # a column-sharded one
    np.testing.assert_array_equal(ga, a[0:1])
    np.testing.assert_array_equal(gb, b[0:1, :, 3:6])


@pytest.mark.parametrize("mesh", [dict(pp=2), dict(tp=2)], ids=["pp2", "tp2"])
def test_mesh_fleet_adapter_ids_equal_jax(weights, jax_ids, mesh):
    """The paged fleet over the mesh with a pool of 2 pages and three
    adapters: each (prompt, adapter) alone (for each prompt `ad-c`, of q, v
    and down only, evicts `ad-a`, of every projection, and every rank's
    page then holds `ad-c` alone), then all in a wave, gives the JAX
    single-device fleet's greedy ids with a page per adapter; the adapters
    move the output, and afterwards no page is referenced."""
    _, tparams, dirs = weights
    eng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                        mesh_cfg=MeshConfig(**mesh), tokenizer=IdTokenizer(),
                        engine_cfg=EngineConfig(**ENGINE, adapter_slots=2,
                                                adapter_rank=RANK), device="cpu")
    fleet = None
    try:
        for n in ADAPTERS:
            eng.adapters.register(n, dirs[n])
        fleet = TC.ContinuousEngine(eng, **FLEET)
        for p, ad in JOBS:
            page_of = dict(eng.adapters._page_of)
            r = fleet.submit(p, **KW, **({"adapter": ad} if ad else {}))
            assert _ids(r) == jax_ids[(p, ad)], (p, ad)
            if ad == "ad-c":
                assert eng.adapters._page_of["ad-c"] == page_of["ad-a"]
        got = _wave(fleet, JOBS)
        assert {j: _ids(r) for j, r in got.items()} == jax_ids
        st = fleet.stats()["adapters"]
        assert st["swaps"] > 0 and st["referenced"] == 0
        assert any(jax_ids[(p, "ad-a")] != jax_ids[(p, None)] for p in PROMPTS)
    finally:
        if fleet is not None:
            fleet.close()
        eng.backend.close()


def test_merge_at_load_on_a_mesh_equals_single_device(weights):
    """`--lora` on pp = 2: merged on the driver before the shards are cut,
    with the single device's merged greedy ids."""
    _, tparams, dirs = weights
    cfg = get_model_config(MODEL, **OVERRIDES)
    kw = dict(params=tparams, lora=dirs["ad-a"], tokenizer=IdTokenizer(),
              engine_cfg=EngineConfig(**ENGINE), device="cpu")
    one = create_engine(cfg, **kw)
    pp = create_engine(cfg, mesh_cfg=MeshConfig(pp=2), **kw)
    try:
        for p in PROMPTS:
            assert (pp.generate(p, **KW)["response"] == one.generate(p, **KW)["response"])
    finally:
        pp.backend.close()


@pytest.mark.parametrize("extra", [dict(microbatches=2), dict(sp_mesh=True)],
                         ids=["1f1b", "context"])
def test_1f1b_and_context_refuse_adapter_slots_in_jax_words(extra):
    mesh = MeshConfig(sp=2) if extra.pop("sp_mesh", False) else MeshConfig(pp=2)
    with pytest.raises(ValueError, match="carry no adapter pages"):
        create_backend(get_model_config(MODEL, **OVERRIDES), mesh_cfg=mesh,
                       adapter_slots=2, device="cpu", **extra)
