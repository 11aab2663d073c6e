"""The per-stage and sharded checkpoint-store loads of the port
(models/checkpoint.load_stage_params, load_params_sharded) and
`--checkpoint` on a mesh, on the CPU.

Stores are written by the JAX package's save_params from its init_params
(the format both packages share):

  * `load_stage_params` equal to the JAX function leaf for leaf, role
    defaults and overrides included (a tied-head last stage gets `embed`
    and no `pos_embed`);
  * every rank's `load_params_sharded` leaves equal to
    parallel/partition.shard_params of the full load on pp = 2, on
    pp = 3 x tp = 2 (uneven) and on gpt2 with its tied head (JAX
    test_checkpoint.py's three meshes), each rank holding about its share
    of the layer bytes;
  * every leaf opened once, as a read-only memory map, and nothing copied
    out of a map that is larger than the rank's own share of a leaf;
  * a pp = 2 backend built from the store (each rank its own shard) with
    the full load's greedy ids, and the server's `--checkpoint` on a mesh
    taking the sharded path unless --quant or --lora is set.

Tolerance: leaves bit-equal; greedy ids equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import checkpoint as JS  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models import checkpoint as C  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import rank_coords  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.partition import shard_params  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_backend  # noqa: E402


def _store(tmp_path_factory, model, seed, **ov):
    cfg = jax_cfg(model, **ov)
    path = str(tmp_path_factory.mktemp("store") / model)
    JS.save_params(path, cfg, JM.init_params(cfg, jax.random.PRNGKey(seed)))
    return path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return {"llama": _store(tmp_path_factory, "test-llama-tiny", 11),
            "llama_bf16": _store(tmp_path_factory, "test-llama-tiny", 12, dtype="bfloat16"),
            "gpt2": _store(tmp_path_factory, "test-gpt2-tiny", 13)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _as_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("which,pp,stage,kw", [
    ("llama", 2, 0, {}), ("llama", 2, 1, {}), ("llama_bf16", 3, 1, {}),
    ("gpt2", 2, 0, {}), ("gpt2", 2, 1, {}),
    ("gpt2", 2, 1, dict(load_embed=False)), ("llama", 2, 0, dict(load_head=True)),
])
def test_load_stage_params_equals_jax(stores, which, pp, stage, kw):
    tcfg, tp = C.load_stage_params(stores[which], pp, stage, **kw)
    jcfg, jp = JS.load_stage_params(stores[which], pp, stage, **kw)
    assert tcfg.name == jcfg.name and tcfg.n_layers == jcfg.n_layers
    got, want = _flat(tp), _flat(jp)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(_as_numpy(got[k]), np.asarray(want[k], np.float32)
                                      if got[k].dtype == torch.bfloat16 else np.asarray(want[k]))
    if which == "gpt2" and stage == pp - 1 and not kw:
        # the tied head's last stage: embed for the head, no pos_embed
        assert "embed" in tp and "pos_embed" not in tp


@pytest.mark.parametrize("which,mesh", [
    ("llama", MeshConfig(pp=2)), ("llama", MeshConfig(pp=3, tp=2)),
    ("gpt2", MeshConfig(pp=2)), ("llama_bf16", MeshConfig(pp=2, tp=2)),
], ids=["pp2", "pp3tp2_uneven", "gpt2_tied", "bf16_pp2tp2"])
def test_sharded_load_equals_shard_params_of_the_full_load(stores, which, mesh):
    cfg, full = C.load_params(stores[which])
    whole = sum(t.numel() * t.element_size() for t in _flat(full).values())
    layer_bytes = sum(t.numel() * t.element_size() for t in full["layers"].values())
    read = []
    for r in range(mesh.n_devices):
        c = rank_coords(mesh, r)
        stats = {}
        got_cfg, shared, layers = C.load_params_sharded(stores[which], mesh, r, stats=stats)
        assert got_cfg == cfg
        want_shared, want_layers = shard_params(cfg, full, c["pp"], mesh.pp, c["tp"], mesh.tp)
        assert sorted(shared) == sorted(want_shared)
        assert sorted(layers) == sorted(want_layers)
        for k in shared:
            assert torch.equal(shared[k], want_shared[k]), k
        for k in layers:
            assert torch.equal(layers[k], want_layers[k]), k
        held = sum(t.numel() * t.element_size() for t in layers.values())
        assert stats["shard_bytes"] <= held + sum(
            t.numel() * t.element_size() for t in shared.values())
        read.append(stats["shard_bytes"])
    # each rank holds at most about its share of the layers (an uneven
    # stage holds one layer more) plus the shared leaves; together the
    # ranks hold the layers once
    shared_bytes = whole - layer_bytes
    for b in read:
        assert b < whole
        assert b <= layer_bytes * 2 / mesh.n_devices + shared_bytes
    assert sum(read) <= layer_bytes + shared_bytes * mesh.n_devices


@pytest.mark.parametrize("mesh", [MeshConfig(pp=2), MeshConfig(pp=2, tp=2)],
                         ids=["pp2", "pp2tp2"])
def test_sharded_load_maps_every_leaf_and_copies_only_its_share(tmp_path_factory,
                                                                monkeypatch, mesh):
    """Each leaf is opened once, with np.load(mmap_mode="r"); numpy
    allocates less than half of one FFN leaf during a rank's load (a whole
    leaf read through numpy would allocate all of it); every tensor copied
    out of a map (`clone`) is no larger than the largest leaf the rank
    keeps. A store whose FFN leaves are 2 MiB (ffn_dim 2048) keeps the
    margins clear of numpy's and Python's own small allocations."""
    import tracemalloc

    path = _store(tmp_path_factory, "test-llama-tiny", 14, ffn_dim=2048, dtype="float32")
    ffn_bytes = 4 * 64 * 2048 * 4
    C.load_params_sharded(path, mesh, 0)  # lazy imports outside the window
    opened, cloned = [], []
    real_load, real_clone = np.load, torch.Tensor.clone

    def spy_load(file, *a, **kw):
        opened.append((file, kw.get("mmap_mode")))
        return real_load(file, *a, **kw)

    def spy_clone(self, *a, **kw):
        cloned.append(self.numel())
        return real_clone(self, *a, **kw)

    monkeypatch.setattr(np, "load", spy_load)
    monkeypatch.setattr(torch.Tensor, "clone", spy_clone)
    n_leaves = len(C._read_manifest(path)[1])
    for r in range(mesh.n_devices):
        opened.clear()
        cloned.clear()
        tracemalloc.start()
        try:
            _, shared, layers = C.load_params_sharded(path, mesh, r)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert len(opened) == n_leaves and len({f for f, _ in opened}) == n_leaves
        assert all(mode == "r" for _, mode in opened), opened
        assert peak < ffn_bytes // 2, (r, peak)
        kept = max(t.numel() for t in [*shared.values(), *layers.values()])
        assert cloned and max(cloned) <= kept, (r, max(cloned), kept)
        assert layers["w_gate"].numel() * 4 == ffn_bytes // mesh.n_devices


def test_backend_from_the_store_equals_the_full_load(stores):
    """create_backend(store=) on pp = 2: each rank reads its own shard (the
    bytes it holds on its /workers line), with the full load's greedy ids."""
    path = stores["llama"]
    cfg, params = C.load_params(path)
    _, sharded = create_backend(cfg, mesh_cfg=MeshConfig(pp=2), store=path, device="cpu")
    _, whole = create_backend(cfg, params=params, device="cpu")
    try:
        toks = torch.from_numpy(np.random.default_rng(0).integers(3, 200, (1, 12))).long()
        samp = G.default_sampling(greedy=True)
        ids = []
        for be in (sharded, whole):
            cache = be.init_cache(1, 64)
            first, _, cache = be.prefill(toks, 12, cache, torch.Generator().manual_seed(0),
                                         samp)
            out, n, _ = be.decode(first, cache, 12, 7, torch.Generator().manual_seed(0),
                                  samp, max_steps=7)
            ids.append([int(first[0])] + out[0, :int(n[0])].tolist())
        assert ids[0] == ids[1]
        lines = [r for line in sharded.health() for r in line["ranks"]]
        assert all(r["store_shard_bytes"] > 0 for r in lines), lines
    finally:
        sharded.close()


@pytest.mark.parametrize("flags,sharded", [
    (["--pp", "2"], True), (["--pp", "2", "--quant", "int8"], False),
    ([], False),
], ids=["mesh", "mesh_quant", "single"])
def test_server_checkpoint_on_a_mesh_takes_the_sharded_path(stores, monkeypatch, flags,
                                                            sharded):
    """--checkpoint on a mesh hands the ranks the store (params None) when
    --quant and --lora are unset; the full load otherwise, as the JAX
    server does."""
    from distributed_llm_inference_tpu_torch import runtime
    from distributed_llm_inference_tpu_torch.serving import server

    seen = {}

    def fake_create_engine(model, **kw):
        seen.update(kw, model=model)
        raise SystemExit("built")

    monkeypatch.setattr(runtime, "create_engine", fake_create_engine)
    with pytest.raises(SystemExit, match="built"):
        server.main(["--checkpoint", stores["llama"], "--device", "cpu", *flags])
    assert (seen["store"] is not None) == sharded
    assert (seen["params"] is None) == sharded
    assert seen["model"].name == "test-llama-tiny"
