"""The port's mesh layout, partitioning and wire collectives against the
JAX package's (parallel/mesh.py, partition.py, vocab.py, ops/wire_quant.py),
on the same numpy arrays.

The group layout of each (dp, pp, tp) shape is the JAX mesh's device grid;
every rank's shard of every leaf (dense, int8 and int4 weights, the vocab
ends padded to a multiple of pp) is bit-equal to the JAX shard of the same
device (the JAX shard of a short stage carries zero padding layers, the
port's only the real ones); the padding and refusals are the JAX
functions'; the wire functions hold the JAX test_wire_quant.py cases,
their collective forms over a gloo group of one process per rank.
"""

import functools
import multiprocessing
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu import MeshConfig as JaxMeshConfig  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu.ops import wire_quant as JWQ  # noqa: E402
from distributed_llm_inference_tpu.parallel import mesh as JMESH  # noqa: E402
from distributed_llm_inference_tpu.parallel import partition as JP  # noqa: E402
from distributed_llm_inference_tpu.parallel import vocab as JV  # noqa: E402
from distributed_llm_inference_tpu_torch.config import MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import wire_quant as WQ  # noqa: E402
from distributed_llm_inference_tpu_torch.ops.quant import Q4Tensor, QTensor  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import mesh as PM  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import partition as PP  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel import vocab as PV  # noqa: E402

import torch_mesh_ranks  # noqa: E402  (the spawned ranks' entry points, no jax)

SHAPES = [(1, 2, 1), (1, 1, 2), (2, 2, 1), (1, 2, 2)]


def _ids(s):
    return "dp{}-pp{}-tp{}".format(*s)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_group_layout_is_the_jax_mesh_grid(shape, eight_devices):
    """Rank r is the JAX mesh's r-th device; its dp / pp / tp groups are
    the device grid's rows through it, in axis order."""
    dp, pp, tp = shape
    mcfg = MeshConfig(dp=dp, pp=pp, tp=tp)
    jmesh = JMESH.build_mesh(JaxMeshConfig(dp=dp, pp=pp, tp=tp), eight_devices)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)  # [dp, pp, sp, tp, ep]
    for r in range(mcfg.n_devices):
        c = PM.rank_coords(mcfg, r)
        idx = tuple(c[a] for a in PM.AXES)
        assert grid[idx] == r
        assert PM.coords_rank(mcfg, c) == r
        for axis, k in (("dp", 0), ("pp", 1), ("tp", 3)):
            sl = list(idx)
            sl[k] = slice(None)
            assert PM.axis_group_ranks(mcfg, r, axis) == tuple(grid[tuple(sl)].tolist())


def test_process_group_backend_rule():
    """NCCL only where every rank has a card of its own."""
    assert PM.process_group_backend(["cpu", "cpu"]) == "gloo"
    assert PM.process_group_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert PM.process_group_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert PM.process_group_backend(["cuda:0"]) == "nccl"
    assert PM.default_devices(3, "cpu") == [torch.device("cpu")] * 3


@pytest.mark.parametrize("mesh", [MeshConfig(sp=2), MeshConfig(ep=2)], ids=["sp", "ep"])
def test_sp_and_ep_meshes_name_the_roadmap(mesh):
    """sp and ep meshes build, every rank with a group per axis (the ring
    of the axis of size 2 holding both ranks); the multi-host bring-up
    (ported with the rest of the ROADMAP heading) refuses an out-of-range
    process before it makes any group."""
    m = PM.build_mesh(mesh, ["cpu", "cpu"], timeout_s=10.0)
    try:
        axis = "sp" if mesh.sp > 1 else "ep"
        assert set(m.groups) >= set(PM.AXES)
        assert m.groups[axis].size == 2 and m.groups[axis].ranks == (0, 1)
        assert all(m.groups[a].size == 1 for a in PM.AXES if a != axis)
    finally:
        m.close()
    with pytest.raises(ValueError, match="out of range"):
        PM.multihost_initialize("localhost:1", 2, 2)
    assert PM.process_count() == 1


VALIDATE = [
    ("test-llama-tiny", 5, 1, 1), ("test-llama-tiny", 0, 1, 1),
    ("test-llama-tiny", 1, 3, 1), ("test-llama-tiny", 1, 4, 1),
    ("test-olmo2-tiny", 1, 2, 1), ("test-llama-tiny", 1, 1, 2),
    ("test-moe-tiny", 1, 2, 1), ("test-moe-tiny", 1, 1, 3),
    ("test-llama-tiny", 4, 2, 1), ("test-gpt2-tiny", 2, 4, 1),
]


@pytest.mark.parametrize("case", VALIDATE, ids=lambda c: "-".join(map(str, c)))
def test_validate_mesh_refuses_as_jax(case):
    """The same (pp, tp, ep) factorizations pass or fail with the JAX
    package's exception type and message."""
    name, pp, tp, ep = case
    def outcome(fn, cfg):
        try:
            fn(cfg, pp, tp, ep)
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__, str(e)
        return None

    assert outcome(PP.validate_mesh, get_model_config(name)) == \
        outcome(JP.validate_mesh, jax_cfg(name))


def test_padded_sizes_equal_jax():
    for L in range(1, 23):
        for pp in range(1, L + 1):
            assert PP.padded_layers_per_stage(L, pp) == JP.padded_layers_per_stage(L, pp)
    for V in (250, 251, 255, 256, 32000, 50257):
        for pp in (1, 2, 3, 4, 8):
            assert PV.padded_vocab(V, pp) == JV.padded_vocab(V, pp)


def _jparams(name, quant=None, **ov):
    return _jparams_cached(name, quant, tuple(sorted(ov.items())))


@functools.lru_cache(maxsize=None)
def _jparams_cached(name, quant, ov):
    ov = dict(ov)
    jc = jax_cfg(name, dtype="float32", **ov)
    tc = get_model_config(name, dtype="float32", **ov)
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    if quant is not None:
        jc, tc = jc.replace(quant=quant), tc.replace(quant=quant)
        params = JQ.quantize_params(jc, params)
    return jc, tc, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(leaf):
    """A port leaf as numpy arrays: (q, s) of a quantized leaf, else (x,)."""
    if isinstance(leaf, (QTensor, Q4Tensor)):
        return (leaf.q.numpy(), leaf.s.numpy())
    return (leaf.numpy(),)


def _jleaves(leaf):
    return tuple(jax.tree.leaves(leaf))


@pytest.mark.parametrize("pp", [2, 3, 4])
def test_pad_stacked_layers_bit_equal(pp):
    """7 layers over pp: each stage's rows of the JAX padded layout
    (pad_stacked_layers, padded_layers_per_stage rows a stage) are the
    port's shard of that stage (its real layers, no padding) followed by
    all-zero padding layers."""
    jc, tc, params = _jparams("test-llama-tiny", n_layers=7)
    tlayers = params_from_numpy(tc, _np(params)["layers"], "cpu")
    want = JP.pad_stacked_layers(jc, params["layers"], pp)
    per = PP.padded_layers_per_stage(7, pp)
    for s in range(pp):
        got = PP.shard_layers(tc, tlayers, s, pp)
        for k in want:
            rows = np.asarray(want[k])[s * per:(s + 1) * per]
            n = got[k].shape[0]
            np.testing.assert_array_equal(got[k].numpy(), rows[:n], err_msg=k)
            assert not rows[n:].any(), k


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_pad_vocab_bit_equal(quant):
    jc, tc, params = _jparams("test-llama-tiny", quant, vocab_size=255, n_layers=5)
    shared_np = {k: v for k, v in _np(params).items() if k != "layers"}
    shared = params_from_numpy(tc, shared_np, "cpu")
    for pp in (2, 4):
        got = PV.pad_vocab(tc, shared, pp)
        want = JV.pad_vocab(jc, {k: v for k, v in params.items() if k != "layers"}, pp)
        for k in want:
            for a, b in zip(_leaves(got[k]), _jleaves(want[k])):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


def _device_shard(arr, device):
    for sh in arr.addressable_shards:
        if sh.device == device:
            return np.asarray(sh.data)
    raise AssertionError(device)


SHARDS = [("test-llama-tiny", None, 2, 1), ("test-llama-tiny", "int8", 2, 2),
          ("test-llama-tiny", "int4", 2, 1), ("test-llama-tiny", None, 1, 2),
          ("test-llama-tiny", "int8", 3, 1), ("test-gpt2-tiny", None, 2, 2),
          ("test-qwen3-tiny", None, 2, 2)]


@pytest.mark.parametrize("case", SHARDS, ids=lambda c: "-".join(map(str, c)))
def test_shard_params_bit_equal_to_jax_device_shards(case, eight_devices):
    """Every rank's shard of every leaf equals the JAX shard on the same
    mesh device: the vocab ends padded and cut over pp, the layers of the
    rank's stage (the JAX shard's zero padding layers after them), the
    tp column / row slices, scales with their columns or groups."""
    name, quant, pp, tp = case
    jc, tc, params = _jparams(name, quant, vocab_size=255, n_layers=5)
    jmesh = JMESH.build_mesh(JaxMeshConfig(pp=pp, tp=tp), eight_devices)
    jshared, jlayers = JP.shard_params(jc, params, jmesh)
    tparams = params_from_numpy(tc, _np(params), "cpu")
    for s in range(pp):
        lo, hi = PP.stage_layer_range(tc.n_layers, pp, s)
        for t in range(tp):
            dev = jmesh.devices[0, s, 0, t, 0]
            shared, layers = PP.shard_params(tc, tparams, s, pp, t, tp)
            for k, leaf in shared.items():
                for a, b in zip(_leaves(leaf), _jleaves(jshared[k])):
                    np.testing.assert_array_equal(a, _device_shard(b, dev), err_msg=k)
            for k, leaf in layers.items():
                for a, b in zip(_leaves(leaf), _jleaves(jlayers[k])):
                    want = _device_shard(b, dev)
                    np.testing.assert_array_equal(a, want[: hi - lo], err_msg=k)
                    assert not want[hi - lo:].any(), k  # JAX's padding layers


def test_int4_row_split_must_fall_on_groups():
    """A row-sharded int4 leaf shards whole scale groups: tp that does
    not divide the groups is refused."""
    jc, tc, params = _jparams("test-llama-tiny", "int4")
    tparams = params_from_numpy(tc, _np(params), "cpu")
    assert tparams["layers"]["wo"].q.shape[1] == 1  # one group of 64 rows
    with pytest.raises(ValueError, match="int4 scale groups"):
        PP.validate_mesh(tc, 1, 2, params=tparams)


def test_cache_and_pool_specs_mirror_jax():
    """The pool's and the shadow blocks' specs, which the block gather and
    pool_layout read their axes from, are the JAX PartitionSpecs."""
    for kvq in (None, "int8"):
        cfg = get_model_config("test-llama-tiny", kv_quant=kvq)
        for port_fn, jax_fn in ((PP.pool_spec, JP.pool_spec),
                                (PP.shadow_block_spec, JP.shadow_block_spec)):
            got = port_fn(cfg)
            want = jax_fn(jax_cfg("test-llama-tiny", kv_quant=kvq))
            for name in ("k", "v"):
                leaves = got[name] if kvq else (got[name],)
                jl = jax.tree.leaves(want[name] if isinstance(want, dict) else want,
                                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
                assert [tuple(x) for x in jl] == [tuple(x) for x in leaves]


# -- the wire (JAX test_wire_quant.py's cases) ---------------------------------------


def _normal(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wire_roundtrip_equals_jax(dt):
    x = _normal(0, (2, 3, 16))
    jx = jnp.asarray(x, dt)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dt))
    w, jw = WQ.wire_encode(tx), JWQ.wire_encode(jx)
    np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(w.s.numpy(), np.asarray(jw.s))
    back = WQ.wire_roundtrip(tx).float().numpy()
    np.testing.assert_array_equal(back, np.asarray(JWQ.wire_roundtrip(jx).astype(jnp.float32)))
    err = np.abs(WQ.wire_decode(w, torch.float32).numpy() - tx.float().numpy())
    assert (err - 0.5 * w.s.numpy()[..., None]).max() <= 1e-6


def test_outlier_row_and_zero_rows():
    x = torch.from_numpy(_normal(1, (1, 4, 32)))
    spiked = x.clone()
    spiked[0, 2] *= 1e4
    base, spk = WQ.wire_roundtrip(x), WQ.wire_roundtrip(spiked)
    for t in (0, 1, 3):
        assert torch.equal(base[0, t], spk[0, t])
    assert float(spk[0, 2].abs().max()) > 1e3
    z = torch.zeros(2, 3, 8)
    assert float(WQ.wire_roundtrip(z).abs().max()) == 0.0


def test_wire_bytes_equal_jax():
    for shape, size, hops in (((1, 1, 64), 4, 1), ((2, 3, 64), 4, 5), ((8, 1, 2048), 2, 22)):
        for q in (False, True):
            assert WQ.wire_bytes(shape, size, hops, quant=q) == \
                JWQ.wire_bytes(shape, size, hops, quant=q)
    assert WQ.wire_bytes((1, 1, 64), 4, 1, quant=True) == 68


def test_wire_collectives_over_gloo_equal_jax():
    """Four ranks: the ring shift off is lax.ppermute, on is the round trip
    then the permute; the owner's broadcast off is the masked psum, on
    lands the owner's round trip everywhere (JAX test_wire_quant.py
    :135-180); each rank counts the bytes it sent."""
    world = 4
    x = _normal(4, (world, 2, 8))
    perm = [(j, (j + 1) % world) for j in range(world)]
    ring = jax.vmap(lambda y: jax.lax.ppermute(y, "r", perm), axis_name="r")
    want_off = np.asarray(ring(jnp.asarray(x)))
    want_on = np.asarray(ring(JWQ.wire_roundtrip(jnp.asarray(x))))
    ctx = multiprocessing.get_context("spawn")
    path = os.path.join(tempfile.mkdtemp(), "store")
    procs, conns = [], []
    for r in range(world):
        a, b = ctx.Pipe()
        p = ctx.Process(target=torch_mesh_ranks.wire_rank, args=(r, world, path, b), daemon=True)
        p.start()
        procs.append(p)
        conns.append(a)
    try:
        for c in conns:
            c.send_bytes(pickle.dumps(torch.from_numpy(x)))
        outs = [pickle.loads(c.recv_bytes()) if c.poll(60) else None for c in conns]
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
    owner_rt = np.asarray(JWQ.wire_roundtrip(jnp.asarray(x[0])))
    for r, o in enumerate(outs):
        assert o is not None, r
        np.testing.assert_array_equal(o[("ring", False)], want_off[r])
        np.testing.assert_array_equal(o[("ring", True)], want_on[r])
        np.testing.assert_array_equal(o[("bcast", False)], x[0])
        np.testing.assert_array_equal(o[("bcast", True)], owner_rt)
        raw, q = 2 * 8 * 4, 2 * 8 + 2 * 4
        assert o["bytes"]["microstep"] == raw + q
        assert o["bytes"].get("broadcast", 0) == ((raw + q) if r == 0 else 0)


def _prompt(seed, cfg, n=12):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, size=n).tolist()


@pytest.fixture(scope="module")
def tiny():
    jc = jax_cfg("test-llama-tiny")
    tc = get_model_config("test-llama-tiny", dtype="float32")
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, params, params_from_numpy(tc, _np(params), "cpu")


def test_proxy_off_is_the_single_device_greedy_path(tiny):
    """quant=False: the stage-sliced forward is the single device's greedy
    output token for token (JAX test_proxy_off_bit_identical_to_single_device)."""
    _, tc, _, tparams = tiny
    prompt, N = _prompt(0, tc), 12
    got = WQ.proxy_stage_generate(tc, tparams, prompt, N, 4, quant=False)
    cache = M.init_kv_cache(tc, 1, max_seq=64)
    samp = G.default_sampling(greedy=True)
    toks = torch.tensor([prompt])
    first, _, cache = G.prefill(tc, tparams, toks, len(prompt), cache, torch.Generator(), samp)
    out, _, _ = G.decode(tc, tparams, first, cache, len(prompt), N - 1, torch.Generator(),
                         samp, max_steps=N - 1)
    assert got == [int(first[0])] + out[0, : N - 1].tolist()


# the JAX test_wire_quant.py gate on this config (teacher-forced greedy
# agreement of the int8 wire, per decision)
WIRE_MATCH_MEAN = 0.90
WIRE_MATCH_MIN = 0.80


@pytest.mark.parametrize("stages", [2, 4])
def test_proxy_off_equals_jax_and_on_clears_the_jax_gate(tiny, stages):
    """quant=False: the port's proxy emits the JAX proxy's greedy ids. On,
    the int8 wire amplifies the packages' last-bit float differences
    through its rounding (the ids of the two proxies may part late), so
    each proxy is held to the JAX test's match-rate gate."""
    jc, tc, params, tparams = tiny
    prompt = _prompt(0, tc)
    assert WQ.proxy_stage_generate(tc, tparams, prompt, 12, stages, quant=False) == \
        JWQ.proxy_stage_generate(jc, params, prompt, 12, stages, quant=False)
    rates = [WQ.proxy_stage_match(tc, tparams, _prompt(seed, tc, 16), 20, stages)
             for seed in range(6)]
    assert float(np.mean(rates)) >= WIRE_MATCH_MEAN, rates
    assert min(rates) >= WIRE_MATCH_MIN, rates
