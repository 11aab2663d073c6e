"""The port's dp x pp x tp pipeline backend (parallel/pipeline.py) against
the JAX package's PipelineBackend on the same mesh shape and the same
weights (the counterparts of tests/test_pipeline.py and
tests/test_tensor_parallel.py), on the CPU: each rank a process, gloo
groups.

Every world (a backend and its ranks) is module-scoped and shared by the
tests that read it; its finalizer joins every rank. The group timeout is
short here, so no test can hang past it.

Tolerances: fp32 prefill logits within 1e-5 of the JAX program's (the
vocab shards' and the tp shards' matmuls sum in another order than the
whole ones), greedy ids equal.
"""

import os
import signal
import time

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
from distributed_llm_inference_tpu.runtime import create_backend as jax_backend  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import wire_quant as WQ  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import MeshError, build_mesh  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.pipeline import PipelineBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_backend, create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

LOGITS_ATOL = 1e-5
TIMEOUT_S = 10.0
N_NEW = 8

# name -> (model, config overrides, quant, mesh, pp_wire_quant)
WORLDS = {
    "pp2": ("test-llama-tiny", dict(n_layers=5, vocab_size=255), None, dict(pp=2), None),
    "pp4": ("test-llama-tiny", dict(n_layers=7, vocab_size=255), None, dict(pp=4), None),
    "tp2": ("test-llama-tiny", {}, None, dict(tp=2), None),
    "dp2": ("test-llama-tiny", {}, None, dict(dp=2), None),
    "pp2tp2": ("test-llama-tiny", dict(vocab_size=255), None, dict(pp=2, tp=2), None),
    "gpt2": ("test-gpt2-tiny", {}, None, dict(pp=2), None),
    "int4kv8": ("test-llama-tiny", dict(kv_quant="int8"), "int4", dict(pp=2), None),
    # dim 128: wo's input holds two 64-row scale groups, one per tp rank
    "tp2int4": ("test-llama-tiny", dict(dim=128, ffn_dim=256), "int4", dict(tp=2), None),
    "wire8": ("test-llama-tiny", {}, None, dict(pp=2), "int8"),
    "pp4wire8": ("test-llama-tiny", dict(n_layers=7), None, dict(pp=4), "int8"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class World:
    """One mesh shape: the JAX backend and the port's on the same weights."""

    def __init__(self, name):
        model, ov, quant, mesh, wire = WORLDS[name]
        self.jc = jax_cfg(model, dtype="float32", **ov)
        self.tc = get_model_config(model, dtype="float32", **ov)
        params = JM.init_params(self.jc, jax.random.PRNGKey(0))
        if quant:
            self.jc, self.tc = self.jc.replace(quant=quant), self.tc.replace(quant=quant)
            params = JQ.quantize_params(self.jc, params)
        self.params = params
        self.tparams = params_from_numpy(self.tc, _np(params), "cpu")
        self.mesh = mesh
        _, self.jb = jax_backend(self.jc, mesh_cfg=JaxMeshConfig(**mesh), params=params,
                                 wire_quant=wire)
        self.tb = PipelineBackend(self.tc, self.tparams, build_mesh(
            MeshConfig(**mesh), ["cpu"] * MeshConfig(**mesh).n_devices,
            timeout_s=TIMEOUT_S), wire_quant=wire)


@pytest.fixture(scope="module")
def worlds(request):
    made = {}

    def get(name):
        if name not in made:
            made[name] = World(name)
        return made[name]

    def close():
        for w in made.values():
            w.tb.close()

    request.addfinalizer(close)
    return get


def _prompts(cfg, B, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _jax_run(w, toks, n=N_NEW):
    sampling = JG.default_sampling(greedy=True)
    B, T = toks.shape
    cache = w.jb.init_cache(B, 64)
    first, logits, cache = w.jb.prefill(jnp.asarray(toks), jnp.int32(T), cache,
                                        jax.random.PRNGKey(0), sampling)
    out, n_gen, _ = w.jb.decode(first, cache, jnp.int32(T), jnp.int32(n - 1),
                                jax.random.PRNGKey(1), sampling, max_steps=n - 1)
    return np.asarray(first), np.asarray(logits), np.asarray(out), np.asarray(n_gen)


def _port_run(backend, toks, n=N_NEW, sampling=None, gens=(0, 1)):
    sampling = sampling or G.default_sampling(greedy=True)
    B, T = toks.shape
    cache = backend.init_cache(B, 64)
    first, logits, cache = backend.prefill(
        torch.from_numpy(toks).long(), T, cache, torch.Generator().manual_seed(gens[0]),
        sampling)
    out, n_gen, _ = backend.decode(first, cache, T, n - 1,
                                   torch.Generator().manual_seed(gens[1]), sampling,
                                   max_steps=n - 1)
    return first.numpy(), logits.numpy(), out.numpy(), n_gen.numpy()


@pytest.mark.parametrize("name", ["pp2", "pp4", "tp2", "dp2", "pp2tp2", "gpt2", "int4kv8",
                                  "tp2int4"])
def test_prefill_logits_and_greedy_ids_equal_jax(worlds, name):
    """Prefill logits within LOGITS_ATOL and the greedy ids of prefill +
    decode equal to the JAX PipelineBackend's on the same mesh shape
    (pp2: 5 layers over 2 stages and vocab 255; pp4: 7 over 4; gpt2 and
    int4 weights with an int8 cache at pp = 2; int4 weights at tp = 2,
    wo and w_down cut on their scale groups)."""
    w = worlds(name)
    B = w.mesh.get("dp", 1) * 2
    toks = _prompts(w.tc, B)
    jf, jl, jo, jn = _jax_run(w, toks)
    tf, tl, to, tn = _port_run(w.tb, toks)
    np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tn, jn)


def test_pp_equals_the_single_device(worlds):
    """pp alone moves activations and shards the vocab ends: the greedy
    ids are the single device's, and so are the logits within the
    tolerance (the head's column shards)."""
    w = worlds("pp2")
    toks = _prompts(w.tc, 2, seed=3)
    cache = M.init_kv_cache(w.tc, 2, max_seq=64)
    samp = G.default_sampling(greedy=True)
    f1, l1, cache = G.prefill(w.tc, w.tparams, torch.from_numpy(toks).long(), 12, cache,
                              torch.Generator(), samp)
    o1, _, _ = G.decode(w.tc, w.tparams, f1, cache, 12, N_NEW - 1, torch.Generator(), samp,
                        max_steps=N_NEW - 1)
    tf, tl, to, _ = _port_run(w.tb, toks)
    np.testing.assert_allclose(tl, l1.numpy(), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(to, o1.numpy())


def test_extend_then_prefill_at_equals_whole_prefill(worlds):
    """Chunked prefill (extend, then the last chunk through prefill_at)
    lands the same first token and logits as one prefill."""
    w = worlds("pp2tp2")
    toks = torch.from_numpy(_prompts(w.tc, 1, T=16, seed=4)).long()
    samp = G.default_sampling(greedy=True)
    c1 = w.tb.init_cache(1, 64)
    f1, l1, _ = w.tb.prefill(toks, 16, c1, torch.Generator(), samp)
    c2 = w.tb.init_cache(1, 64)
    w.tb.extend(toks[:, :8], 0, c2)
    f2, l2, _ = w.tb.prefill_at(toks[:, 8:], 8, 8, c2, torch.Generator(), samp)
    assert int(f1[0]) == int(f2[0])
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("knob", ["top_k", "top_p", "min_p"])
def test_sampled_decode_held_filter_by_filter(worlds, knob):
    """A filter that keeps only the argmax samples the greedy ids on pp,
    tp and dp meshes alike (each dp index drawing from its own generator
    changes nothing once the filter leaves one candidate)."""
    kw = {"top_k": dict(top_k=1), "top_p": dict(top_p=1e-6), "min_p": dict(min_p=1.0)}[knob]
    samp = G.default_sampling(greedy=False, temperature=1.0, **kw)
    for name in ("pp2", "dp2"):
        w = worlds(name)
        toks = _prompts(w.tc, 2, seed=5)
        greedy = _port_run(w.tb, toks)
        sampled = _port_run(w.tb, toks, sampling=samp, gens=(7, 8))
        np.testing.assert_array_equal(sampled[0], greedy[0])
        np.testing.assert_array_equal(sampled[2], greedy[2])


def test_dp_indices_draw_from_their_own_generators(worlds):
    """Two identical rows on dp = 2 sample apart at temperature 1 (the JAX
    _dp_key's fold_in), and the run repeats itself for one seed."""
    w = worlds("dp2")
    toks = np.repeat(_prompts(w.tc, 1, seed=6), 2, axis=0)
    samp = G.default_sampling(greedy=False, temperature=1.0)
    a = _port_run(w.tb, toks, n=24, sampling=samp, gens=(3, 4))
    b = _port_run(w.tb, toks, n=24, sampling=samp, gens=(3, 4))
    np.testing.assert_array_equal(a[2], b[2])
    assert not np.array_equal(a[2][0], a[2][1])


@pytest.fixture(scope="module")
def wire_world(request):
    cfg = get_model_config("test-llama-tiny", dtype="float32")
    params = JM.init_params(jax_cfg("test-llama-tiny"), jax.random.PRNGKey(0))
    tparams = params_from_numpy(cfg, _np(params), "cpu")
    backends = {q: PipelineBackend(cfg, tparams, build_mesh(MeshConfig(pp=2), ["cpu"] * 2,
                                                            timeout_s=TIMEOUT_S),
                                   wire_quant=q)
                for q in (None, "int8")}
    request.addfinalizer(lambda: [b.close() for b in backends.values()])
    return cfg, tparams, backends


def _greedy_ids(backend, prompt, n=12):
    first, _, out, _ = _port_run(backend, np.asarray([prompt], np.int32), n=n)
    return [int(first[0])] + out[0, : n - 1].tolist()


def test_wire_quant_off_is_the_single_device_and_on_is_the_proxy(wire_world):
    """--pp-wire-quant: off, the mesh's greedy ids are the single device's
    (the proxy with no round trip); int8, they are proxy_stage_generate's,
    every hand-off one row-local round trip (JAX test_wire_quant.py
    :292-350)."""
    cfg, tparams, backends = wire_world
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(3, cfg.vocab_size, 12).tolist()
        assert _greedy_ids(backends[None], prompt) == \
            WQ.proxy_stage_generate(cfg, tparams, prompt, 12, 2, quant=False)
        assert _greedy_ids(backends["int8"], prompt) == \
            WQ.proxy_stage_generate(cfg, tparams, prompt, 12, 2, quant=True)


def test_wire_bytes_account_every_hop(wire_world):
    """One prefill of [1, T] and one decode step at pp = 2: stage 0 sends
    the [1, T, D] chunk and then the [1, 1, D] step to stage 1 (the
    "microstep" path), stage 1 broadcasts each [1, 1, D] window it
    unembeds ("broadcast"); int8 ships D bytes and a 4-byte scale per row."""
    cfg, _, backends = wire_world
    D, T = cfg.dim, 12
    toks = _prompts(cfg, 1, T=T, seed=9)
    for q, per_row in ((None, 4 * D), ("int8", D + 4)):
        b = backends[q]
        b.wire_bytes.clear()
        _port_run(b, toks, n=2)
        assert b.wire_bytes["microstep"] == (T + 1) * per_row
        assert b.wire_bytes["broadcast"] == 2 * per_row
    assert WQ.wire_bytes((1, T, D), 4, 1, quant=True) == T * (D + 4)


def test_health_lists_every_rank(worlds):
    w = worlds("pp2tp2")
    lines = w.tb.health()
    assert [ln["stage"] for ln in lines] == [0, 1]
    assert [[r["rank"] for r in ln["ranks"]] for ln in lines] == [[0, 1], [2, 3]]
    assert all(r["status"] == "online" for ln in lines for r in ln["ranks"])
    assert lines[0]["layers"] == [0, 1] and lines[1]["layers"] == [2, 3]
    assert len({r["pid"] for ln in lines for r in ln["ranks"]}) == 4


def test_killed_worker_raises_within_the_timeout_and_the_fleet_goes_unready():
    """SIGKILL one worker rank: the next program raises MeshError well
    within the group timeout, the fleet's supervisor gives up after its
    restart budget and reports not ready, health answers the killed rank's
    stage offline."""
    cfg = get_model_config("test-llama-tiny", dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    mesh = build_mesh(MeshConfig(pp=2), ["cpu", "cpu"], timeout_s=TIMEOUT_S)
    backend = PipelineBackend(cfg, params, mesh)
    eng = InferenceEngine(cfg, backend=backend, tokenizer=ByteTokenizer(),
                          engine_cfg=EngineConfig(prefix_cache_entries=0))
    fleet = ContinuousEngine(eng, n_slots=2, chunk_steps=4, kv_pool_blocks=40,
                             kv_block_size=8, slot_max_seq=128, restart_budget=1,
                             restart_backoff_s=0.01)
    try:
        ok = fleet.submit("hello there", max_tokens=4, greedy=True, chat=False)
        assert ok["status"] == "success", ok
        os.kill(mesh.procs[0].pid, signal.SIGKILL)
        mesh.procs[0].join(5)
        t0 = time.monotonic()
        with pytest.raises(MeshError):
            backend.extend(torch.ones((1, 4), dtype=torch.long), 0, backend.init_cache(1, 16))
        assert time.monotonic() - t0 < TIMEOUT_S
        bad = fleet.submit("hello again", max_tokens=4, greedy=True, chat=False)
        assert bad["status"] != "success"
        deadline = time.monotonic() + TIMEOUT_S
        while fleet.ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not fleet.ready
        # the driver's own rank lives on; the killed rank's stage is offline
        assert [ln["status"] for ln in backend.health()] == ["online", "offline"]
    finally:
        fleet.close()
        backend.close()
    assert not any(p.is_alive() for p in mesh.procs)


def test_create_engine_builds_each_mesh_on_the_cpu():
    """create_engine over pp, tp and pp x tp meshes (dp > 1 refused as the
    JAX engine refuses it), asked for the CPU."""
    for mesh in (MeshConfig(pp=2), MeshConfig(tp=2)):
        eng = create_engine("test-llama-tiny", mesh_cfg=mesh, device="cpu",
                            tokenizer=ByteTokenizer(),
                            engine_cfg=EngineConfig(prefix_cache_entries=0))
        try:
            assert eng.backend.name == "pipeline" and eng.device == torch.device("cpu")
            out = eng.generate("abc", max_tokens=3, greedy=True, chat=False)
            assert out["status"] == "success" and out["tokens_generated"] >= 1
        finally:
            eng.backend.close()
    with pytest.raises(NotImplementedError, match="dp>1"):
        create_engine("test-llama-tiny", mesh_cfg=MeshConfig(dp=2), device="cpu")
    cfg, be = create_backend("test-llama-tiny", mesh_cfg=MeshConfig(dp=2), device="cpu")
    be.close()
    # an sp mesh selects the context-parallel backend (part B)
    cfg, be = create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=2), device="cpu")
    try:
        assert be.name == "context-parallel" and be.sp == 2
    finally:
        be.close()



@pytest.mark.parametrize("name", ["wire8", "pp4wire8"])
def test_int8_wire_equals_jax(worlds, name):
    """--pp-wire-quant int8 on both packages' backends (pp = 2, and 7 layers
    over pp = 4): every stage hand-off, the last stage's hop home and the
    broadcast round-trip the same rows, so the prefill logits agree within
    LOGITS_ATOL (far under one int8 step of the wire) and the greedy ids of
    24 tokens are equal. The port's hand-offs shipped int8 rows."""
    w = worlds(name)
    toks = _prompts(w.tc, 2)
    w.tb.wire_bytes.clear()
    jf, jl, jo, jn = _jax_run(w, toks, n=24)
    tf, tl, to, tn = _port_run(w.tb, toks, n=24)
    np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tn, jn)
    assert w.tb.wire_bytes["microstep"] % (w.tc.dim + 4) == 0
    assert w.tb.wire_bytes["microstep"] % (4 * w.tc.dim) != 0
