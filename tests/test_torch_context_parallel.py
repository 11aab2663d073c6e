"""The port's context-parallel backend (parallel/context.py) against the JAX
package's ContextParallelBackend on the same mesh shape and the same
weights (the counterparts of tests/test_context_parallel.py), on the CPU:
each rank a process, gloo groups.

Every world (a JAX backend and the port's on bridged weights) is
module-scoped and shared; its finalizer joins every rank. The serving
cases hold the port's engine on an sp mesh to the JAX single device's
engine on the same weights.

Tolerances: fp32 prefill logits within 1e-5 of the JAX program's (the
ring's online softmax merges its chunks in the same order; the einsums and
the vocab shards sum in another order), greedy ids equal.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu import MeshConfig as JaxMeshConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.runtime import create_backend as jax_backend  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.context import ContextParallelBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_backend  # noqa: E402

LOGITS_ATOL = 1e-5
TIMEOUT_S = 10.0
BUCKET, STEPS = 16, 8

LLAMA = ("test-llama-tiny", dict(n_layers=4, vocab_size=255))
# the engines' worlds: the byte tokenizer's ids need the whole vocab, and
# no stop token ends a greedy run early
SERVED = ("test-llama-tiny", dict(n_layers=4, eos_token_id=-1))
# name -> (model, config overrides, mesh, sp_strategy, pp_wire_quant)
WORLDS = {
    "sp2": (*SERVED, dict(sp=2), "ring", None),
    "sp4": (*LLAMA, dict(sp=4), "ring", None),
    "ul4": ("test-llama-tiny", dict(n_layers=2, n_heads=8, n_kv_heads=4), dict(sp=4),
            "ulysses", None),
    "sp2pp2": (*LLAMA, dict(sp=2, pp=2), "ring", None),
    "ul2pp2": (*SERVED, dict(sp=2, pp=2), "ulysses", None),
    "sp2pp2tp2": (*LLAMA, dict(sp=2, pp=2, tp=2), "ring", None),
    "gpt2": ("test-gpt2-tiny", dict(n_layers=2), dict(sp=2), "ring", None),
    "kv8pp2": ("test-llama-tiny", dict(n_layers=4, kv_quant="int8"), dict(sp=2, pp=2),
               "ring", None),
    "wire8": (*LLAMA, dict(sp=2, pp=2), "ring", "int8"),
    "gemma2": ("test-gemma2-tiny", dict(n_layers=4, attn_window=5), dict(sp=2), "ring", None),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class World:
    """One mesh shape: the JAX context backend and the port's on the same
    weights."""

    def __init__(self, name):
        model, ov, mesh, strategy, wire = WORLDS[name]
        self.jc = jax_cfg(model, dtype="float32", **ov)
        self.tc = get_model_config(model, dtype="float32", **ov)
        self.params = JM.init_params(self.jc, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(self.tc, _np(self.params), "cpu")
        self.mesh = mesh
        _, self.jb = jax_backend(self.jc, mesh_cfg=JaxMeshConfig(**mesh), params=self.params,
                                 sp_strategy=strategy, wire_quant=wire)
        n = MeshConfig(**mesh).n_devices
        self.tb = ContextParallelBackend(
            self.tc, self.tparams, build_mesh(MeshConfig(**mesh), ["cpu"] * n,
                                              timeout_s=TIMEOUT_S),
            sp_strategy=strategy, wire_quant=wire)


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


def _prompts(cfg, B, plen, bucket=BUCKET, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, min(cfg.vocab_size, 250), size=(B, plen))
    if not ragged:
        toks = np.pad(rows, ((0, 0), (0, bucket - plen)), constant_values=cfg.pad_token_id)
        return toks.astype(np.int32), None
    lens = [plen - 3 * i for i in range(B)]
    toks = np.full((B, bucket), cfg.pad_token_id, np.int32)
    for i, n in enumerate(lens):
        toks[i, bucket - n:] = rows[i, :n]
    return toks, np.asarray([bucket - n for n in lens], np.int32)


def _jax_run(b, toks, plen, vs=None, steps=STEPS, max_seq=64):
    s = JG.default_sampling(greedy=True)
    cache = b.init_cache(toks.shape[0], max_seq)
    kw = {} if vs is None else {"valid_start": jnp.asarray(vs)}
    f, lg, cache = b.prefill(jnp.asarray(toks), jnp.int32(plen), cache, jax.random.PRNGKey(0),
                             s, **kw)
    o, n, _ = b.decode(f, cache, jnp.int32(plen), jnp.int32(steps), jax.random.PRNGKey(1), s,
                       max_steps=steps, **kw)
    return np.asarray(f), np.asarray(lg), np.asarray(o), np.asarray(n)


def _port_run(b, toks, plen, vs=None, steps=STEPS, max_seq=64):
    s = G.default_sampling(greedy=True)
    cache = b.init_cache(toks.shape[0], max_seq)
    vst = None if vs is None else torch.from_numpy(vs)
    f, lg, cache = b.prefill(torch.from_numpy(toks).long(), plen, cache, torch.Generator(), s,
                             vst)
    o, n, _ = b.decode(f, cache, plen, steps, torch.Generator(), s, vst, max_steps=steps)
    return f.numpy(), lg.numpy(), o.numpy(), n.numpy()


def _assert_equal_runs(got, want):
    np.testing.assert_allclose(got[1], want[1], atol=LOGITS_ATOL, rtol=0)
    for g, x in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(g, x)


def _same(w, plen, B=2, seed=0, vs_ragged=False, steps=STEPS):
    toks, vs = _prompts(w.tc, B * w.mesh.get("dp", 1), plen, seed=seed, ragged=vs_ragged)
    p = BUCKET if vs_ragged else plen
    _assert_equal_runs(_port_run(w.tb, toks, p, vs, steps), _jax_run(w.jb, toks, p, vs, steps))


@pytest.mark.parametrize("name,plen", [("sp4", 9), ("sp4", 16), ("sp2", 13)])
def test_cp_backend_matches_jax(worlds, name, plen):
    """Ring prefill and the context-sharded decode at sp 2 and 4, the last
    prompt position on each ring member in turn, against the JAX program."""
    _same(worlds(name), plen)


@pytest.mark.parametrize("name,plen", [("ul2pp2", 13), ("ul4", 9)])
def test_ulysses_matches_jax(worlds, name, plen):
    """Ulysses at sp 2 (under pp 2) and sp 4 (8 heads, 4 kv heads)."""
    _same(worlds(name), plen, seed=1)


def test_gpt2_sp_matches_jax(worlds):
    """gpt2's learned absolute positions at the chunk offsets."""
    _same(worlds("gpt2"), 11, seed=2)


@pytest.mark.parametrize("name", ["sp2pp2", "sp2pp2tp2"])
def test_sp_pp_matches_jax(worlds, name):
    """sp x pp (ring and Ulysses) and sp x pp x tp (eight ranks): each
    stage's layers run the ring collectives on its chunk."""
    _same(worlds(name), 13, seed=3)


def test_sp_pp_kv_quant_and_ragged(worlds):
    """An int8 cache on sp 2 x pp 2: the quantized chunks and their scales
    rotate, the decode merges dequantized partials. With left-padded rows
    too: there the JAX context backend's prefill logits part from its own
    single device's by ~2.4e-4 (ROADMAP Queue 3), so the port's logits are
    held to the JAX single device's and its ids to both."""
    w = worlds("kv8pp2")
    _same(w, 13, seed=4)
    toks, vs = _prompts(w.tc, 2, 14, seed=5, ragged=True)
    got = _port_run(w.tb, toks, BUCKET, vs)
    cp = _jax_run(w.jb, toks, BUCKET, vs)
    s = JG.default_sampling(greedy=True)
    cache = JM.init_kv_cache(w.jc, 2, max_seq=64)
    f, lg, cache = JG.prefill(w.jc, w.params, jnp.asarray(toks), jnp.int32(BUCKET), cache,
                              jax.random.PRNGKey(0), s, valid_start=jnp.asarray(vs))
    o, n, _ = JG.decode(w.jc, w.params, f, cache, jnp.int32(BUCKET), jnp.int32(STEPS),
                        jax.random.PRNGKey(1), s, valid_start=jnp.asarray(vs),
                        max_steps=STEPS)
    _assert_equal_runs(got, tuple(np.asarray(t) for t in (f, lg, o, n)))
    for g, x in zip(got[:1] + got[2:], cp[:1] + cp[2:]):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", ["sp4", "ul2pp2"])
def test_sp_ragged_batch_matches_jax(worlds, name):
    """Left-padded rows: valid_start rides the ring / Ulysses and merge
    masks on absolute positions."""
    _same(worlds(name), 15, seed=6, vs_ragged=True)


def test_int8_wire_equals_jax(worlds):
    """pp_wire_quant int8 on sp 2 x pp 2: the K/V chunks rotate as int8
    rows and scales, the stage hand-offs and the sampled window's
    broadcast round-trip as in the JAX program."""
    w = worlds("wire8")
    w.tb.wire_bytes.clear()
    _same(w, 13, seed=7)
    assert w.tb.wire_bytes["sp"] > 0 and w.tb.wire_bytes["microstep"] > 0


def test_sp_per_layer_window_pattern_matches_jax(worlds):
    """Gemma-2's even-layer window pattern: each layer's window reaches the
    ring and merge masks, windows binding (5 < the prompt)."""
    _same(worlds("gemma2"), 14, seed=8)


def test_cp_backend_eos_early_exit(worlds):
    """An EOS mid-stream truncates row 0 on both packages alike."""
    w = worlds("sp2")
    toks, _ = _prompts(w.tc, 2, 10, seed=9)
    eos = int(_jax_run(w.jb, toks, 10)[2][0, 3])
    jc, tc = w.jc.replace(eos_token_id=eos), w.tc.replace(eos_token_id=eos)
    _, jb = jax_backend(jc, mesh_cfg=JaxMeshConfig(sp=2), params=w.params)
    tb = ContextParallelBackend(tc, w.tparams, build_mesh(MeshConfig(sp=2), ["cpu"] * 2,
                                                          timeout_s=TIMEOUT_S))
    try:
        got, want = _port_run(tb, toks, 10), _jax_run(jb, toks, 10)
    finally:
        tb.close()
    assert want[3][0] < STEPS
    _assert_equal_runs(got, want)


def test_cp_prefill_heavy_shard_does_not_overflow(worlds):
    """A prompt that fills rank 0's chunk whole, then decode to max_seq:
    the least-filled placement fits every token in ceil(max_seq/sp) + 1
    slots per rank, as the JAX backend does."""
    w = worlds("sp2")
    max_seq = 32
    assert w.tb.local_slots(max_seq) == 17
    toks, _ = _prompts(w.tc, 1, 16, bucket=32, seed=10)
    steps = max_seq - 16
    got = _port_run(w.tb, toks, 16, steps=steps, max_seq=max_seq)
    want = _jax_run(w.jb, toks, 16, steps=steps, max_seq=max_seq)
    _assert_equal_runs(got, want)
    assert int(got[3][0]) == steps


def test_cp_backend_rejects_like_jax():
    """Every refusal of the JAX constructor and runtime, in its words: a
    trivial ring, a bucket sp does not divide, Ulysses over heads sp does
    not divide (tp-aware), uneven layers over sp x pp, sp with
    microbatches or ep, --sp-strategy without sp, an arch without the
    hook seam."""
    with pytest.raises(ValueError, match="needs sp >= 2"):
        ContextParallelBackend(get_model_config("test-llama-tiny"), None,
                               type("M", (), {"cfg": MeshConfig(pp=2)})())
    with pytest.raises(ValueError, match="LOCAL head counts"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=4), sp_strategy="ulysses",
                       device="cpu")
    with pytest.raises(ValueError, match="LOCAL head counts"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=2, tp=2),
                       sp_strategy="ulysses", device="cpu")
    with pytest.raises(NotImplementedError, match="sp x pp needs n_layers"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=2, pp=3), device="cpu")
    with pytest.raises(ValueError, match="does not compose with microbatching/ep"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=2, pp=2), microbatches=2,
                       device="cpu")
    with pytest.raises(ValueError, match="needs a context-parallel mesh"):
        create_backend("test-llama-tiny", sp_strategy="ulysses", device="cpu")
    with pytest.raises(ValueError, match="sp_strategy must be"):
        ContextParallelBackend(get_model_config("test-llama-tiny"), None,
                               type("M", (), {"cfg": MeshConfig(sp=2)})(), sp_strategy="x")
    with pytest.raises(NotImplementedError, match="attn_hook seam"):
        ContextParallelBackend(get_model_config("test-llama-tiny").replace(arch="bert"), None,
                               type("M", (), {"cfg": MeshConfig(sp=2)})())


def test_cp_bad_bucket_and_adapters_refused(worlds):
    w = worlds("sp4")
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        w.tb.prefill(torch.zeros((1, 10), dtype=torch.long), 5, w.tb.init_cache(1, 32),
                     torch.Generator(), G.default_sampling(greedy=True))
    with pytest.raises(ValueError, match="adapter_slots"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(sp=2), adapter_slots=2,
                       device="cpu")


@pytest.mark.parametrize("name", ["sp2", "gpt2"])
def test_sp_score_matches_jax(worlds, name):
    """Echo scoring on the ring: the gathered teacher-forced log-probs and
    the top-N alternatives equal the JAX backend's; sp x pp and a running
    offset refuse in its words."""
    w = worlds(name)
    toks, _ = _prompts(w.tc, 1, 16, seed=11)
    got = w.tb.score_chunk(torch.from_numpy(toks).long(), 0, w.tb.init_cache(1, 32), top_n=2)
    want = w.jb.score_chunk(jnp.asarray(toks), 0, w.jb.init_cache(1, 32), top_n=2)
    for g, x in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=LOGITS_ATOL, rtol=0)
    with pytest.raises(ValueError, match="single-bucket prompts only"):
        w.tb.score_chunk(torch.from_numpy(toks).long(), 16, w.tb.init_cache(1, 32))
    assert worlds("sp2pp2").tb.supports_score is False
    with pytest.raises(NotImplementedError, match="sp x pp meshes"):
        worlds("sp2pp2").tb.score_chunk(torch.from_numpy(toks).long(), 0, None)


def test_cp_health_lists_context_shards(worlds):
    """/workers: the context shards on an sp mesh, the stages (each its
    ring members) on sp x pp."""
    lines = worlds("sp4").tb.health()
    assert [ln["stage"] for ln in lines] == [0, 1, 2, 3]
    assert {ln["role"] for ln in lines} == {"context-shard"}
    lines = worlds("sp2pp2").tb.health()
    assert [len(ln["ranks"]) for ln in lines] == [2, 2]
    assert {ln["role"] for ln in lines} == {"pipeline-stage+context-ring"}


# -- through the engine --------------------------------------------------------------

_PARAMS = {}  # the engines' worlds' bridged weights, by config name


def _world_params(engine):
    return _PARAMS[engine.cfg.name]



@pytest.fixture(scope="module")
def engines(worlds):
    """The JAX single device's engine, and the port's engines on the sp 2
    and the sp 2 x pp 2 (Ulysses) worlds' backends, on the same weights."""
    from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine

    sp, sppp = worlds("sp2"), worlds("ul2pp2")
    _PARAMS[sp.tc.name] = sp.tparams
    sd = JaxEngine(sp.jc, params=sp.params, engine_cfg=JaxEngineConfig(prefill_buckets=(32, 64)))
    ecfg = EngineConfig(prefill_buckets=(32, 64), prefix_cache_entries=0)
    return sd, *(InferenceEngine(w.tc, backend=w.tb, engine_cfg=ecfg)
                 for w in (sp, sppp))


def test_cp_serving_engine(engines):
    """The solo engine on sp 2 and on sp 2 x pp 2: the JAX single device's
    responses."""
    sd, sp, sppp = engines
    assert sp.backend.name == sppp.backend.name == "context-parallel"
    for prompt in ("the quick brown fox jumps over a dog", "hello there"):
        a = sd.generate(prompt, max_tokens=10, greedy=True, chat=False)
        for eng in (sp, sppp):
            b = eng.generate(prompt, max_tokens=10, greedy=True, chat=False)
            assert a["status"] == b["status"] == "success", b
            assert a["response"] == b["response"]


def test_sp_full_solo_surface_matches_the_single_device(engines):
    """The repetition penalty, the OpenAI penalties, logit_bias and
    log-probabilities on the sp ring: the tokens of the port's single
    device engine on the same weights (whose variants
    tests/test_torch_engine.py and friends hold to the JAX engine's)."""
    from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine

    _, sp, _ = engines
    sd = InferenceEngine(sp.cfg, params=_world_params(sp), device="cpu",
                         engine_cfg=sp.engine_cfg)
    prompt = "the quick brown fox"
    for kw in (dict(repetition_penalty=1.3),
               dict(frequency_penalty=1.0, presence_penalty=0.3),
               dict(logit_bias={"17": 100.0}), dict(logprobs=True),
               dict(repetition_penalty=1.2, logit_bias={"55": 2.5})):
        a = sd.generate(prompt, max_tokens=6, greedy=True, chat=False, **kw)
        b = sp.generate(prompt, max_tokens=6, greedy=True, chat=False, **kw)
        assert a["status"] == b["status"] == "success", (kw, b)
        assert a["response"] == b["response"], kw
        if "logprobs" in kw:
            np.testing.assert_allclose(a["token_logprobs"], b["token_logprobs"], atol=1e-5)


def test_sp_generate_batch_matches_jax(engines):
    """A left-padded batch of 3 on the ring: the JAX single device's
    batch."""
    sd, sp, _ = engines
    prompts = ["the quick brown fox", "hi", "a much longer prompt than the others here"]
    a = sd.generate_batch(prompts, max_tokens=6, greedy=True, chat=False)
    b = sp.generate_batch(prompts, max_tokens=6, greedy=True, chat=False)
    assert a["status"] == b["status"] == "success", b
    assert [r["response"] for r in a["results"]] == [r["response"] for r in b["results"]]


def test_sp_continuous_refused_as_jax(engines):
    """The continuous fleet refuses the context ring in the JAX fleet's
    words (no slot programs)."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    _, sp, _ = engines
    with pytest.raises(ValueError, match="continuous batching runs on the single-device "
                                         "backend or a pp pipeline mesh with dp == 1"):
        ContinuousEngine(sp, n_slots=2)
