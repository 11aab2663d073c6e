"""The port's 1F1B microbatched pipeline (parallel/schedule.py) against the
JAX package's MicrobatchPipelineBackend on the same mesh shape and the same
weights (the counterparts of tests/test_schedule.py and
tests/test_1f1b_serving.py), on the CPU: each rank a process, gloo groups.

Every world (a JAX backend and the port's on bridged weights) is
module-scoped and shared; its finalizer joins every rank.

Tolerances: fp32 prefill logits within 1e-5 of the JAX program's (the
vocab shards' matmuls sum in another order than the whole head's), greedy
ids equal.
"""

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu import MeshConfig as JaxMeshConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.parallel.mesh import build_mesh as jax_mesh  # noqa: E402
from distributed_llm_inference_tpu.parallel.schedule import (  # noqa: E402
    MicrobatchPipelineBackend as JaxMicrobatch,
)
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import batch_buckets_for  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import wire_quant as WQ  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.schedule import (  # noqa: E402
    MicrobatchPipelineBackend,
)
from distributed_llm_inference_tpu_torch.runtime import create_backend, create_engine  # noqa: E402

LOGITS_ATOL = 1e-5
TIMEOUT_S = 10.0
PLEN, BUCKET, STEPS = 9, 16, 6

# name -> (model, config overrides, mesh, microbatches, pp_wire_quant)
WORLDS = {
    "pp2m2": ("test-llama-tiny", dict(n_layers=5, vocab_size=255), dict(pp=2), 2, None),
    "pp4m4": ("test-llama-tiny", dict(n_layers=7, vocab_size=255), dict(pp=4), 4, None),
    "pp2m4": ("test-llama-tiny", dict(vocab_size=255), dict(pp=2), 4, None),
    "full": ("test-llama-tiny", dict(vocab_size=255), dict(dp=2, pp=2, tp=2), 2, None),
    "gpt2": ("test-gpt2-tiny", {}, dict(pp=2), 2, None),
    "wire8": ("test-llama-tiny", {}, dict(pp=2), 2, "int8"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class World:
    """One mesh shape: the JAX 1F1B backend and the port's on the same
    weights, both returning their prefill logits."""

    def __init__(self, name):
        model, ov, mesh, mb, wire = WORLDS[name]
        self.jc = jax_cfg(model, dtype="float32", **ov)
        self.tc = get_model_config(model, dtype="float32", **ov)
        self.params = JM.init_params(self.jc, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(self.tc, _np(self.params), "cpu")
        self.mesh, self.mb = mesh, mb
        self.gran = mesh.get("dp", 1) * mb
        self.jb = JaxMicrobatch(self.jc, self.params, jax_mesh(JaxMeshConfig(**mesh), jax.devices()),
                                n_microbatches=mb, return_prefill_logits=True,
                                wire_quant=wire)
        n = MeshConfig(**mesh).n_devices
        self.tb = MicrobatchPipelineBackend(
            self.tc, self.tparams, build_mesh(MeshConfig(**mesh), ["cpu"] * n,
                                              timeout_s=TIMEOUT_S),
            n_microbatches=mb, return_prefill_logits=True, wire_quant=wire)


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


def _prompts(cfg, B, plen=PLEN, bucket=BUCKET, seed=0, ragged=False):
    """[B, bucket] prompts (right-padded; LEFT-padded to ragged lengths
    with their valid_start when ragged)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, min(cfg.vocab_size, 250), size=(B, plen))
    if not ragged:
        toks = np.pad(rows, ((0, 0), (0, bucket - plen)), constant_values=cfg.pad_token_id)
        return toks.astype(np.int32), None
    lens = [plen - (i % 3) for i in range(B)]
    toks = np.full((B, bucket), cfg.pad_token_id, np.int32)
    for i, n in enumerate(lens):
        toks[i, bucket - n:] = rows[i, :n]
    return toks, np.asarray([bucket - n for n in lens], np.int32)


def _jax_run(w, toks, vs, plen, steps=STEPS, eos_cfg=None):
    b = w.jb
    s = JG.default_sampling(greedy=True)
    cache = b.init_cache(toks.shape[0], 64)
    kw = {} if vs is None else {"valid_start": jnp.asarray(vs)}
    f, lg, cache = b.prefill(jnp.asarray(toks), jnp.int32(plen), cache, jax.random.PRNGKey(0),
                             s, **kw)
    o, n, _ = b.decode(f, cache, jnp.int32(plen), jnp.int32(steps), jax.random.PRNGKey(1), s,
                       max_steps=steps, **kw)
    return np.asarray(f), np.asarray(lg), np.asarray(o), np.asarray(n)


def _port_run(b, toks, vs, plen, steps=STEPS, sampling=None, gens=(0, 1)):
    s = sampling or G.default_sampling(greedy=True)
    cache = b.init_cache(toks.shape[0], 64)
    vst = None if vs is None else torch.from_numpy(vs)
    f, lg, cache = b.prefill(torch.from_numpy(toks).long(), plen, cache,
                             torch.Generator().manual_seed(gens[0]), s, vst)
    o, n, _ = b.decode(f, cache, plen, steps, torch.Generator().manual_seed(gens[1]), s, vst,
                       max_steps=steps)
    return f.numpy(), lg.numpy(), o.numpy(), n.numpy()


def _assert_equal_runs(got, want):
    np.testing.assert_allclose(got[1], want[1], atol=LOGITS_ATOL, rtol=0)
    for g, x in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", ["pp2m2", "pp4m4", "pp2m4"])
def test_microbatch_prefill_and_decode_equal_jax(worlds, name):
    """Prefill logits within LOGITS_ATOL, first tokens and greedy decode
    ids equal to the JAX 1F1B program's (5 layers over pp 2 with M 2, 7
    over pp 4 with M 4, M 4 > pp 2)."""
    w = worlds(name)
    toks, _ = _prompts(w.tc, 2 * w.gran)
    _assert_equal_runs(_port_run(w.tb, toks, None, PLEN), _jax_run(w, toks, None, PLEN))


@pytest.mark.parametrize("name", ["pp2m2", "gpt2"])
def test_microbatch_decode_ragged_and_gpt2_equal_jax(worlds, name):
    """A left-padded fleet (ragged valid_start per microbatch) on llama,
    and gpt2's right-padded fleet, against the JAX program."""
    w = worlds(name)
    ragged = w.tc.arch == "llama"
    toks, vs = _prompts(w.tc, 2 * w.gran, seed=2, ragged=ragged)
    plen = BUCKET if ragged else PLEN
    _assert_equal_runs(_port_run(w.tb, toks, vs, plen), _jax_run(w, toks, vs, plen))


def test_microbatch_full_mesh_dp_pp_tp(worlds):
    """dp 2 x pp 2 x tp 2 with M 2 (eight ranks): rows grouped [dp][mb]
    [rows], each dp index its own ring and generator."""
    w = worlds("full")
    toks, _ = _prompts(w.tc, w.gran, seed=3)
    _assert_equal_runs(_port_run(w.tb, toks, None, PLEN), _jax_run(w, toks, None, PLEN))


def test_microbatch_eos_early_exit(worlds):
    """Per-row EOS and per-microbatch done gating: the token greedy decode
    emits mid-stream becomes the EOS id, and the port's 1F1B schedule
    truncates every row as the JAX single device does."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 4, plen=6, seed=6)
    s = JG.default_sampling(greedy=True)
    jc = w.jc.replace(eos_token_id=-1)
    cache = JM.init_kv_cache(jc, 4, max_seq=64)
    f, _, cache = JG.prefill(jc, w.params, jnp.asarray(toks), jnp.int32(6), cache,
                             jax.random.PRNGKey(0), s)
    out, _, _ = JG.decode(jc, w.params, f, cache, jnp.int32(6), jnp.int32(8),
                          jax.random.PRNGKey(1), s, max_steps=8)
    eos = int(np.asarray(out)[0, 3])
    jc = w.jc.replace(eos_token_id=eos)
    cache = JM.init_kv_cache(jc, 4, max_seq=64)
    f, _, cache = JG.prefill(jc, w.params, jnp.asarray(toks), jnp.int32(6), cache,
                             jax.random.PRNGKey(0), s)
    jo, jn, _ = JG.decode(jc, w.params, f, cache, jnp.int32(6), jnp.int32(8),
                          jax.random.PRNGKey(1), s, max_steps=8)
    b = MicrobatchPipelineBackend(
        w.tc.replace(eos_token_id=eos), w.tparams,
        build_mesh(MeshConfig(pp=2), ["cpu"] * 2, timeout_s=TIMEOUT_S))
    try:
        _, _, to, tn = _port_run(b, toks, None, 6, steps=8)
    finally:
        b.close()
    assert int(np.asarray(jn)[0]) < 8  # EOS truncated row 0
    np.testing.assert_array_equal(to, np.asarray(jo))
    np.testing.assert_array_equal(tn, np.asarray(jn))


def test_create_backend_selects_schedule(engines):
    """create_backend (through create_engine): microbatches > 1 on pp >= 2
    builds the 1F1B backend, M = 1 the plain pipeline; microbatches > 1
    without a pipeline, on gpt2, M < pp and adapters are refused in the
    JAX package's words."""
    _, plain, f1b = engines
    be = f1b.backend
    assert be.name == "pipeline-1f1b" and be.n_microbatches == 2
    assert be.batch_granularity == 2 and plain.backend.name == "pipeline"
    assert [ln["microbatches"] for ln in be.health()] == [2, 2]
    with pytest.raises(ValueError, match="needs a pipeline"):
        create_backend("test-llama-tiny", microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ragged llama-family fleets only"):
        create_backend("test-gpt2-tiny", mesh_cfg=MeshConfig(pp=2), microbatches=2,
                       device="cpu")
    with pytest.raises(ValueError, match="must be >= pp"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(pp=4), microbatches=3,
                       device="cpu")
    with pytest.raises(ValueError, match="adapter_slots"):
        create_backend("test-llama-tiny", mesh_cfg=MeshConfig(pp=2), microbatches=2,
                       adapter_slots=2, device="cpu")


def test_non_fleet_batch_serves_via_plain_ring(worlds):
    """3 rows on M = 2 (no multiple of the granularity) run the inherited
    plain-ring programs: the JAX single device's ids, and no byte on the
    1f1b path."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 3, plen=7, seed=8)
    s = JG.default_sampling(greedy=True)
    cache = JM.init_kv_cache(w.jc, 3, max_seq=64)
    f, lg, cache = JG.prefill(w.jc, w.params, jnp.asarray(toks), jnp.int32(7), cache,
                              jax.random.PRNGKey(0), s)
    o, n, _ = JG.decode(w.jc, w.params, f, cache, jnp.int32(7), jnp.int32(STEPS),
                        jax.random.PRNGKey(1), s, max_steps=STEPS)
    w.tb.wire_bytes.clear()
    got = _port_run(w.tb, toks, None, 7)
    assert "1f1b" not in w.tb.wire_bytes and w.tb.wire_bytes["microstep"] > 0
    _assert_equal_runs(got, tuple(np.asarray(t) for t in (f, lg, o, n)))


def test_microbatch_prefill_default_skips_logits(worlds):
    """The serving default: zero-width prefill logits, the same first
    tokens."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 4)
    s = G.default_sampling(greedy=True)
    w.tb.return_prefill_logits = False
    try:
        f, lg, _ = w.tb.prefill(torch.from_numpy(toks).long(), PLEN, w.tb.init_cache(4, 64),
                                torch.Generator(), s)
    finally:
        w.tb.return_prefill_logits = True
    assert tuple(lg.shape) == (4, 0)
    np.testing.assert_array_equal(f.numpy(), _jax_run(w, toks, None, PLEN)[0])


def test_int8_wire_equals_jax(worlds):
    """pp_wire_quant int8: every shift and every sample event's broadcast
    ships int8 rows and fp32 scales, as the JAX ring does, so the logits
    agree within LOGITS_ATOL and the ids are equal; the 1f1b path's bytes
    are int8 rows plus a 4-byte scale each."""
    w = worlds("wire8")
    toks, _ = _prompts(w.tc, 4, seed=4)
    w.tb.wire_bytes.clear()
    _assert_equal_runs(_port_run(w.tb, toks, None, PLEN), _jax_run(w, toks, None, PLEN))
    D = w.tc.dim
    assert w.tb.wire_bytes["1f1b"] % (D + 4) == 0
    assert w.tb.wire_bytes["1f1b"] % (4 * D) != 0


def test_wire_bytes_count_each_shift(worlds):
    """With no row finished early, a decode of `steps` tokens ships each
    microbatch's [b_m, 1, D] window once over each of the S links per token
    (the gated-off warm-up and drain hops are skipped, where the JAX link
    table counts S - 1 + steps x M per link), and one broadcast per sample
    event; the prefill ships each microbatch's [b_m, T, D] chunk over the S
    links."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 4, seed=5)
    b_m, S, M, D = 2, 2, 2, w.tc.dim
    w.tb.wire_bytes.clear()
    s = G.default_sampling(greedy=True)
    cache = w.tb.init_cache(4, 64)
    f, _, cache = w.tb.prefill(torch.from_numpy(toks).long(), PLEN, cache, torch.Generator(), s)
    assert w.tb.wire_bytes["1f1b"] == M * S * WQ.wire_bytes((b_m, BUCKET, D), 4, 1, quant=False)
    assert w.tb.wire_bytes["broadcast"] == M * b_m * D * 4
    w.tb.wire_bytes.clear()
    cfg = w.tb.cfg
    o, n, _ = w.tb.decode(f, cache, PLEN, 3, torch.Generator(), s, max_steps=3)
    if int(n.min()) == 3 and not any(t in cfg.all_stop_ids for t in f.tolist()):
        assert w.tb.wire_bytes["1f1b"] == 3 * M * S * b_m * D * 4
        assert w.tb.wire_bytes["broadcast"] == 3 * M * b_m * D * 4


def test_sampled_fleet_streams_are_reproducible(worlds):
    """A sampled fleet draws from one stream per (microbatch, emit index):
    the same generator seed gives the same ids; a filter that keeps only
    the argmax gives the greedy ids."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 4, seed=9)
    samp = G.default_sampling(greedy=False, temperature=1.0, top_k=0, top_p=1.0)
    a = _port_run(w.tb, toks, None, PLEN, sampling=samp, gens=(3, 4))
    b = _port_run(w.tb, toks, None, PLEN, sampling=samp, gens=(3, 4))
    np.testing.assert_array_equal(a[2], b[2])
    one = G.default_sampling(greedy=False, temperature=1.0, top_k=1)
    np.testing.assert_array_equal(_port_run(w.tb, toks, None, PLEN, sampling=one)[2],
                                  _port_run(w.tb, toks, None, PLEN)[2])


def test_profile_reports_each_rank_and_its_shifts(worlds):
    """Every rank's profile window over a 1F1B decode: its host seconds in
    the ring shifts among its collectives (no device kernel on the CPU),
    and the driver's program count."""
    w = worlds("pp2m2")
    toks, _ = _prompts(w.tc, 4, seed=10)
    w.tb.profile(True)
    _port_run(w.tb, toks, None, PLEN)
    prof = w.tb.profile(False)
    assert len(prof["ranks"]) == 2 and prof["driver"]["programs"] == 3
    for r in prof["ranks"]:
        assert r["comm_s"]["shift"] > 0 and r["wall_ms"] > 0
        assert r["kernels"] == {} and r["busy_ms"] == 0.0 and r["experts_ms"] is None


def test_batch_buckets_follow_the_granularity():
    """The JAX engine's ladder: the power-of-two buckets at granularity 1,
    (g, 2g, ...) past 16 otherwise."""
    from distributed_llm_inference_tpu.engine.engine import batch_buckets_for as jax_ladder

    for g in (1, 2, 3, 4, 6, 8):
        assert batch_buckets_for(g) == jax_ladder(g)


# -- through the engine and the HTTP server (tests/test_1f1b_serving.py) -----------


class _NumTok:
    def encode(self, text):
        return [int(t) % 250 + 3 for t in text.split()] or [3]

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in toks)


PROMPTS = [f"{3 * i + 1} {7 * i + 2} {5 * i + 4}" for i in range(8)]


@pytest.fixture(scope="module")
def engines():
    """The JAX plain pipeline engine, the port's plain pp 2 engine and its
    pp 2, M 2 engine, on the same weights."""
    from distributed_llm_inference_tpu import create_engine as jax_engine

    jcfg = jax_cfg("test-llama-tiny", eos_token_id=-1)
    tcfg = get_model_config("test-llama-tiny", eos_token_id=-1)
    params = JM.init_params(jcfg, jax.random.PRNGKey(9))
    tparams = params_from_numpy(tcfg, _np(params), "cpu")
    jecfg = __import__("distributed_llm_inference_tpu").EngineConfig(prefill_buckets=(32,))
    ecfg = EngineConfig(prefill_buckets=(32,))
    jplain = jax_engine(jcfg, mesh_cfg=JaxMeshConfig(pp=2), params=params,
                        tokenizer=_NumTok(), engine_cfg=jecfg)
    plain = create_engine(tcfg, mesh_cfg=MeshConfig(pp=2), params=tparams, tokenizer=_NumTok(),
                          engine_cfg=ecfg, device="cpu")
    f1b = create_engine(tcfg, mesh_cfg=MeshConfig(pp=2), microbatches=2, params=tparams,
                        tokenizer=_NumTok(), engine_cfg=ecfg, device="cpu")
    yield jplain, plain, f1b
    plain.backend.close()
    f1b.backend.close()


def test_backend_selected(engines):
    _, _, f1b = engines
    assert f1b.backend.name == "pipeline-1f1b"
    assert f1b.backend.batch_granularity == 2


def test_batch8_matches_plain_pipeline_greedy(engines):
    """generate_batch of 8 on the 1F1B engine: the JAX plain pipeline
    engine's responses and token counts."""
    jplain, _, f1b = engines
    a = jplain.generate_batch(PROMPTS, max_tokens=6, greedy=True, chat=False)
    b = f1b.generate_batch(PROMPTS, max_tokens=6, greedy=True, chat=False)
    assert a["status"] == b["status"] == "success", b
    for ra, rb in zip(a["results"], b["results"]):
        assert ra["response"] == rb["response"]
        assert ra["tokens_generated"] == rb["tokens_generated"]


def test_solo_serves_on_plain_ring(engines):
    """A solo request runs the inherited plain-ring batch-1 programs: the
    plain pipeline's response and the full solo envelope."""
    _, plain, f1b = engines
    a = plain.generate("11 22 33", max_tokens=5, greedy=True, chat=False)
    b = f1b.generate("11 22 33", max_tokens=5, greedy=True, chat=False)
    assert b["status"] == "success" and b["response"] == a["response"]
    assert b["backend"] == "pipeline-1f1b"
    for k in ("time_taken", "tokens_generated", "tokens_per_sec", "prompt_tokens"):
        assert k in b


def test_solo_full_surface_on_1f1b(engines):
    """logprobs, logit_bias and the OpenAI penalties serve on the 1F1B
    engine through the plain ring, equal to the plain pipeline."""
    _, plain, f1b = engines
    kw = dict(max_tokens=4, greedy=True, chat=False)
    a = plain.generate("1 2", logprobs=True, **kw)
    b = f1b.generate("1 2", logprobs=True, **kw)
    assert b["status"] == "success" and b["response"] == a["response"]
    assert b["token_logprobs"] == a["token_logprobs"]
    a = plain.generate("1 2", logit_bias={"17": 100.0}, **kw)
    b = f1b.generate("1 2", logit_bias={"17": 100.0}, **kw)
    assert b["response"] == a["response"] and set(b["response"].split()) == {"17"}
    a = plain.generate("5 5 5", frequency_penalty=1.5, **kw)
    b = f1b.generate("5 5 5", frequency_penalty=1.5, **kw)
    assert b["status"] == "success" and b["response"] == a["response"]


def test_odd_batch_pads_to_granularity(engines):
    """B = 3 on M = 2 pads the fleet to 4 rows; 3 results come back, equal
    to the plain pipeline's."""
    _, plain, f1b = engines
    a = plain.generate_batch(PROMPTS[:3], max_tokens=4, greedy=True, chat=False)
    b = f1b.generate_batch(PROMPTS[:3], max_tokens=4, greedy=True, chat=False)
    assert b["status"] == "success" and len(b["results"]) == 3
    assert [r["response"] for r in b["results"]] == [r["response"] for r in a["results"]]


def test_http_batch8_on_1f1b(engines):
    """An HTTP {"prompts": [8]} request served by pipeline-1f1b, equal to
    the plain pipeline's batch."""
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    _, plain, f1b = engines
    expected = plain.generate_batch(PROMPTS, max_tokens=5, greedy=True, chat=False)
    server = InferenceServer(f1b, host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate",
            data=json.dumps({"prompts": PROMPTS, "max_tokens": 5, "greedy": True,
                             "chat": False}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            r = json.loads(resp.read())
        assert r["status"] == "success" and r["backend"] == "pipeline-1f1b"
        assert [x["response"] for x in r["results"]] == \
            [x["response"] for x in expected["results"]]
    finally:
        server.shutdown()


def test_1f1b_warmup(engines):
    """warmup on a 1F1B engine runs the solo plain-ring programs and the
    fleet programs of every bucket of its granularity ladder, whose caches
    the next batch reuses."""
    _, _, f1b = engines
    stats = f1b.warmup()
    assert stats["programs"] > 2 * len(batch_buckets_for(2))
    assert set(f1b._batch_caches) == set(batch_buckets_for(2))
    r = f1b.generate_batch(PROMPTS[:2], max_tokens=3, greedy=True, chat=False)
    assert r["status"] == "success"
