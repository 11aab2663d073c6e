"""The solo request surface on the port's pp ring (parallel/pipeline.py):
scoring, per-token logprobs, logit_bias, beams, prompt-lookup and
draft-model speculation: the cases of tests/test_pp_feature_parity.py on
pp = 2, over the plain ring and the 1F1B schedule (which serves these solo
calls on its inherited plain-ring programs). The JAX pp tests are slow-
marked and need eight host devices, so the yardstick is the single
device: each mesh engine is held to the port's single-device engine and
to the JAX single-device InferenceEngine on the same weights
(test-llama-tiny, fp32, no EOS, the JAX params of PRNGKey 5 carried over
by models/bridge.py), on the CPU (each rank a process, gloo groups).

Tolerances: score and per-token logprobs within 1e-5 (the vocab shards'
head sums in another order than the whole head's); beams, greedy,
speculative and logit-bias ids equal; beam scores within 1e-5.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.pipeline import PipelineBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(eos_token_id=-1)
BUCKETS = (32, 64)
PROMPT = "12 44 91 7 33 5 12 44 91 7"
ATOL = 1e-5


class _NumTok:
    """Lossless ids <-> text ('12 7 9'), so token-exact comparisons survive
    decode round-trips (the JAX test's tokenizer)."""

    def encode(self, text):
        return [int(t) % 250 + 3 for t in text.split()] or [3]

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in toks)


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(5))
    dparams = JM.init_params(jax_cfg(MODEL, **OVERRIDES, n_layers=1), jax.random.PRNGKey(77))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    bridge = lambda c, p: params_from_numpy(c, jax.tree.map(np.asarray, p), "cpu")  # noqa: E731
    return (params, bridge(tcfg, params), dparams,
            bridge(tcfg.replace(n_layers=1), dparams))


@pytest.fixture(scope="module")
def single(weights):
    """(JAX single-device engine, the port's), and the JAX results by
    request, computed once for both backends' cases."""
    params, tparams, _, _ = weights
    je = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params, tokenizer=_NumTok(),
                   engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    pe = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                       tokenizer=_NumTok(), engine_cfg=EngineConfig(prefill_buckets=BUCKETS),
                       device="cpu")
    cached = {}

    def jax_result(key, fn):
        if key not in cached:
            cached[key] = fn(je)
        return cached[key]

    return je, pe, jax_result


@pytest.fixture(scope="module", params=["pipeline", "pipeline-1f1b"])
def mesh(request, weights):
    """The pp = 2 engine on the plain ring or the 1F1B schedule, a draft
    model (one layer) replicated on its ranks."""
    _, tparams, _, dtparams = weights
    mb = 2 if request.param == "pipeline-1f1b" else 1
    eng = create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                        mesh_cfg=MeshConfig(pp=2), microbatches=mb, tokenizer=_NumTok(),
                        engine_cfg=EngineConfig(prefill_buckets=BUCKETS), device="cpu")
    assert eng.backend.name == request.param
    eng.set_draft(get_model_config(MODEL, **OVERRIDES, n_layers=1), dtparams)
    yield eng
    eng.backend.close()


def _gen(eng, **kw):
    r = eng.generate(PROMPT, chat=False, **kw)
    assert r["status"] == "success", r
    return r


def test_capabilities_at_dp1_and_refusals_in_jax_words(mesh):
    """The JAX flags: every solo feature at dp = 1, speculation off at
    dp > 1, beams refused there in the JAX words (the check comes before
    any program runs)."""
    be = mesh.backend
    assert (be.supports_score, be.supports_beam, be.supports_speculative,
            be.supports_draft) == (True, True, True, True)
    dp2 = types.SimpleNamespace(dp=2)
    assert not PipelineBackend.supports_speculative.fget(dp2)
    assert not PipelineBackend.supports_draft.fget(dp2)
    with pytest.raises(NotImplementedError, match="beam search needs dp == 1"):
        PipelineBackend.decode_beam(dp2, None, None, 0, 1, 1.0, max_steps=1,
                                    num_beams=2, early_stopping=False)


def test_set_draft_refuses_without_supports_draft(weights):
    """engine.set_draft refuses a backend without draft speculation in the
    JAX engine's words."""
    _, tparams, _, _ = weights
    cfg = get_model_config(MODEL, **OVERRIDES)
    be = types.SimpleNamespace(name="context-parallel", supports_draft=False,
                               device=torch.device("cpu"))
    eng = InferenceEngine(cfg, backend=be, tokenizer=_NumTok())
    with pytest.raises(ValueError, match="does not support draft-model speculation"):
        eng.set_draft(cfg.replace(n_layers=1))


def test_score_equals_single_device_and_jax(mesh, single):
    je, pe, jax_result = single
    a = jax_result("score", lambda e: e.score(PROMPT, top_n=3))
    b = pe.score(PROMPT, top_n=3)
    c = mesh.score(PROMPT, top_n=3)
    assert a["status"] == b["status"] == c["status"] == "success"
    assert c["token_logprobs"][0] is None
    for want in (a, b):
        np.testing.assert_allclose(c["token_logprobs"][1:], want["token_logprobs"][1:],
                                   rtol=0, atol=ATOL)
        for tc, tw in zip(c["top_logprobs"][1:], want["top_logprobs"][1:]):
            assert list(tc) == list(tw)


def test_logprobs_equal_single_device_and_jax(mesh, single):
    je, pe, jax_result = single
    kw = dict(max_tokens=6, greedy=True, logprobs=True)
    a = jax_result("logprobs", lambda e: e.generate(PROMPT, chat=False, **kw))
    b, c = _gen(pe, **kw), _gen(mesh, **kw)
    assert a["response"] == b["response"] == c["response"]
    for want in (a, b):
        np.testing.assert_allclose(c["token_logprobs"], want["token_logprobs"], rtol=0,
                                   atol=ATOL)


def test_logit_bias_equal(mesh, single):
    je, pe, jax_result = single
    kw = dict(max_tokens=5, greedy=True, logit_bias={"17": 100.0})
    a = jax_result("bias", lambda e: e.generate(PROMPT, chat=False, **kw))
    b, c = _gen(pe, **kw), _gen(mesh, **kw)
    assert a["response"] == b["response"] == c["response"]
    # +100 under greedy forces the token every step
    assert set(c["response"].split()) == {"17"}
    # presence (the repetition penalty) with a bias: the variant programs
    kw = dict(max_tokens=6, greedy=True, repetition_penalty=1.3, logit_bias={"55": 2.5})
    a = jax_result("pen_bias", lambda e: e.generate(PROMPT, chat=False, **kw))
    assert _gen(mesh, **kw)["response"] == _gen(pe, **kw)["response"] == a["response"]


def test_logit_bias_sampled_equals_single_device(mesh, single):
    """A sampled stream with a bias: the port's generator on both (the JAX
    RNG draws another stream)."""
    _, pe, _ = single
    kw = dict(max_tokens=6, temperature=0.8, seed=11, logit_bias={"29": 4.0, "41": -100.0})
    a, b = _gen(pe, **kw), _gen(mesh, **kw)
    assert a["response"] == b["response"]
    assert "41" not in b["response"].split()


@pytest.mark.parametrize("num_beams", [3, 2], ids=["beams3", "beams2_fleet_granularity"])
def test_beams_equal_single_device_and_jax(mesh, single, num_beams):
    """Beams on the ring (each rank tiles and reorders its own cache
    shard); 2 beams land on the 1F1B backend's fleet granularity, whose
    batch-1 prefill still seeds them from real logits."""
    je, pe, jax_result = single
    kw = dict(max_tokens=8, num_beams=num_beams)
    a = jax_result(("beams", num_beams), lambda e: e.generate(PROMPT, chat=False, **kw))
    b, c = _gen(pe, **kw), _gen(mesh, **kw)
    for want in (a, b):
        assert c["response"] == want["response"]
        assert len(c["beams"]) == len(want["beams"]) == num_beams
        for bc, bw in zip(c["beams"], want["beams"]):
            assert (bc["text"], bc["tokens"]) == (bw["text"], bw["tokens"])
            assert bc["score"] == pytest.approx(bw["score"], abs=ATOL)


def test_speculative_equals_plain_greedy(mesh, single):
    """Prompt-lookup speculation on the ring: one program per engine call
    (the loop's iterations inside each rank's program); every emitted token
    is the argmax, so the ids equal plain greedy's in fp32, the JAX
    engine's included."""
    je, pe, jax_result = single
    plain = jax_result("plain", lambda e: e.generate(PROMPT, chat=False, max_tokens=10,
                                                     greedy=True))
    draft, mesh._draft = mesh._draft, None  # prompt lookup: no draft attached
    try:
        before = mesh.backend.program_stats["programs"]
        r = _gen(mesh, max_tokens=10, greedy=True, speculative=True)
        spent = mesh.backend.program_stats["programs"] - before
    finally:
        mesh._draft = draft
    assert r["spec_path"] == "solo" and "draft_model" not in r
    assert r["response"] == plain["response"]
    assert _gen(pe, max_tokens=10, greedy=True, speculative=True)["response"] == r["response"]
    # init_cache once, the prefill and the speculation loop: no program per
    # iteration
    assert spent <= 3, spent


def test_draft_speculative_equals_plain_greedy(mesh, single, weights):
    """Two-model speculation on the ring: the draft replicated on every
    rank (shipped once by set_draft), its ingest and cache on every rank;
    the ids equal plain greedy's and the single device's with the same
    draft."""
    je, pe, jax_result = single
    plain = jax_result("plain", lambda e: e.generate(PROMPT, chat=False, max_tokens=10,
                                                     greedy=True))
    r = _gen(mesh, max_tokens=10, greedy=True, speculative=True)
    assert r["draft_model"] == MODEL and r["spec_path"] == "solo"
    assert r["response"] == plain["response"]
    pe.set_draft(get_model_config(MODEL, **OVERRIDES, n_layers=1), weights[3])
    try:
        assert _gen(pe, max_tokens=10, greedy=True, speculative=True)["response"] \
            == r["response"]
    finally:
        pe._draft = pe._draft_backend = pe._draft_cache = None
    # a repeat reuses the ranks' draft cache (a handle on every rank)
    assert _gen(mesh, max_tokens=10, greedy=True, speculative=True)["response"] \
        == r["response"]


def test_score_chunk_program_equals_single_device(mesh, weights):
    """The backend's score_chunk at an offset (a later chunk of a chunked
    score): within_lp, the top-N and last_lp against the single device's
    generate.score_chunk after the same first chunk."""
    _, tparams, _, _ = weights
    cfg = get_model_config(MODEL, **OVERRIDES)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 32))).long()
    be = mesh.backend
    cache = be.init_cache(1, 128)
    ref_cache = M.init_kv_cache(cfg, 1, max_seq=128)
    for pos in (0, 32):
        got = be.score_chunk(toks, pos, cache, top_n=2)
        want = G.score_chunk(cfg, tparams, toks, pos, ref_cache, top_n=2)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=0,
                                       atol=ATOL)
        cache = got[4]
