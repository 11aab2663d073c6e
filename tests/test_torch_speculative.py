"""PyTorch port vs JAX package: the solo engine's speculative decoding.

The cases of tests/test_speculative.py and tests/test_draft_speculative.py
at tier-1 sizes (test-llama-tiny, fp32, params from the reference's
init_params carried over by models/bridge.py): `decode_speculative` and
`decode_draft_speculative` give the JAX functions' ids and n_gen on the
same prompt's cache and history; the solo engine's speculative ids equal
plain greedy's and the JAX engine's, n-gram and through a draft model
(the target as its own draft accepting every token); a prompt that ends
within the draft length of max_seq_len stays inside the cache (the decode
headroom); each verify iteration reads the host once; and the requests
speculation cannot serve (sampled, penalized, biased, logprobs) decode
plainly with no `speculative` marker, as in the JAX engine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models import api as M  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
MAX_SEQ = 128
BUCKET = 32
BUCKETS = (16, 32)
REPEAT = ([7, 11, 13, 17] * 6)[:20]  # the 2-gram search finds drafts
RANDOM = [5, 9, 13, 21, 8, 3, 30, 12, 25, 6]  # no repeats: every draft rejected
PROMPT = "ab ab ab ab ab ab ab ab ab"


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, jax params, port cfg, port params), and a 1-layer draft
    of each at the same widths (seed 3)."""
    jcfg, cfg = jax_cfg(MODEL), get_model_config(MODEL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jdcfg, dcfg = jcfg.replace(n_layers=1, name="draft-tiny"), cfg.replace(
        n_layers=1, name="draft-tiny")
    jdp = JM.init_params(jdcfg, jax.random.PRNGKey(3))

    def port(c, p):
        return params_from_numpy(c, jax.tree.map(np.asarray, p), "cpu")

    return {"target": (jcfg, jp, cfg, port(cfg, jp)),
            "draft": (jdcfg, jdp, dcfg, port(dcfg, jdp))}


def _jax_prefill(jcfg, jp, ids):
    sampling = JG.default_sampling(greedy=True)
    tokens = jnp.asarray([ids + [jcfg.pad_token_id] * (BUCKET - len(ids))], jnp.int32)
    cache = JM.init_kv_cache(jcfg, 1, max_seq=MAX_SEQ)
    first, _, cache = JG.prefill(jcfg, jp, tokens, jnp.int32(len(ids)), cache,
                                 jax.random.PRNGKey(1), sampling)
    return first, cache


def _port_prefill(cfg, tp, ids):
    tokens = torch.tensor([ids + [cfg.pad_token_id] * (BUCKET - len(ids))])
    cache = M.init_kv_cache(cfg, 1, max_seq=MAX_SEQ, device="cpu")
    first, _, cache = G.prefill(cfg, tp, tokens, len(ids), cache,
                                torch.Generator().manual_seed(1),
                                G.default_sampling(greedy=True))
    return first, cache


def _port_plain(cfg, tp, ids, steps):
    first, cache = _port_prefill(cfg, tp, ids)
    out, n, _ = G.decode(cfg, tp, first, cache, len(ids), steps,
                         torch.Generator().manual_seed(1),
                         G.default_sampling(greedy=True), max_steps=steps)
    return first, out[0, :int(n[0])].tolist()


@pytest.mark.parametrize("draft_len", [2, 4])
@pytest.mark.parametrize("ids", [REPEAT, RANDOM], ids=["repetitive", "random"])
def test_decode_speculative_equals_jax_and_plain_greedy(weights, ids, draft_len):
    jcfg, jp, cfg, tp = weights["target"]
    steps = 16
    jfirst, jcache = _jax_prefill(jcfg, jp, ids)
    jhist = jnp.zeros((1, MAX_SEQ + draft_len + 2), jnp.int32).at[0, :len(ids)].set(
        jnp.asarray(ids, jnp.int32))
    jout, jn, _ = JG.decode_speculative(
        jcfg, jp, jfirst, jcache, jhist, jnp.int32(len(ids)), jnp.int32(steps),
        max_steps=steps, draft_len=draft_len)
    first, cache = _port_prefill(cfg, tp, ids)
    assert int(first[0]) == int(jfirst[0])
    hist = torch.zeros((1, MAX_SEQ + draft_len + 2), dtype=torch.long)
    hist[0, :len(ids)] = torch.tensor(ids)
    out, n, _ = G.decode_speculative(cfg, tp, first, cache, hist, len(ids), steps,
                                     max_steps=steps, draft_len=draft_len)
    assert int(n[0]) == int(jn[0])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _, plain = _port_plain(cfg, tp, ids, steps)
    assert out[0, :int(n[0])].tolist() == plain


@pytest.mark.parametrize("which", ["target", "draft"], ids=["perfect", "smaller"])
def test_decode_draft_speculative_equals_jax(weights, which):
    """The target as its own draft (every draft accepted) and a 1-layer
    draft: the JAX function's ids and n_gen, and plain greedy's."""
    jcfg, jp, cfg, tp = weights["target"]
    jdcfg, jdp, dcfg, dtp = weights[which]
    ids = RANDOM
    steps = 16
    jfirst, jcache = _jax_prefill(jcfg, jp, ids)
    _, jdcache = _jax_prefill(jdcfg, jdp, ids)
    jout, jn, _, _ = JG.decode_draft_speculative(
        jcfg, jp, jdcfg, jdp, jfirst, jcache, jdcache, jnp.int32(len(ids)),
        jnp.int32(steps), max_steps=steps, draft_len=4)
    first, cache = _port_prefill(cfg, tp, ids)
    _, dcache = _port_prefill(dcfg, dtp, ids)
    reads0 = G.draft_spec_loop.host_reads
    out, n, _, _ = G.decode_draft_speculative(cfg, tp, dcfg, dtp, first, cache, dcache,
                                              len(ids), steps, max_steps=steps,
                                              draft_len=4)
    reads = G.draft_spec_loop.host_reads - reads0
    assert int(n[0]) == int(jn[0])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _, plain = _port_plain(cfg, tp, ids, steps)
    assert out[0, :int(n[0])].tolist() == plain
    if which == "target" and int(n[0]) == steps:
        # full accept: G + 1 tokens per verify iteration, one read each
        # (plus the first token's stop flag)
        assert reads == 1 + -(-steps // 5)


def test_spec_loop_reads_the_host_once_per_verify(weights):
    """The n-gram loop's one (n_emit, finished) read per verify forward,
    plus the first token's stop flag: no per-token host walk."""
    _, _, cfg, tp = weights["target"]
    ids = REPEAT
    first, cache = _port_prefill(cfg, tp, ids)
    hist = torch.zeros((1, MAX_SEQ + 6), dtype=torch.long)
    hist[0, :len(ids)] = torch.tensor(ids)
    fwds = []

    def fwd(tokens_in, c, pos):
        fwds.append(pos)
        x = M.embed(cfg, tp, tokens_in, pos)
        x, c = M.forward_layers(cfg, tp["layers"], x, c, pos)
        return M.unembed(cfg, tp, x), c

    reads0 = G.spec_loop.host_reads
    out, n, _ = G.spec_loop(cfg, fwd, first, cache, hist, len(ids), 24,
                            max_steps=32, draft_len=4)
    assert G.spec_loop.host_reads - reads0 == 1 + len(fwds)
    assert 0 < len(fwds) <= int(n[0])
    # positions advance by what each verify emitted, never re-read per token
    assert fwds[0] == len(ids) and fwds == sorted(set(fwds))


def _engines(weights, draft=None, **ecfg):
    jcfg, jp, cfg, tp = weights["target"]
    je = JaxEngine(jcfg, jp, engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS, **ecfg))
    pe = create_engine(cfg, params=tp, engine_cfg=EngineConfig(prefill_buckets=BUCKETS,
                                                               **ecfg),
                       device="cpu")
    if draft is not None:
        jdcfg, jdp, dcfg, dtp = weights[draft]
        je.set_draft(jdcfg, jdp)
        pe.set_draft(dcfg, dtp)
    return je, pe


@pytest.mark.parametrize("draft", [None, "target", "draft"],
                         ids=["ngram", "self-draft", "small-draft"])
def test_engine_speculative_equals_plain_and_jax(weights, draft):
    je, pe = _engines(weights, draft)
    kw = dict(max_tokens=16, greedy=True, chat=False)
    plain = pe.generate(PROMPT, **kw)
    got = pe.generate(PROMPT, speculative=True, **kw)
    want = je.generate(PROMPT, speculative=True, **kw)
    assert got["status"] == want["status"] == "success", (got, want)
    assert got["response"] == plain["response"] == want["response"]
    for key in ("tokens_generated", "finish_reason", "speculative", "spec_path",
                "draft_model", "prompt_tokens"):
        assert got.get(key) == want.get(key), key
    assert got["speculative"] is True and "speculative" not in plain
    assert set(got) == set(want)
    counter = pe.metrics.get("dli_speculative_requests_total")
    assert counter.labels(engine="solo").value == 1
    if draft is not None:
        # the draft cache is kept between requests, as the JAX engine keeps it
        again = pe.generate(PROMPT, speculative=True, **kw)
        assert again["response"] == got["response"] and pe._draft_cache is not None


@pytest.mark.parametrize("prompt_len", [50, 55, 58])
def test_speculative_headroom_near_max_seq_len(weights, prompt_len):
    """A prompt within the draft length of max_seq_len: the clamp keeps
    the verify's pos..pos+G writes inside the cache (a missing headroom
    would write past S), with the JAX engine's budget and ids. The port
    engine sends T>1 chunks through the flash path (its CPU twin)."""
    jcfg, jp, cfg, tp = weights["target"]
    jcfg, cfg = jcfg.replace(max_seq_len=64), cfg.replace(max_seq_len=64,
                                                          attn_impl="kernel")
    je = JaxEngine(jcfg, jp, engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    pe = create_engine(cfg, params=tp, engine_cfg=EngineConfig(prefill_buckets=BUCKETS),
                       device="cpu")
    prompt = ("ab " * 40)[:prompt_len - 1]  # + BOS
    for spec in (True, False):
        kw = dict(max_tokens=20, greedy=True, chat=False, speculative=spec)
        got, want = pe.generate(prompt, **kw), je.generate(prompt, **kw)
        assert got["status"] == want["status"] == "success", (got, want)
        assert got["prompt_tokens"] == prompt_len
        for key in ("response", "tokens_generated", "finish_reason"):
            assert got[key] == want[key], key
        assert got.get("speculative") == want.get("speculative")


@pytest.mark.parametrize("extra", [
    {"greedy": False, "seed": 3},
    {"repetition_penalty": 1.3},
    {"frequency_penalty": 0.5},
    {"logit_bias": {"101": 1.5}},
    {"logprobs": True},
], ids=["sampled", "rep-penalty", "oai-penalty", "bias", "logprobs"])
def test_unservable_speculation_decodes_plainly(weights, extra):
    je, pe = _engines(weights)
    kw = dict(max_tokens=10, greedy=True, chat=False, speculative=True)
    kw.update(extra)
    got, want = pe.generate(PROMPT, **kw), je.generate(PROMPT, **kw)
    assert got["status"] == want["status"] == "success"
    assert "speculative" not in got and "speculative" not in want
    assert set(got) == set(want)
    if kw["greedy"]:
        assert got["response"] == want["response"]
        plain = pe.generate(PROMPT, **dict(kw, speculative=False))
        assert got["response"] == plain["response"]


def test_create_engine_draft_model_and_warmup(weights):
    """create_engine(draft_model=...) attaches a random draft from seed + 1
    in the requested dtype; warmup() runs the draft's ingest per bucket
    and one verify of the draft loop; a speculative request then reports
    the draft."""
    _, _, cfg, tp = weights["target"]
    eng = create_engine(cfg, params=tp, draft_model=MODEL, dtype="float32",
                        engine_cfg=EngineConfig(prefill_buckets=BUCKETS), device="cpu")
    assert eng._draft is not None and eng._draft[0].name == MODEL
    w = eng.warmup()
    assert w["programs"] > 0 and eng._draft_cache is not None
    r = eng.generate(PROMPT, max_tokens=8, greedy=True, chat=False, speculative=True)
    assert r["status"] == "success" and r["draft_model"] == MODEL
    # a draft of the other family attaches as the JAX engine's does
    eng.set_draft(get_model_config("test-gpt2-tiny"))
    assert eng._draft[0].arch == "gpt2" and eng._draft_cache is None
