"""PyTorch port vs JAX package: grammar-constrained decoding on the solo
engine and the slot decode (the cases of tests/test_constrained_decode.py).

Ops level: fsm_allowed, fsm_advance and sample_token(allowed=) against
the JAX functions on the same seeded inputs; a bf16 row whose one allowed
token sits far below the max; a softmax over a masked row with one
allowed token (probability 1, no NaN).

Engine level, test-llama-tiny in fp32 with the byte tokenizer on the same
weights in both packages: the solo engine's greedy ids equal the JAX
engine's for regexes, choices and a JSON schema; generate_batch equals;
a constraint with penalties and logit_bias, with textual stops (the host
re-walk between chunks) and with logprobs equals; sampled output matches
the constraint over many seeds (the RNGs differ, so the independent
Python re / json oracle judges it); the compose and malformed-spec
rejections answer the JAX envelopes; the LRU reuses and evicts.

Slot level: decode_slots_constrained with every row at the free state is
bit-equal to decode_slots, and with constrained rows equals the JAX
decode_slots_constrained (tokens, masks, FSM states)."""

import json
import re

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
from distributed_llm_inference_tpu.ops import sampling as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy,
    slots_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import sampling as S  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
BUCKETS = (32, 64)
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
          "required": ["name", "age"]}

CASES = [
    ({"regex": r"(red|green|blue)"}, lambda t: re.fullmatch(r"(red|green|blue)", t)),
    ({"regex": r"[0-9]{2,4}"}, lambda t: re.fullmatch(r"[0-9]{2,4}", t)),
    ({"choices": ["alpha", "beta", "alphabet"]},
     lambda t: t in ("alpha", "beta", "alphabet")),
    ({"json_schema": SCHEMA}, lambda t: isinstance(json.loads(t)["age"], int)),
]


@pytest.fixture(scope="module")
def engines():
    params = JM.init_params(jax_cfg(MODEL), jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, params)
    jax_engine = JaxEngine(jax_cfg(MODEL), params,
                           engine_cfg=JaxEngineConfig(prefill_buckets=BUCKETS))
    port = create_engine(
        MODEL, params=params_from_numpy(get_model_config(MODEL), tree, "cpu"),
        engine_cfg=EngineConfig(prefill_buckets=BUCKETS), device="cpu",
    )
    return jax_engine, port


# -- ops ---------------------------------------------------------------------------


def test_fsm_ops_equal_jax():
    rng = np.random.default_rng(0)
    S_, V, B = 9, 40, 6
    cmask = rng.random((S_, V)) < 0.3
    cmask[:, 0] = True
    ctrans = rng.integers(0, S_, (S_, V)).astype(np.int32)
    fsm = rng.integers(0, S_, B).astype(np.int32)
    tokens = rng.integers(0, V, B).astype(np.int32)
    active = rng.random(B) < 0.6
    np.testing.assert_array_equal(
        G.fsm_allowed(torch.from_numpy(cmask), torch.from_numpy(fsm)).numpy(),
        np.asarray(JG.fsm_allowed(jnp.asarray(cmask), jnp.asarray(fsm))))
    got = G.fsm_advance(torch.from_numpy(ctrans), torch.from_numpy(fsm),
                        torch.from_numpy(tokens).long(), torch.from_numpy(active))
    want = JG.fsm_advance(jnp.asarray(ctrans), jnp.asarray(fsm), jnp.asarray(tokens),
                          jnp.asarray(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("knobs", [
    dict(greedy=True),
    dict(greedy=True, bias=True),
    dict(greedy=True, rep=1.3, freq=0.5, pres=0.2),
    dict(greedy=False, temperature=0.7, top_k=5, top_p=0.9, min_p=0.05),
    dict(greedy=False, temperature=1.5, top_k=0, top_p=1.0),
])
def test_sample_token_allowed_equals_jax(knobs):
    """Greedy: the same token as the JAX sampler under the same mask (after
    bias and penalties). Sampled: the RNGs differ, so every draw lands in
    the mask and the per-row allowed set equals JAX's."""
    rng = np.random.default_rng(1)
    B, V = 5, 64
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3
    allowed = rng.random((B, V)) < 0.25
    allowed[np.arange(B), rng.integers(0, V, B)] = True
    bias = np.zeros(V, np.float32)
    if knobs.get("bias"):
        bias[np.flatnonzero(~allowed[0])[:3]] = 100.0  # +100 on banned tokens
    presence = rng.random((B, V)) < 0.3
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    args = (knobs.get("temperature", 1.0), knobs.get("top_k", 0),
            knobs.get("top_p", 1.0), knobs["greedy"], knobs.get("min_p", 0.0),
            knobs.get("rep", 1.0), knobs.get("freq", 0.0), knobs.get("pres", 0.0))
    for seed in range(6):
        got = S.sample_token(
            torch.Generator().manual_seed(seed), torch.from_numpy(logits), *args,
            presence=torch.from_numpy(presence), counts=torch.from_numpy(counts),
            bias=torch.from_numpy(bias), allowed=torch.from_numpy(allowed)).numpy()
        assert allowed[np.arange(B), got].all()
        if knobs["greedy"]:
            want = np.asarray(JS.sample_token(
                jax.random.PRNGKey(seed), jnp.asarray(logits), *args,
                presence=jnp.asarray(presence), counts=jnp.asarray(counts),
                bias=jnp.asarray(bias), allowed=jnp.asarray(allowed)))
            np.testing.assert_array_equal(got, want)


def test_bf16_row_with_one_allowed_token_far_below_the_max():
    """The first token's mask rides the bias as -1e9 in fp32; the sampler
    casts bf16 logits up before the add, so the one allowed token wins
    however far below the max it sits, greedy and sampled alike."""
    V = 32000
    logits = torch.full((1, V), 30.0, dtype=torch.bfloat16)
    logits[0, 7] = -60.0
    bias = torch.full((V,), -1e9)
    bias[7] = 0.0
    for greedy, seed in ((True, 0), (False, 1), (False, 2)):
        tok = S.sample_token(torch.Generator().manual_seed(seed), logits, 0.6, 0, 1.0,
                             greedy, bias=bias)
        assert int(tok[0]) == 7
    allowed = torch.zeros((1, V), dtype=torch.bool)
    allowed[0, 7] = True
    tok = S.sample_token(torch.Generator().manual_seed(3), logits, 0.6, 40, 0.9, False,
                         min_p=0.1, allowed=allowed)
    assert int(tok[0]) == 7


def test_masked_softmax_one_allowed_token_is_certain():
    logits = torch.randn(3, 500) * 20
    allowed = torch.zeros_like(logits, dtype=torch.bool)
    allowed[torch.arange(3), torch.tensor([4, 250, 499])] = True
    masked = torch.where(allowed, logits, S.NEG_INF)
    for t in (1.0, 0.3):  # a temperature below 1 scales NEG_INF past fp32
        p = torch.softmax(S.apply_temperature(masked, t), dim=-1)
        assert not torch.isnan(p).any()
        np.testing.assert_array_equal(p[allowed].numpy(), np.ones(3, np.float32))
        assert (p[~allowed] == 0).all()


# -- the solo engine ---------------------------------------------------------------


def _same(got, want, keys=("status", "response", "tokens_generated", "finish_reason",
                           "constrained", "prompt_tokens")):
    assert got["status"] == want["status"] == "success", (got, want)
    for k in keys:
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))


@pytest.mark.parametrize("spec,check", CASES, ids=lambda c: str(c)[:20])
def test_solo_greedy_ids_equal_jax(engines, spec, check):
    jax_engine, port = engines
    kw = dict(max_tokens=120, greedy=True, chat=False, constraint=spec)
    want = jax_engine.generate("the answer:", **kw)
    got = port.generate("the answer:", **kw)
    _same(got, want)
    assert got["constrained"] is True and check(got["response"])
    assert got["finish_reason"] == "stop"  # EOS forced at the accept state
    assert "constraint_compile_s" in got["timings"]
    assert set(got) == set(want)


@pytest.mark.parametrize("spec,check", CASES, ids=lambda c: str(c)[:20])
def test_solo_sampled_satisfies_constraint(engines, spec, check):
    _, port = engines
    for seed in range(4):
        r = port.generate("the answer:", max_tokens=120, chat=False, seed=seed,
                          temperature=1.5, top_k=0, top_p=1.0, constraint=spec)
        assert r["status"] == "success" and r["constrained"] is True, r
        assert check(r["response"]), (spec, r["response"])
        assert r["finish_reason"] == "stop", r


def test_solo_sampled_many_seeds(engines):
    _, port = engines
    pat = r"-?(0|[1-9][0-9]{0,2})(\.[0-9])?"
    for seed in range(10):
        r = port.generate("n:", max_tokens=40, chat=False, seed=seed, temperature=2.0,
                          top_k=0, top_p=1.0, constraint={"regex": pat})
        assert re.fullmatch(pat, r["response"]), r["response"]


@pytest.mark.parametrize("kw", [
    dict(greedy=True),
    dict(greedy=True, repetition_penalty=1.3, frequency_penalty=0.5),
])
def test_generate_batch_equals_jax(engines, kw):
    jax_engine, port = engines
    prompts = ["q1:", "a much longer second prompt row", "q3:"]
    args = dict(max_tokens=20, chat=False, constraint={"regex": "(yes|no|maybe)!?"}, **kw)
    want = jax_engine.generate_batch(prompts, **args)
    got = port.generate_batch(prompts, **args)
    assert got["status"] == want["status"] == "success", got
    assert got["constrained"] is want["constrained"] is True
    assert set(got) == set(want)
    for g, w in zip(got["results"], want["results"]):
        assert g == w
        assert re.fullmatch("(yes|no|maybe)!?", g["response"])


def test_generate_batch_sampled_satisfies_constraint(engines):
    _, port = engines
    r = port.generate_batch(["x", "y"], max_tokens=20, temperature=1.7, top_k=0,
                            top_p=1.0, seed=11, chat=False,
                            constraint={"regex": "[ab]{1,6}!"})
    for e in r["results"]:
        assert re.fullmatch("[ab]{1,6}!", e["response"]), e


@pytest.mark.parametrize("kw", [
    dict(constraint={"regex": "(ab|cd)"}, logit_bias={ord("c") + 3: 100.0}),
    dict(constraint={"regex": "[ab]{1,8}"}, repetition_penalty=1.3,
         frequency_penalty=0.5, presence_penalty=0.3),
    dict(constraint={"regex": "[0-9]{1,12}"}, stop=["zzz-never-matches"]),
    dict(constraint={"regex": "[0-9]{1,40}"}, stop=["9"]),
    dict(constraint={"choices": ["on", "off"]}, logprobs=True),
    dict(constraint={"json_schema": SCHEMA}, stop=["never"], logprobs=True),
])
def test_constraint_composes_equal_jax(engines, kw):
    """The mask stacks after logit_bias and the penalties (a +100 bias on a
    banned token does not resurrect it), the textual-stop path re-walks
    the DFA on the host between chunks, and logprobs cover every token:
    the same tokens (and log-probabilities) as the JAX engine."""
    jax_engine, port = engines
    args = dict(max_tokens=60, greedy=True, chat=False, **kw)
    want = jax_engine.generate("go:", **args)
    got = port.generate("go:", **args)
    _same(got, want, keys=("status", "response", "tokens_generated", "finish_reason",
                           "constrained", "stopped", "token_strings"))
    if "logprobs" in kw:
        np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                                   atol=1e-4)
        assert len(got["token_logprobs"]) == len(got["response"])  # byte tokenizer


@pytest.mark.parametrize("kw", [
    dict(constraint={"regex": "a"}, num_beams=2),
    dict(constraint={"regex": "a"}, speculative=True, greedy=True),
    dict(constraint={"bogus": 1}), dict(constraint={"regex": ""}),
    dict(constraint={"regex": "("}), dict(constraint={"choices": []}),
    dict(constraint={"json_schema": {"type": "tuple"}}),
    dict(constraint={"regex": "a", "choices": ["b"]}),
    dict(constraint={"regex": r"[ab]*a[ab]{15}"}),
])
def test_rejections_equal_jax(engines, kw):
    """Compose refusals come first, with the JAX message, ahead of the
    port's own not-ported errors for beams and speculation; malformed
    specs answer the same invalid_request envelope."""
    jax_engine, port = engines
    want = jax_engine.generate("x", max_tokens=4, **kw)
    got = port.generate("x", max_tokens=4, **kw)
    assert got["status"] == want["status"] == "failed"
    assert got["error_type"] == want["error_type"] == "invalid_request"
    assert got["error"] == want["error"]
    if "num_beams" in kw or "speculative" in kw:
        assert "does not compose" in got["error"]
    else:
        want = jax_engine.generate_batch(["x", "y"], max_tokens=4, **kw)
        got = port.generate_batch(["x", "y"], max_tokens=4, **kw)
        assert got["error"] == want["error"] and got["error_type"] == "invalid_request"


def test_artifact_lru_reuse_and_eviction():
    port = create_engine(MODEL, engine_cfg=EngineConfig(prefill_buckets=BUCKETS,
                                                        constraint_cache_entries=2),
                         device="cpu")
    spec = {"regex": "cache(d|r)"}
    port.generate("x", max_tokens=15, greedy=True, chat=False, constraint=spec)
    art = next(iter(port._constraint_cache.values()))
    dev = art.device_tables(port.device)
    port.generate("y", max_tokens=15, greedy=True, chat=False, constraint=spec)
    assert list(port._constraint_cache.values()) == [art]  # hash hit, no recompile
    assert art.device_tables(port.device)[0] is dev[0]  # and no re-upload
    for other in ({"regex": "x+"}, {"regex": "y+"}):
        port.generate("z", max_tokens=5, greedy=True, chat=False, constraint=other)
    assert len(port._constraint_cache) == 2
    assert all(a is not art for a in port._constraint_cache.values())


# -- slot decode ---------------------------------------------------------------------


def _armed_fleet(cfg, be, first_sample, n_slots=3):
    """A dense fleet cache with slots 0 and 2 armed (prompts prefilled on a
    batch-1 scratch and spliced in), as the port does it."""
    cache = be.init_cache(n_slots, cfg.max_seq_len)
    state, sparams = G.init_slots(n_slots, cfg.vocab_size)
    for slot, plen in ((0, 8), (2, 13)):
        toks = torch.full((1, 32), cfg.pad_token_id, dtype=torch.long)
        toks[0, :plen] = torch.arange(10, 10 + plen)
        first, _, scratch = be.prefill(toks, plen, be.init_cache(1, cfg.max_seq_len),
                                       torch.Generator().manual_seed(slot),
                                       G.default_sampling(greedy=True))
        first = first_sample.get(slot, first)
        cache, state, sparams = G.insert_slot(
            cfg, cache, scratch, state, sparams, slot, first, plen, 30,
            1.0, 0, 1.0, slot == 0, 0.0, 1.0, 0.0, 0.0,
            torch.zeros(cfg.vocab_size, dtype=torch.bool))
    return cache, state, sparams


def test_decode_slots_constrained_free_rows_bit_equal_plain(engines):
    """With every row at the free state the constrained chunk emits
    exactly what the plain one does, bit for bit (greedy and a sampled
    row drawing the same generator stream), and the FSM stays at 0."""
    _, port = engines
    cfg, be = port.cfg, port.backend
    outs = []
    for constrained in (False, True):
        cache, state, sparams = _armed_fleet(cfg, be, {})
        gen = torch.Generator().manual_seed(7)
        if constrained:
            cm = torch.ones((1, cfg.vocab_size), dtype=torch.bool)
            ct = torch.zeros((1, cfg.vocab_size), dtype=torch.int32)
            fsm = torch.zeros(3, dtype=torch.int32)
            em, mask, state, cache, fsm = be.decode_slots_constrained(
                state, cache, gen, sparams, fsm, cm, ct, num_steps=10)
            assert (fsm == 0).all()
        else:
            em, mask, state, cache = be.decode_slots(state, cache, gen, sparams,
                                                     num_steps=10)
        outs.append((em, mask, state, cache))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a, b)
    for name in ("k", "v"):
        assert torch.equal(outs[0][3][name], outs[1][3][name])


def test_decode_slots_constrained_equals_jax(engines):
    """Constrained rows under a fleet table (two constraints rebased into
    one table, a free row beside them): greedy tokens, masks, slot state
    and FSM states equal the JAX decode_slots_constrained."""
    jax_engine, port = engines
    from distributed_llm_inference_tpu import constrain as JC
    from distributed_llm_inference_tpu_torch import constrain as TC

    jcfg, tcfg = jax_engine.cfg, port.cfg
    specs = [{"regex": "[0-9]{3}-[0-9]{4}"}, {"choices": ["alpha", "beta"]}]
    jt = JC.FleetConstraintTable(jcfg.vocab_size, 64)
    tt = TC.FleetConstraintTable(tcfg.vocab_size, 64)
    offs = []
    for spec in specs:
        ja = jax_engine._compile_constraint(spec)
        ta = port._compile_constraint(spec)
        offs.append((ta, tt.acquire(ta)))
        assert jt.acquire(ja) == offs[-1][1]
    B, S_ = 3, jcfg.max_seq_len
    jbe = jax_engine.backend
    jcache = jbe.init_cache(B, S_)
    jstate, jsp = JG.init_slots(B, jcfg.vocab_size)
    firsts, fsm = {}, np.zeros(B, np.int32)
    key = jax.random.PRNGKey(0)
    for slot, plen, (art, off) in ((0, 8, offs[0]), (2, 13, offs[1])):
        toks = np.full((1, 32), jcfg.pad_token_id, np.int32)
        toks[0, :plen] = np.arange(10, 10 + plen)
        bias = jnp.asarray(art.start_bias())
        jfirst, _, jscratch = jbe.prefill(jnp.asarray(toks), jnp.int32(plen),
                                          jbe.init_cache(1, S_), key,
                                          JG.default_sampling(greedy=True), bias=bias)
        firsts[slot] = int(jfirst[0])
        fsm[slot] = off + art.advance(art.start, firsts[slot])
        jcache, jstate, jsp = JG.insert_slot(
            jcfg, jcache, jscratch, jstate, jsp, slot, jfirst[0], jnp.int32(plen),
            jnp.int32(30), 1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0,
            jnp.zeros(jcfg.vocab_size, bool))
    cm, ct = jt.device_tables()
    jem, jmask, jstate2, _, jfsm = jbe.decode_slots_constrained(
        jstate, jcache, key, jsp, jnp.asarray(fsm), cm, ct, num_steps=12)
    tfirst = {s: torch.tensor([f]) for s, f in firsts.items()}
    cache, state, sparams = _armed_fleet(tcfg, port.backend, tfirst)
    tstate, tsp = slots_from_numpy(jax.tree.map(np.asarray, jstate),
                                   jax.tree.map(np.asarray, jsp), "cpu")
    for a, b in zip(tstate, state):
        assert torch.equal(a, b)
    tcm, tct = tt.device_tables("cpu")
    em, mask, state2, _, tfsm = port.backend.decode_slots_constrained(
        state, cache, torch.Generator().manual_seed(0), sparams,
        torch.from_numpy(fsm), tcm, tct, num_steps=12)
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tfsm.numpy(), np.asarray(jfsm))
    assert tfsm.dtype == torch.int32 and (tfsm.numpy()[[0, 2]] > 0).all()
    np.testing.assert_array_equal(state2.active.numpy(), np.asarray(jstate2.active))
    # every emitted row walks its own constraint
    for slot, (art, off) in ((0, offs[0]), (2, offs[1])):
        toks = [firsts[slot]] + [int(t) for t in em[mask[:, slot], slot]]
        text = port.tokenizer.decode(toks)
        assert re.fullmatch("[0-9]{3}-[0-9]{4}" if slot == 0 else "alpha|beta", text)
