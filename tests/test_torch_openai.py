"""PyTorch port vs JAX package: the OpenAI-compatible routes.

The cases of tests/test_openai_api.py (over each package's solo server)
and tests/test_openai_continuous.py (over each package's continuous paged
fleet), driven through both servers on the CPU with the same weights
(test-llama-tiny, fp32, params from the reference's init_params carried
over by models/bridge.py): every request goes to both, and the answers
must be equal but for their ids and clocks (sampled text, whose RNGs
differ, only in shape; log-probabilities within 1e-4). The copied
serving/openai_api.py is held to the JAX module function by function on
the same bodies and envelopes. Echo scoring answers the JAX server's
teacher-forced log-probabilities."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import chat as JCH  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.serving import openai_api as JO  # noqa: E402
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import chat as TCH  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import openai_api as TO  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", max_seq_len=512)
PKGS = ("jax", "port")
# the keys that carry ids and clocks, never compared
VOLATILE = ("id", "created", "request_id", "trace_id", "timings")


def _engine(params, tparams, pkg, **ecfg):
    if pkg == "jax":
        return JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                         engine_cfg=JaxEngineConfig(**ecfg))
    return create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                         engine_cfg=EngineConfig(**ecfg), device="cpu")


@pytest.fixture(scope="module")
def servers():
    """{"solo" | "fleet": {pkg: InferenceServer}}: each package's server
    over its solo engine, and over its continuous paged fleet."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tparams = params_from_numpy(get_model_config(MODEL, **OVERRIDES),
                                jax.tree.map(np.asarray, params), "cpu")
    out = {"solo": {}, "fleet": {}}
    for pkg in PKGS:
        mod, fleet_mod = (JS, JC) if pkg == "jax" else (TS, TC)
        eng = _engine(params, tparams, pkg, prefill_buckets=(64, 128))
        out["solo"][pkg] = mod.InferenceServer(eng, host="127.0.0.1", port=0)
        feng = _engine(params, tparams, pkg, prefill_buckets=(64,))
        cont = fleet_mod.ContinuousEngine(feng, n_slots=2, chunk_steps=4,
                                          kv_pool_blocks=64, kv_block_size=16,
                                          slot_max_seq=256)
        out["fleet"][pkg] = mod.InferenceServer(feng, host="127.0.0.1", port=0,
                                                continuous=cont)
    for group in out.values():
        for srv in group.values():
            srv.start()
    yield out
    for group in out.values():
        for srv in group.values():
            srv.shutdown()


def _call(srv, path, body=None):
    """(HTTP code, headers, raw body) of one request to srv."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _both(servers, path, body=None, kind="solo"):
    """{pkg: (code, json body)} of the same request to both servers."""
    out = {}
    for pkg, srv in servers[kind].items():
        code, _, raw = _call(srv, path, body)
        out[pkg] = (code, json.loads(raw))
    return out


def _stable(obj):
    """obj without the keys that carry ids and clocks."""
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


def _equal_ok(res):
    """Both answered 200 with equal bodies (ids and clocks aside)."""
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc == 200, res
    assert _stable(t) == _stable(j)
    return t


def _sse(raw: bytes):
    text = raw.decode()
    assert text.strip().endswith("data: [DONE]")
    return [json.loads(line[len("data: "):]) for line in text.strip().split("\n\n")
            if line.startswith("data: ") and line != "data: [DONE]"]


def _engine_of(servers, pkg, kind="solo"):
    return servers[kind][pkg].engine


# -- tests/test_openai_api.py ------------------------------------------------


def test_models_route(servers):
    out = _equal_ok(_both(servers, "/v1/models"))
    assert out["object"] == "list" and out["data"][0]["id"] == MODEL
    assert out["data"][0]["object"] == "model" and len(out["data"]) == 1


def test_completions_basic(servers):
    out = _equal_ok(_both(servers, "/v1/completions", {
        "model": MODEL, "prompt": "hello world", "max_tokens": 6, "temperature": 0}))
    assert out["object"] == "text_completion" and len(out["choices"]) == 1
    u = out["usage"]
    assert u["prompt_tokens"] > 0 and u["completion_tokens"] <= 6
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    for pkg in PKGS:
        code, hdr, raw = _call(servers["solo"][pkg], "/v1/completions",
                               {"prompt": "hello world", "max_tokens": 2})
        body = json.loads(raw)
        assert body["id"].startswith("cmpl-") and body["request_id"] == hdr["X-Request-Id"]
        assert body["trace_id"] == hdr["X-Trace-Id"]


def test_completions_greedy_matches_engine(servers):
    """temperature 0 is the engine's greedy path, raw continuation."""
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "the quick brown", "max_tokens": 5, "temperature": 0}))
    for pkg in PKGS:
        ref = _engine_of(servers, pkg).generate("the quick brown", max_tokens=5,
                                                greedy=True, chat=False)
        assert out["choices"][0]["text"] == ref["response"], pkg


def test_completions_batched_prompt_list(servers):
    prompts = ["alpha beta", "gamma delta epsilon"]
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": prompts, "max_tokens": 4, "temperature": 0}))
    assert [c["index"] for c in out["choices"]] == [0, 1]
    for p, choice in zip(prompts, out["choices"]):
        ref = _engine_of(servers, "port").generate(p, max_tokens=4, greedy=True, chat=False)
        assert choice["text"] == ref["response"]


def test_completions_finish_reason_length(servers):
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "a b c", "max_tokens": 3, "temperature": 0}))
    if out["usage"]["completion_tokens"] == 3:
        assert out["choices"][0]["finish_reason"] == "length"


def test_completions_stop_sequence(servers):
    base = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "x y", "max_tokens": 8, "temperature": 0}))["choices"][0]["text"]
    assert len(base) > 2
    needle = base[1]
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "x y", "max_tokens": 8, "temperature": 0, "stop": needle}))
    c = out["choices"][0]
    assert needle not in c["text"] and c["finish_reason"] == "stop"


def _logprobs_close(res, get):
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc == 200
    jl, tl = get(j), get(t)
    assert len(jl) == len(tl) > 0
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    return t


def test_completions_logprobs(servers):
    res = _both(servers, "/v1/completions", {
        "prompt": "hello", "max_tokens": 4, "temperature": 0, "logprobs": 1})
    out = _logprobs_close(res, lambda o: o["choices"][0]["logprobs"]["token_logprobs"])
    lp = out["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == out["usage"]["completion_tokens"]
    assert all(x <= 0.0 for x in lp["token_logprobs"])
    assert lp["tokens"] == res["jax"][1]["choices"][0]["logprobs"]["tokens"]


def test_completions_seeded_sampling_reproducible(servers):
    """The same seed twice: the same text from each server (the two
    packages' sampler RNGs draw different streams)."""
    body = {"prompt": "seed test", "max_tokens": 6, "temperature": 0.9, "seed": 123}
    for pkg in PKGS:
        a, b = (json.loads(_call(servers["solo"][pkg], "/v1/completions", body)[2])
                for _ in range(2))
        assert a["choices"][0]["text"] == b["choices"][0]["text"], pkg
        assert a["usage"] == b["usage"]


@pytest.mark.parametrize("body,param", [
    ({"max_tokens": 4}, "prompt"),
    ({"prompt": "x", "n": 99}, "n"),
    ({"prompt": "x", "n": "junk"}, "n"),
    ({"prompt": ["a", "b"], "n": 2}, "n"),
    ({"prompt": "x", "n": 2, "stream": True}, "n"),
    ({"prompt": "x", "best_of": 2}, "best_of"),
    ({"prompt": "x", "logit_bias": {"5": 500}}, "logit_bias"),
    ({"prompt": "x", "logit_bias": {"x": "y"}}, "logit_bias"),
    ({"prompt": "x", "frequency_penalty": 2.5}, "frequency_penalty"),
    ({"prompt": "x", "frequency_penalty": "y"}, "frequency_penalty"),
    ({"prompt": "x", "presence_penalty": -9}, "presence_penalty"),
    ({"prompt": "x", "temperature": -1}, "temperature"),
    ({"prompt": "x", "max_tokens": 0}, "max_tokens"),
    ({"prompt": "x", "stop": 5}, "stop"),
    ({"prompt": "x", "echo": True}, "echo"),
    ({"prompt": "x", "suffix": "y"}, "suffix"),
])
def test_completions_errors(servers, body, param):
    """Both servers answer the same OpenAI error object."""
    res = _both(servers, "/v1/completions", body)
    assert res["jax"] == res["port"]
    code, out = res["port"]
    assert code == 400
    assert out["error"]["type"] == "invalid_request_error" and out["error"]["param"] == param


def _sse_both(servers, path, body, kind="solo"):
    out = {}
    for pkg, srv in servers[kind].items():
        code, hdr, raw = _call(srv, path, body)
        assert code == 200 and hdr["Content-Type"].startswith("text/event-stream"), pkg
        out[pkg] = _sse(raw)
    return out


def test_completions_sse_stream(servers):
    seen = _sse_both(servers, "/v1/completions", {
        "prompt": "stream me", "max_tokens": 5, "temperature": 0, "stream": True})
    assert _stable(seen["port"]) == _stable(seen["jax"])
    events = seen["port"]
    assert all(e["object"] == "text_completion" for e in events)
    finals = [e for e in events if e["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[0]["usage"]["completion_tokens"] <= 5
    ref = _engine_of(servers, "port").generate("stream me", max_tokens=5, greedy=True,
                                               chat=False)
    assert "".join(e["choices"][0]["text"] for e in events) == ref["response"]


def test_chat_completions_basic(servers):
    out = _equal_ok(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Be terse."},
                     {"role": "user", "content": "hi there"}],
        "max_tokens": 6, "temperature": 0}))
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert out["usage"]["prompt_tokens"] > 0


def test_chat_completions_template_parity(servers):
    """The chat route renders the family's template: its greedy output is
    engine.generate(chat=True) on the same single user turn."""
    out = _equal_ok(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "what is up"}],
        "max_tokens": 5, "temperature": 0}))
    ref = _engine_of(servers, "port").generate("what is up", max_tokens=5, greedy=True,
                                               chat=True)
    assert out["choices"][0]["message"]["content"] == ref["response"]


def test_chat_completions_sse_stream(servers):
    seen = _sse_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "stream chat"}],
        "max_tokens": 5, "temperature": 0, "stream": True})
    assert _stable(seen["port"]) == _stable(seen["jax"])
    events = seen["port"]
    assert all(e["object"] == "chat.completion.chunk" for e in events)
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    assert len([e for e in events if e["choices"][0]["finish_reason"]]) == 1
    ref = _engine_of(servers, "port").generate("stream chat", max_tokens=5, greedy=True,
                                               chat=True)
    assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) \
        == ref["response"]


@pytest.mark.parametrize("msgs", [
    [],
    [{"role": "user", "content": "a"}, {"role": "system", "content": "b"}],
    [{"role": "assistant", "content": "only assistant"}],
    [{"role": "tool", "content": "x"}, {"role": "user", "content": "y"}],
], ids=["empty", "system_last", "assistant_only", "tool_role"])
def test_chat_completions_bad_messages(servers, msgs):
    res = _both(servers, "/v1/chat/completions", {"messages": msgs, "max_tokens": 4})
    assert res["jax"] == res["port"] and res["port"][0] == 400


@pytest.mark.parametrize("arch,template", [
    ("llama", None), ("llama", "tinyllama"), ("gpt2", None), ("llama", "gemma"),
    ("llama", "phi3")])
def test_format_chat_messages_parity(arch, template):
    """The port's engine/chat.py renders single and multi-turn message
    lists byte-identically to the JAX package's."""
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "q1"},
            {"role": "assistant", "content": "a1"}, {"role": "user", "content": "q2"}]
    for m in ([{"role": "user", "content": "hello"}], msgs):
        assert TCH.format_chat_messages(m, arch=arch, template=template) == \
            JCH.format_chat_messages(m, arch=arch, template=template)


def test_completions_n_choices(servers):
    """n sampled choices: the prompt billed once (the draws differ between
    the packages' RNGs, so only the shape is compared)."""
    for pkg in PKGS:
        srv = servers["solo"][pkg]
        out = json.loads(_call(srv, "/v1/completions", {
            "prompt": "pick some words", "max_tokens": 4, "n": 3, "temperature": 0.9})[2])
        one = json.loads(_call(srv, "/v1/completions", {
            "prompt": "pick some words", "max_tokens": 4, "temperature": 0.9})[2])
        assert [c["index"] for c in out["choices"]] == [0, 1, 2], pkg
        assert out["usage"]["prompt_tokens"] == one["usage"]["prompt_tokens"]
        assert out["usage"]["completion_tokens"] <= 12


def test_chat_completions_n_choices(servers):
    for pkg in PKGS:
        out = json.loads(_call(servers["solo"][pkg], "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3, "n": 2,
            "temperature": 0.8})[2])
        assert len(out["choices"]) == 2, pkg
        assert all(c["message"]["role"] == "assistant" for c in out["choices"])


def test_logit_bias_forces_and_bans(servers):
    """+100 on one token forces it under greedy, through the route and the
    engine alike; banning the natural first token changes the output."""
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "bias me", "max_tokens": 4, "temperature": 0, "logit_bias": {"17": 100}}))
    for pkg in PKGS:
        eng = _engine_of(servers, pkg)
        r = eng.generate("bias me", max_tokens=4, greedy=True, chat=False,
                         logit_bias={17: 100.0})
        assert r["status"] == "success" and out["choices"][0]["text"] == r["response"]
    eng = _engine_of(servers, "port")
    base = eng.generate("ban test", max_tokens=1, greedy=True, chat=False)
    first = eng.tokenizer.encode(base["response"])
    if len(first) == 1:
        banned = eng.generate("ban test", max_tokens=1, greedy=True, chat=False,
                              logit_bias={first[0]: -100.0})
        assert banned["response"] != base["response"]


def test_logit_bias_engine_validation(servers):
    for pkg in PKGS:
        r = _engine_of(servers, pkg).generate("x", max_tokens=2, greedy=True, chat=False,
                                              logit_bias={10 ** 9: 5.0})
        assert r["status"] == "failed" and r["error_type"] == "invalid_request", pkg


def test_stream_logprobs_and_top_logprobs_rejected(servers):
    res = _both(servers, "/v1/completions", {"prompt": "x", "stream": True, "logprobs": 1})
    assert res["jax"] == res["port"] and res["port"][0] == 400
    res = _both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "logprobs": True,
        "top_logprobs": 5})
    assert res["jax"] == res["port"] and res["port"][0] == 400
    assert res["port"][1]["error"]["param"] == "top_logprobs"


def test_chat_logprobs_token_strings(servers):
    res = _both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "temperature": 0, "logprobs": True})
    out = _logprobs_close(res, lambda o: [c["logprob"] for c in
                                          o["choices"][0]["logprobs"]["content"]])
    content = out["choices"][0]["logprobs"]["content"]
    assert len(content) == out["usage"]["completion_tokens"]
    assert [c["token"] for c in content] == [
        c["token"] for c in res["jax"][1]["choices"][0]["logprobs"]["content"]]
    assert all(c["logprob"] <= 0.0 for c in content)


def test_engine_reports_finish_reason(servers):
    for pkg in PKGS:
        eng = _engine_of(servers, pkg)
        r = eng.generate("a b c d", max_tokens=3, greedy=True, chat=False)
        assert r["finish_reason"] in ("stop", "length")
        if r["tokens_generated"] == 3:
            assert r["finish_reason"] == "length"
        base = eng.generate("a b c d", max_tokens=8, greedy=True, chat=False)
        if len(base["response"]) > 2:
            r2 = eng.generate("a b c d", max_tokens=8, greedy=True, chat=False,
                              stop=[base["response"][1]])
            assert r2["finish_reason"] == "stop", pkg


def test_completions_null_max_tokens_falls_through(servers):
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "hello", "max_tokens": None, "max_completion_tokens": 7,
        "temperature": 0}))
    assert out["usage"]["completion_tokens"] <= 7
    res = _both(servers, "/v1/completions", {
        "prompt": "hello", "max_tokens": 3, "temperature": 0, "logprobs": 0})
    assert "logprobs" in _logprobs_close(
        res, lambda o: o["choices"][0]["logprobs"]["token_logprobs"])["choices"][0]


def test_stream_events_flushes_solo_fallback_text():
    """A solo fallback yields only the final envelope: both modules' SSE
    adapters still deliver the whole text."""
    for mod in (JO, TO):
        events = iter([{"response": "full text", "status": "success",
                        "tokens_generated": 2, "prompt_tokens": 3, "done": True}])
        payloads = [p for p, _ in mod.stream_events(events, "m", {"max_tokens": 8},
                                                    chat=False)]
        text = "".join(json.loads(p[len(b"data: "):].decode())["choices"][0]["text"]
                       for p in payloads if p.startswith(b"data: {"))
        assert text == "full text", mod.__name__


# -- the copied module against the JAX one ------------------------------------


_ENVELOPES = [
    {"response": "abc", "status": "success", "tokens_generated": 3, "prompt_tokens": 4,
     "finish_reason": "length"},
    {"response": "de", "status": "success", "tokens_generated": 2, "prompt_tokens": 4,
     "stopped": True, "token_logprobs": [-0.5, -1.25], "token_strings": ["d", "e"]},
]
_FAILURES = [{"error": "Error: x", "status": "failed", "error_type": t}
             for t in ("invalid_request", "timeout", "deadline_exceeded", "cancelled",
                       "overloaded", "poison", None)]
_BODIES = [
    {"prompt": "x", "max_tokens": 5, "temperature": 0.7, "top_p": 0.9, "seed": 3},
    {"prompt": ["a", "b"], "stop": ["\n", ""], "logit_bias": {"3": -2}},
    {"prompt": "x", "echo": True, "logprobs": 2, "max_tokens": 0},
    {"prompt": "x", "deadline_ms": 250, "slo_class": "batch", "tenant": "t1",
     "frequency_penalty": 0.5, "presence_penalty": -0.5, "max_completion_tokens": 9},
    {"prompt": "x", "response_format": {"type": "json_object"}},
    {"prompt": "x", "deadline_ms": -1},
]


def _parsed(mod, fn, *args):
    try:
        return ("ok", fn(mod)(*args))
    except mod.OpenAIError as e:
        return ("error", e.status, e.body)


@pytest.mark.parametrize("i", range(len(_BODIES)))
def test_parse_completion_equals_jax(i):
    body = _BODIES[i]
    got = [_parsed(m, lambda m: m.parse_completion, json.loads(json.dumps(body)), 30)
           for m in (JO, TO)]
    assert got[1] == got[0]


@pytest.mark.parametrize("body", [
    {"messages": [{"role": "user", "content": "hi"}], "temperature": 0},
    {"messages": [{"role": "system", "content": "s"}, {"role": "user", "content": "q"}],
     "response_format": {"type": "json_schema", "json_schema": {"schema": {"type": "object"}}},
     "n": 2},
    {"messages": [{"role": "user", "content": "hi"}], "logprobs": True, "top_logprobs": 2},
    {"messages": "nope"},
], ids=["plain", "schema_n", "top_logprobs", "not_a_list"])
def test_parse_chat_equals_jax(body):
    def render(msgs):
        return JCH.format_chat_messages(msgs, arch="llama", template="tinyllama")

    got = [_parsed(m, lambda m: m.parse_chat, json.loads(json.dumps(body)), render, 30)
           for m in (JO, TO)]
    assert got[1] == got[0]


def test_responses_and_errors_equal_jax(monkeypatch):
    """completion / chat / echo-score / models responses and the error
    objects of every failure envelope, with the ids and clocks pinned."""
    import time as _time
    import uuid as _uuid

    class _Fixed:
        hex = "0" * 32

    monkeypatch.setattr(_uuid, "uuid4", lambda: _Fixed())
    monkeypatch.setattr(_time, "time", lambda: 1700000000.0)
    kw = {"max_tokens": 3}
    outs = []
    for mod in (JO, TO):
        out = [mod.completion_response(_ENVELOPES, "m", kw, prompt_once=True,
                                       request_id="r", timings={"total_s": 1.0},
                                       kv_extra={"kv_digests": ["d"]}, trace_id="t"),
               mod.chat_response(_ENVELOPES, "m", kw),
               mod.echo_score_response({"prompt": "p", "token_strings": ["p"],
                                        "token_logprobs": [None], "prompt_tokens": 1}, "m"),
               mod.models_response("m", 5, adapters=("a",))]
        out += [(e.status, e.body) for e in map(mod.error_for_envelope, _FAILURES)]
        events = [{"delta": "ab"}, {"delta": "c"}, {**_ENVELOPES[0], "done": True}]
        out += [list(mod.stream_events(iter(events), "m", kw, chat=c)) for c in (False, True)]
        out.append(list(mod.stream_events(iter([{"delta": "a"}, {**_FAILURES[3], "done": True}]),
                                          "m", kw, chat=True)))
        outs.append(out)
    assert outs[1] == outs[0]


def test_echo_scoring_names_its_roadmap_item(servers):
    """echo + logprobs + max_tokens 0 scores the prompt teacher-forced: the
    port answers as the JAX server does (it named its ROADMAP.md item until
    scoring was ported), log-probabilities within 1e-5, top-N alternatives
    the same strings; a prompt too short to score is the same 400."""
    body = {"prompt": "score me please", "echo": True, "logprobs": 2, "max_tokens": 0}
    res = _both(servers, "/v1/completions", body)
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc == 200 and t["choices"][0]["text"] == "score me please"
    jl, tl = j["choices"][0].pop("logprobs"), t["choices"][0].pop("logprobs")
    assert _stable(t) == _stable(j)
    assert tl["tokens"] == jl["tokens"] and tl["text_offset"] == jl["text_offset"]
    assert tl["token_logprobs"][0] is None and jl["token_logprobs"][0] is None
    np.testing.assert_allclose(tl["token_logprobs"][1:], jl["token_logprobs"][1:],
                               atol=1e-5)
    assert [list(d) for d in tl["top_logprobs"][1:]] == \
        [list(d) for d in jl["top_logprobs"][1:]]
    res = _both(servers, "/v1/completions", dict(body, prompt=""))
    assert res["port"][0] == res["jax"][0] and _stable(res["port"][1]) == _stable(
        res["jax"][1])


# -- tests/test_openai_continuous.py ------------------------------------------


def test_chat_stream_real_deltas(servers):
    """SSE from the fleet: several content deltas (the emulation sends
    one), the same chunks from both servers, the engine's greedy text."""
    seen = _sse_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "stream continuous"}],
        "max_tokens": 12, "temperature": 0, "stream": True}, kind="fleet")
    assert _stable(seen["port"]) == _stable(seen["jax"])
    events = seen["port"]
    content = [e["choices"][0]["delta"]["content"] for e in events
               if e["choices"][0]["delta"].get("content")]
    assert len(content) >= 2
    ref = _engine_of(servers, "port", "fleet").generate(
        "stream continuous", max_tokens=12, greedy=True, chat=True)
    assert "".join(content) == ref["response"]
    finals = [e for e in events if e["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[0]["usage"]["prompt_tokens"] > 0


def test_completions_fleet_unstreamed_equals_jax(servers):
    """The fleet answers the unstreamed routes as the JAX fleet does."""
    out = _equal_ok(_both(servers, "/v1/completions", {
        "prompt": "fleet route", "max_tokens": 8, "temperature": 0}, kind="fleet"))
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    _equal_ok(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "fleet chat"}], "max_tokens": 6,
        "temperature": 0}, kind="fleet"))


def test_completions_stream_seeded_solo_fallback_has_text(servers):
    """A seeded stream takes the fleet's solo fallback (no per-launch
    deltas): the SSE adapter still delivers the whole text, the server's
    own engine's sampled text for that seed."""
    for pkg in PKGS:
        srv = servers["fleet"][pkg]
        code, _, raw = _call(srv, "/v1/completions", {
            "prompt": "seeded stream", "max_tokens": 6, "temperature": 0.8, "seed": 11,
            "stream": True})
        assert code == 200
        text = "".join(e["choices"][0]["text"] for e in _sse(raw))
        ref = srv.engine.generate("seeded stream", max_tokens=6, temperature=0.8, top_k=0,
                                  top_p=1.0, seed=11, chat=False)
        assert text == ref["response"], pkg
