"""PyTorch port vs JAX package: structured output over HTTP (the cases of
tests/test_constrained_serving.py), every request sent to both servers on
the same weights (test-llama-tiny, fp32, max_seq_len 512) and the answers
compared: status codes equal and bodies equal but for ids and clocks
(sampled bodies, whose RNGs differ, in shape and validity only).

Routes: OpenAI `response_format` on /v1/chat/completions (json_schema over
a corpus, json_object, text, sampled, the malformed and unsupported 400s,
the refusal on /v1/completions), /generate's `constraint` (regex, choices,
schema, batched prompts, the malformed and compose 400s), over each
package's solo server; and the dense `--continuous` fleet's server, where
/generate and SSE chat completions with response_format stream from the
fleet's constrained slots."""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", max_seq_len=512)
# the keys that carry ids and clocks, never compared
VOLATILE = ("id", "created", "request_id", "trace_id", "timings", "time_taken",
            "tokens_per_sec", "ttft_s")
PORT_ONLY = ("token_ids", "prefill_chunks")

SCHEMAS = [
    {"type": "object",
     "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
     "required": ["name", "age"]},
    {"type": "object",
     "properties": {"color": {"enum": ["red", "green", "blue"]},
                    "ok": {"type": "boolean"}},
     "required": ["color", "ok"]},
    {"type": "object",
     "properties": {"items": {"type": "array", "items": {"type": "integer"}}},
     "required": ["items"]},
]


@pytest.fixture(scope="module")
def servers():
    """{"solo" | "fleet": {pkg: InferenceServer}}: each package's server over
    its solo engine, and over its dense continuous fleet."""
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(6))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    out = {"solo": {}, "fleet": {}}
    for kind in out:
        ecfg = dict(prefill_buckets=(64, 128))
        jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                         engine_cfg=JaxEngineConfig(**ecfg))
        teng = create_engine(tcfg, params=tparams, engine_cfg=EngineConfig(**ecfg),
                             device="cpu")
        for pkg, mod, cmod, eng in (("jax", JS, JC, jeng), ("port", TS, TC, teng)):
            cont = (cmod.ContinuousEngine(eng, n_slots=2, chunk_steps=8, max_queue=16)
                    if kind == "fleet" else None)
            out[kind][pkg] = mod.InferenceServer(eng, host="127.0.0.1", port=0,
                                                 max_tokens_cap=256, continuous=cont)
    for group in out.values():
        for srv in group.values():
            srv.start()
    yield out
    for group in out.values():
        for srv in group.values():
            srv.shutdown()


def _call(srv, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, path, body, kind="solo"):
    return {pkg: (lambda c, raw: (c, json.loads(raw)))(*_call(srv, path, body))
            for pkg, srv in servers[kind].items()}


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


def _equal(res, code=200):
    (jc, j), (tc, t) = res["jax"], res["port"]
    assert jc == tc == code, res
    # the port's fleet envelope also carries its own token_ids and
    # prefill_chunks
    assert _stable({k: v for k, v in t.items() if k not in PORT_ONLY}) == _stable(j)
    return t


def _content(body):
    return body["choices"][0]["message"]["content"]


@pytest.mark.parametrize("schema", SCHEMAS, ids=["name_age", "enum_bool", "array"])
def test_response_format_json_schema_round_trip(servers, schema):
    t = _equal(_both(servers, "/v1/chat/completions", {
        "model": MODEL, "messages": [{"role": "user", "content": "emit the object"}],
        "max_tokens": 200, "temperature": 0,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "obj", "schema": schema}},
    }))
    obj = json.loads(_content(t))  # MUST parse: the whole feature
    for k in schema.get("required", []):
        assert k in obj, (schema, obj)


def test_response_format_json_object(servers):
    t = _equal(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "give me json"}],
        "max_tokens": 200, "temperature": 0,
        "response_format": {"type": "json_object"},
    }))
    assert isinstance(json.loads(_content(t)), dict)


def test_response_format_sampled_round_trip(servers):
    res = _both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "emit"}], "max_tokens": 200,
        "temperature": 1.4, "seed": 5,
        "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMAS[0]}},
    })
    for pkg in ("jax", "port"):
        code, body = res[pkg]
        assert code == 200
        assert isinstance(json.loads(_content(body))["age"], int)
    assert set(res["port"][1]) == set(res["jax"][1])


def test_response_format_text_is_noop(servers):
    t = _equal(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
        "temperature": 0, "response_format": {"type": "text"},
    }))
    assert t["choices"][0]["finish_reason"] in ("stop", "length")


@pytest.mark.parametrize("rf", ["json", {"type": "yaml"}, {"type": "json_schema"},
                                {"type": "json_schema", "json_schema": {"schema": "x"}}],
                         ids=["str", "yaml", "no_schema", "bad_schema"])
def test_response_format_malformed_400(servers, rf):
    t = _equal(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "response_format": rf,
    }), code=400)
    assert t["error"]["param"] == "response_format"


def test_response_format_rejected_on_completions(servers):
    t = _equal(_both(servers, "/v1/completions", {
        "prompt": "x", "response_format": {"type": "json_object"},
    }), code=400)
    assert t["error"]["param"] == "response_format"


def test_unsupported_schema_is_400_not_500(servers):
    t = _equal(_both(servers, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}],
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": {"type": "tuple"}}},
    }), code=400)
    assert "invalid_request" in t["error"]["type"]


@pytest.mark.parametrize("con,check", [
    ({"regex": "(red|green|blue)"}, lambda t: re.fullmatch("red|green|blue", t)),
    ({"choices": ["on", "off"]}, lambda t: t in ("on", "off")),
    ({"json_schema": SCHEMAS[0]}, lambda t: isinstance(json.loads(t)["age"], int)),
], ids=["regex", "choices", "schema"])
def test_generate_constraint(servers, con, check):
    t = _equal(_both(servers, "/generate", {
        "prompt": "pick a color:", "chat": False, "greedy": True, "max_tokens": 200,
        "constraint": con,
    }))
    assert t["status"] == "success" and t["constrained"] is True
    assert check(t["response"]), t["response"]


def test_generate_constraint_batched_prompts(servers):
    t = _equal(_both(servers, "/generate", {
        "prompts": ["a:", "b:"], "chat": False, "greedy": True, "max_tokens": 20,
        "constraint": {"regex": "[0-9]{2,3}"},
    }))
    assert t["status"] == "success" and t["constrained"] is True
    for e in t["results"]:
        assert re.fullmatch(r"[0-9]{2,3}", e["response"]), e


@pytest.mark.parametrize("body", [
    {"prompt": "x", "constraint": "regex"},
    {"prompt": "x", "constraint": {"regex": ""}},
    {"prompt": "x", "constraint": {"bogus": 1}},
    {"prompt": "x", "constraint": {"regex": "a", "choices": ["b"]}},
    {"prompt": "x", "constraint": {"regex": "(unclosed"}},
    {"prompt": "x", "greedy": True, "speculative": True, "constraint": {"regex": "a+"}},
    {"prompt": "x", "num_beams": 4, "constraint": {"regex": "a+"}},
], ids=["not_object", "empty", "bogus", "two_kinds", "bad_regex", "speculative",
        "beams"])
@pytest.mark.parametrize("kind", ["solo", "fleet"])
def test_generate_constraint_400s(servers, body, kind):
    """Malformed specs and the compose refusals answer 400, never 500 or a
    not-ported error: on the solo server and on the fleet's (where a
    malformed spec goes solo, which answers it)."""
    t = _equal(_both(servers, "/generate", body, kind=kind), code=400)
    assert "ROADMAP" not in json.dumps(t)
    if "speculative" in body:
        assert "speculative" in t["error"]
    if "num_beams" in body:
        assert "num_beams" in t["error"]


def test_fleet_generate_and_sse_from_constrained_slots(servers):
    """The dense fleet's server: /generate with a constraint answers from
    the fleet's constrained slots, and an SSE chat completion with
    response_format streams deltas that join to valid JSON, equal to the
    JAX fleet's."""
    t = _equal(_both(servers, "/generate", {
        "prompt": "pick:", "chat": False, "greedy": True, "max_tokens": 30,
        "constraint": {"choices": ["alpha", "beta", "gamma"]},
    }, kind="fleet"))
    assert t["backend"] == "continuous" and t["constrained"] is True
    assert t["response"] in ("alpha", "beta", "gamma")
    texts = {}
    for pkg, srv in servers["fleet"].items():
        code, raw = _call(srv, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "emit"}], "max_tokens": 120,
            "temperature": 0, "stream": True,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": SCHEMAS[1]}},
        })
        assert code == 200
        lines = [ln[len(b"data: "):] for ln in raw.split(b"\n") if ln.startswith(b"data: ")]
        assert lines[-1] == b"[DONE]"
        chunks = [json.loads(ln) for ln in lines[:-1]]
        texts[pkg] = "".join(c["choices"][0]["delta"].get("content") or ""
                             for c in chunks)
        assert len(chunks) >= 2
    assert texts["port"] == texts["jax"]
    obj = json.loads(texts["port"])
    assert obj["color"] in ("red", "green", "blue") and isinstance(obj["ok"], bool)
