"""OpenAI-compatible serving surface: /v1/completions, /v1/chat/completions,
/v1/models.

A copy of the JAX package's serving/openai_api.py, which imports no jax
(the port copies such modules rather than import the JAX package). Only
this paragraph and the next sentence's source reference differ.

Beyond the source system (which serves only its own ad-hoc /generate
schema): any
OpenAI-SDK client can point its `base_url` at this server. This module is
pure translation — OpenAI request JSON -> engine kwargs, engine envelope ->
OpenAI response JSON (including SSE streaming chunks); it owns no model or
engine state, so the serving edge stays a single source of truth.

Mapping notes:
  * OpenAI has no top-k; the engine's top_k=0 disables that filter (the
    temperature/top_p semantics match the reference's sampling stack).
  * temperature == 0 means deterministic in OpenAI terms -> greedy argmax.
  * /v1/completions is raw continuation (no chat template);
    /v1/chat/completions renders the message list through the model
    family's template (engine/chat.format_chat_messages).
  * `response_format` on /v1/chat/completions ({"type": "json_object"} or
    {"type": "json_schema", "json_schema": {"schema": ...}}) compiles to a
    grammar constraint (constrain/) — the completion is guaranteed to
    parse as JSON (and validate against the schema subset) by traced
    token masking, not prompting.
  * Unsupported OpenAI params (best_of>1, suffix, echo outside the
    scoring form) are rejected with a 400 error object rather than
    silently ignored — silent acceptance would change sampling semantics
    behind the client's back.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Optional

# clients may omit max_tokens entirely; OpenAI's completions default
DEFAULT_MAX_TOKENS = 16


class OpenAIError(ValueError):
    """Carries an OpenAI-schema error body + HTTP status."""

    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error",
                 param: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.body = {
            "error": {
                "message": message,
                "type": err_type,
                "param": param,
                "code": None,
            }
        }


def error_for_envelope(result: dict) -> "OpenAIError":
    """Engine failure envelope -> OpenAI error object (same status codes as
    the native /generate route)."""
    et = result.get("error_type")
    msg = result.get("error", "internal error")
    if et == "invalid_request":
        return OpenAIError(msg)
    if et == "timeout":
        return OpenAIError(msg, status=503, err_type="timeout_error")
    if et == "deadline_exceeded":
        # the request's own deadline_ms budget expired: 504, and the
        # router/clients must NOT retry (the budget is spent wherever
        # the retry lands)
        return OpenAIError(msg, status=504, err_type="timeout_error")
    if et == "cancelled":
        # client went away (or explicitly cancelled): nobody is waiting
        # for this body; 499 (nginx convention) so logs/metrics can tell
        # it from server faults, and the router never re-dispatches it
        return OpenAIError(msg, status=499, err_type="cancelled")
    if et == "overloaded":
        return OpenAIError(msg, status=429, err_type="overloaded_error")
    return OpenAIError(msg, status=500, err_type="server_error")


def _reject_unsupported(data: dict, *, chat: bool):
    def as_num(name, default, cast):
        v = data.get(name)
        if v is None:
            return default
        try:
            return cast(v)
        except (TypeError, ValueError):
            raise OpenAIError(
                f"{name} must be a number, got {v!r}", param=name
            ) from None

    n = as_num("n", 1, int)
    if not 1 <= n <= 16:
        raise OpenAIError("n must be between 1 and 16", param="n")
    if not chat and as_num("best_of", 1, int) != 1:
        raise OpenAIError("best_of > 1 is not supported", param="best_of")
    if not chat and data.get("echo"):
        # echo is supported ONLY in the scoring form (echo + logprobs +
        # an EXPLICIT max_tokens 0 — the lm-eval loglikelihood pattern).
        # An omitted max_tokens means "generate the default and echo",
        # which is not supported — reject rather than silently score.
        lp = data.get("logprobs")
        mt = as_num("max_tokens", None, int)
        if mt is None:
            mt = as_num("max_completion_tokens", None, int)
        if lp is None or lp is False or mt != 0:
            raise OpenAIError(
                "echo is only supported for scoring: echo=true with "
                "logprobs set and an explicit max_tokens=0", param="echo",
            )
    if not chat and data.get("suffix"):
        raise OpenAIError("suffix is not supported", param="suffix")
    for p in ("frequency_penalty", "presence_penalty"):
        v = as_num(p, 0.0, float)
        if not -2.0 <= v <= 2.0:
            # the OpenAI-documented range; values beyond it are almost
            # always a units mistake (e.g. a repetition_penalty sent here)
            raise OpenAIError(
                f"{p} must be between -2.0 and 2.0", param=p,
            )
    return n


def _common_kwargs(data: dict, cap: int, default_max: int = None) -> dict:
    """Shared OpenAI -> engine parameter translation. default_max: budget
    when the client omits max_tokens (legacy completions default is 16;
    chat defaults to the server cap — OpenAI's chat default is 'up to the
    context limit', and 16-token chat replies surprise every SDK user)."""
    if default_max is None:
        default_max = DEFAULT_MAX_TOKENS
    try:
        # explicit nulls fall through to the next source (clients migrating
        # to max_completion_tokens often send "max_tokens": null alongside)
        max_tokens = data.get("max_tokens")
        if max_tokens is None:
            max_tokens = data.get("max_completion_tokens")
        max_tokens = default_max if max_tokens is None else int(max_tokens)
        t = data.get("temperature")
        temperature = 1.0 if t is None else float(t)  # OpenAI: null = default
        tp = data.get("top_p")
        top_p = 1.0 if tp is None else float(tp)
        seed = data.get("seed")
        seed = int(seed) if seed is not None else None
        rep = float(data.get("repetition_penalty", 1.0))  # extension
        min_p = float(data.get("min_p", 0.0))  # extension
        freq = float(data.get("frequency_penalty") or 0.0)
        pres = float(data.get("presence_penalty") or 0.0)
    except (TypeError, ValueError) as e:
        raise OpenAIError(f"bad parameter: {e}") from None
    if temperature < 0:
        raise OpenAIError("temperature must be >= 0", param="temperature")
    if max_tokens < 1:
        # OpenAI rejects a zero/negative budget; the engine would silently
        # re-clamp it to 1 and bill a token the client asked not to pay for
        raise OpenAIError("max_tokens must be >= 1", param="max_tokens")
    kwargs = dict(
        max_tokens=min(max_tokens, cap),
        temperature=temperature if temperature > 0 else 1.0,
        top_k=0,  # OpenAI has no top-k filter
        top_p=top_p,
        greedy=temperature == 0.0,
        chat=False,  # chat routes pre-render the template themselves
        seed=int(seed) if seed is not None else None,
        min_p=min_p,
        repetition_penalty=rep,
        frequency_penalty=freq,
        presence_penalty=pres,
    )
    slo = data.get("slo_class")
    if slo is not None:
        # extension field (engine/scheduler.py SLO classes): admission
        # priority / prefill-budget share / shed policy on the continuous
        # fleet. The server validates the name against the configured
        # classes (unknown -> 400); here only the shape is checked.
        if not isinstance(slo, str):
            raise OpenAIError("slo_class must be a string",
                              param="slo_class")
        kwargs["slo_class"] = slo
    tenant = data.get("tenant")
    if tenant is not None:
        # extension field (multi-tenant serving): the fairness /
        # queue-quota identity on the continuous fleet — tenant-weighted
        # token apportionment within each SLO class, per-tenant queue
        # quota shed, per-tenant TTFT/TPOT EWMAs. Free-form label; no
        # server-side registry to validate against.
        if not isinstance(tenant, str) or not tenant:
            raise OpenAIError("tenant must be a non-empty string",
                              param="tenant")
        kwargs["tenant"] = tenant
    dl = data.get("deadline_ms")
    if dl is not None:
        # extension field: end-to-end deadline in milliseconds. Expiry
        # anywhere along the pipeline (queued, mid-prefill, mid-decode)
        # fails the request with a deadline_exceeded envelope (HTTP 504)
        # and frees its resources at the next launch boundary; the
        # router forwards the REMAINING budget via X-Request-Deadline-Ms.
        try:
            dl = float(dl)
        except (TypeError, ValueError):
            raise OpenAIError("deadline_ms must be a number",
                              param="deadline_ms") from None
        if dl <= 0:
            raise OpenAIError("deadline_ms must be > 0",
                              param="deadline_ms")
        kwargs["deadline_ms"] = dl
    stop = data.get("stop")
    if stop is not None:
        if isinstance(stop, str):
            stop = [stop]
        if not (isinstance(stop, list) and all(isinstance(s, str) for s in stop)):
            raise OpenAIError("stop must be a string or list of strings",
                              param="stop")
        if stop:
            kwargs["stop"] = stop
    lb = data.get("logit_bias")
    if lb:
        if not isinstance(lb, dict):
            raise OpenAIError("logit_bias must be an object of "
                              "token_id -> bias", param="logit_bias")
        try:
            lb = {int(k): float(v) for k, v in lb.items()}
        except (TypeError, ValueError):
            raise OpenAIError("logit_bias keys must be token ids and "
                              "values numbers", param="logit_bias") from None
        if any(not -100.0 <= v <= 100.0 for v in lb.values()):
            raise OpenAIError("logit_bias values must be in [-100, 100]",
                              param="logit_bias")
        kwargs["logit_bias"] = lb
    return kwargs


def _response_format_constraint(rf) -> Optional[dict]:
    """OpenAI `response_format` -> the engine's constraint spec, or None
    for type "text". Malformed objects are 400s — a silently-ignored
    response_format would hand the client unvalidated output under a
    guaranteed-JSON contract, the worst possible failure mode."""
    if not isinstance(rf, dict):
        raise OpenAIError("response_format must be an object",
                          param="response_format")
    t = rf.get("type")
    if t in (None, "text"):
        return None
    if t == "json_object":
        return {"json_object": True}
    if t == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            raise OpenAIError(
                "response_format.json_schema must be an object with a "
                "'schema' member", param="response_format",
            )
        schema = js.get("schema")
        if not isinstance(schema, dict):
            raise OpenAIError(
                "response_format.json_schema.schema must be a schema "
                "object", param="response_format",
            )
        return {"json_schema": schema}
    raise OpenAIError(f"unsupported response_format type {t!r}",
                      param="response_format")


def _check_n(n: int, prompts: list, kwargs: dict, stream: bool):
    """n > 1 serves as a ragged fleet of the same prompt — combinations
    the fleet cannot honor are rejected rather than silently degraded."""
    if n == 1:
        return
    if len(prompts) > 1:
        raise OpenAIError("n > 1 requires a single prompt", param="n")
    if stream:
        raise OpenAIError("n > 1 cannot be streamed", param="n")
    if kwargs.get("logprobs"):
        raise OpenAIError("n > 1 with logprobs is not supported", param="n")
    if kwargs.get("logit_bias"):
        raise OpenAIError("n > 1 with logit_bias is not supported", param="n")


def parse_completion(data: dict, cap: int):
    """POST /v1/completions body -> (prompts: list[str], kwargs, meta)."""
    n = _reject_unsupported(data, chat=False)
    prompt = data.get("prompt")
    if prompt is None:
        raise OpenAIError("you must provide a prompt", param="prompt")
    prompts = [prompt] if isinstance(prompt, str) else prompt
    if not (isinstance(prompts, list) and prompts
            and all(isinstance(p, str) and p for p in prompts)):
        raise OpenAIError(
            "prompt must be a non-empty string or list of non-empty strings",
            param="prompt",
        )
    if data.get("response_format") is not None:
        # structured output is a chat-completions feature (matching the
        # OpenAI surface); silent acceptance here would change sampling
        # semantics behind the client's back
        raise OpenAIError(
            "response_format is only supported on /v1/chat/completions",
            param="response_format",
        )
    meta = {"stream": bool(data.get("stream", False)), "n": n,
            "echo_score": bool(data.get("echo"))}
    if meta["echo_score"]:
        if meta["stream"] or n != 1 or len(prompts) != 1:
            raise OpenAIError(
                "echo scoring takes a single prompt, n=1, no streaming",
                param="echo",
            )
        # legacy logprobs int = top-N alternatives per position (lm-eval
        # reads them for is_greedy); OpenAI caps N at 5
        lp = data.get("logprobs")
        meta["score_top_n"] = min(int(lp), 5) if lp is not True else 0
        return prompts, {"max_tokens": 0}, meta
    kwargs = _common_kwargs(data, cap)
    lp = data.get("logprobs")
    if lp is not None and lp is not False:
        # legacy completions logprobs is an int (top-N); only the chosen
        # tokens' logprobs are produced here (top_logprobs omitted) — and
        # logprobs: 0 still means "return the chosen tokens' logprobs"
        if meta["stream"]:
            raise OpenAIError(
                "logprobs are not available on streamed responses",
                param="logprobs",
            )
        kwargs["logprobs"] = True
    _check_n(n, prompts, kwargs, meta["stream"])
    return prompts, kwargs, meta


def parse_chat(data: dict, render, cap: int):
    """POST /v1/chat/completions body -> (raw_prompt, kwargs, meta).

    render: message-list -> prompt string (the engine's render_chat, so
    cfg.chat_template — including "hf" jinja templates — applies here
    identically to the native route)."""
    n = _reject_unsupported(data, chat=True)
    messages = data.get("messages")
    if not (isinstance(messages, list) and messages
            and all(isinstance(m, dict) for m in messages)):
        raise OpenAIError("messages must be a non-empty list of objects",
                          param="messages")
    try:
        prompt = render(messages)
    except ValueError as e:
        raise OpenAIError(str(e), param="messages") from None
    kwargs = _common_kwargs(data, cap, default_max=cap)
    rf = data.get("response_format")
    if rf is not None:
        con = _response_format_constraint(rf)
        if con is not None:
            kwargs["constraint"] = con
    meta = {"stream": bool(data.get("stream", False)), "n": n}
    if data.get("top_logprobs"):
        # alternatives-per-position are not produced; silent empty lists
        # would masquerade as "no alternatives existed"
        raise OpenAIError("top_logprobs is not supported",
                          param="top_logprobs")
    if data.get("logprobs"):
        if meta["stream"]:
            raise OpenAIError(
                "logprobs are not available on streamed responses",
                param="logprobs",
            )
        kwargs["logprobs"] = True
    _check_n(n, [prompt], kwargs, meta["stream"])
    return prompt, kwargs, meta


def _finish_reason(entry: dict, requested_max: int) -> str:
    # the engine reports why generation ended (judged against its CLAMPED
    # budget, which this layer cannot reconstruct); the request-shaped
    # fallback covers older envelopes without the key
    fr = entry.get("finish_reason")
    if fr in ("stop", "length"):
        return fr
    if entry.get("stopped"):
        return "stop"
    return "length" if entry.get("tokens_generated", 0) >= requested_max else "stop"


def _usage(entries: list, prompt_once: bool = False) -> dict:
    # prompt_once: n>1 choices share one prompt — OpenAI bills it once
    if prompt_once and entries:
        pt = entries[0].get("prompt_tokens", 0)
    else:
        pt = sum(e.get("prompt_tokens", 0) for e in entries)
    ct = sum(e.get("tokens_generated", 0) for e in entries)
    return {"prompt_tokens": pt, "completion_tokens": ct,
            "total_tokens": pt + ct}


def _logprobs_obj(entry: dict) -> Optional[dict]:
    lps = entry.get("token_logprobs")
    if lps is None:
        return None
    return {"token_logprobs": lps,
            "tokens": entry.get("token_strings"),
            "top_logprobs": None,
            "text_offset": None}


def _observability_fields(request_id, timings, trace_id=None) -> dict:
    """Extension keys carried on every non-streaming response: the
    request_id (also echoed as the X-Request-Id header), the fleet
    trace_id (also the X-Trace-Id header — fetch the assembled tree at
    GET /debug/traces/{trace_id}), and the trace's stage breakdown.
    Extra top-level keys are OpenAI-SDK-safe (clients ignore unknown
    fields)."""
    out = {}
    if request_id:
        out["request_id"] = request_id
    if trace_id:
        out["trace_id"] = trace_id
    if timings:
        out["timings"] = timings
    return out


def completion_response(entries: list, model: str, kwargs: dict,
                        prompt_once: bool = False,
                        request_id: Optional[str] = None,
                        timings: Optional[dict] = None,
                        kv_extra: Optional[dict] = None,
                        trace_id: Optional[str] = None) -> dict:
    """Engine success envelope(s) -> one text_completion response.

    kv_extra: KV-fabric extension fields (kv_digests / kv_fabric_blocks /
    prefill_only) lifted from the engine envelope — OpenAI clients ignore
    unknown top-level keys, while the router reads them to learn
    digest->replica residency and score prefill->decode handoffs on the
    OpenAI routes exactly as on /generate (handoff-transparent
    streaming: phase 1 is forced non-streamed server-side, phase 2
    streams from the decode replica through the unchanged SSE path)."""
    choices = []
    for i, e in enumerate(entries):
        c = {
            "index": i,
            "text": e.get("response", ""),
            "finish_reason": _finish_reason(e, kwargs["max_tokens"]),
        }
        lp = _logprobs_obj(e)
        if lp is not None:
            c["logprobs"] = lp
        choices.append(c)
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(entries, prompt_once),
        **_observability_fields(request_id, timings, trace_id),
        **(kv_extra or {}),
    }


def chat_response(entries: list, model: str, kwargs: dict,
                  prompt_once: bool = False,
                  request_id: Optional[str] = None,
                  timings: Optional[dict] = None,
                  kv_extra: Optional[dict] = None,
                  trace_id: Optional[str] = None) -> dict:
    choices = []
    for i, entry in enumerate(entries):
        choice = {
            "index": i,
            "message": {"role": "assistant",
                        "content": entry.get("response", "")},
            "finish_reason": _finish_reason(entry, kwargs["max_tokens"]),
        }
        lp = _logprobs_obj(entry)
        if lp is not None:
            # chat schema nests token logprobs under content
            toks = lp["tokens"] or [""] * len(lp["token_logprobs"] or [])
            choice["logprobs"] = {
                "content": [
                    {"token": t, "logprob": x, "top_logprobs": []}
                    for t, x in zip(toks, lp["token_logprobs"] or [])
                ]
            }
        choices.append(choice)
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(entries, prompt_once),
        **_observability_fields(request_id, timings, trace_id),
        **(kv_extra or {}),
    }


def echo_score_response(result: dict, model: str) -> dict:
    """engine.score envelope -> OpenAI echoed text_completion (the
    loglikelihood-scoring reply: text = the prompt, logprobs over every
    prompt token, first entry None)."""
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": result["prompt"],
            "finish_reason": "length",
            "logprobs": {
                "tokens": result["token_strings"],
                "token_logprobs": result["token_logprobs"],
                # [None, {token: lp, ...}, ...] when top-N was requested
                # (lm-eval reads these for is_greedy)
                "top_logprobs": result.get("top_logprobs"),
                "text_offset": None,
            },
        }],
        "usage": {
            "prompt_tokens": result["prompt_tokens"],
            "completion_tokens": 0,
            "total_tokens": result["prompt_tokens"],
        },
    }


def models_response(model: str, created: int, adapters=()) -> dict:
    """The base model plus every registered runtime LoRA adapter —
    adapters are addressable as `model` on the OpenAI routes, so they
    must be discoverable where SDK clients look for model ids. `root`
    marks which base weights an adapter entry rides (vLLM convention)."""
    data = [{
        "id": model,
        "object": "model",
        "created": created,
        "owned_by": "distributed_llm_inference_tpu",
    }]
    for name in adapters:
        data.append({
            "id": name,
            "object": "model",
            "created": created,
            "owned_by": "distributed_llm_inference_tpu",
            "root": model,
        })
    return {"object": "list", "data": data}


# -- SSE streaming ----------------------------------------------------------


def sse(obj: Any) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"


def stream_events(events, model: str, kwargs: dict, chat: bool):
    """Adapt the continuous engine's NDJSON event stream ({"delta": ...}*,
    then the final envelope with done: true) into OpenAI SSE chunk dicts.

    Yields (bytes, final_envelope_or_None); the caller writes the bytes and
    can inspect the final envelope for error status. A failed request
    yields an OpenAI error payload as the terminal SSE event (the HTTP 200
    is already on the wire — OpenAI streams report late errors in-band).
    """
    rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
           else f"cmpl-{uuid.uuid4().hex[:24]}")
    obj = "chat.completion.chunk" if chat else "text_completion"
    created = int(time.time())

    def chunk(delta_text: Optional[str], finish: Optional[str]) -> dict:
        if chat:
            delta = {} if delta_text is None else {"content": delta_text}
            choice = {"index": 0, "delta": delta, "finish_reason": finish}
        else:
            choice = {"index": 0, "text": delta_text or "",
                      "finish_reason": finish}
        return {"id": rid, "object": obj, "created": created, "model": model,
                "choices": [choice]}

    if chat:
        yield sse(chunk(None, None) | {
            "choices": [{"index": 0, "delta": {"role": "assistant"},
                         "finish_reason": None}],
        }), None
    final = None
    streamed = ""
    for ev in events:
        if ev.get("done"):
            final = ev
            break
        d = ev.get("delta")
        if d:
            streamed += d
            yield sse(chunk(d, None)), None
    if final is None or final.get("status") != "success":
        err = error_for_envelope(final or {"error": "stream ended early"})
        yield sse(err.body), final
        yield SSE_DONE, final
        return
    # a request the continuous engine served via its solo fallback (seeded /
    # logprobs / speculative) emits no per-chunk deltas — only the final
    # envelope carries text. Flush whatever the deltas didn't cover so the
    # client always receives the full completion.
    response = final.get("response", "")
    if response.startswith(streamed) and len(response) > len(streamed):
        yield sse(chunk(response[len(streamed):], None)), None
    out = chunk(None, _finish_reason(final, kwargs["max_tokens"]))
    out["usage"] = _usage([final])
    yield sse(out), final
    yield SSE_DONE, final
