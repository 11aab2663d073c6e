"""PyTorch port vs JAX package: token streaming and cancellation on the
continuous paged fleet, and the server's NDJSON route and flags.

The cases of tests/test_continuous.py (`test_stream_*`,
`test_cancel_while_queued`), tests/test_server.py (`test_stream_*`),
tests/test_preemption.py (`test_stream_close_cancels_and_frees`,
`test_http_sse_disconnect_cancels`) and tests/test_faults.py
(`test_streaming_across_crash_reassembles_exactly`), each driven through
the JAX ContinuousEngine and the port's on the CPU with the same weights
(test-llama-tiny, fp32, no EOS, params from the reference's init_params
carried over by models/bridge.py), both with the block-prefix cache and
the KV shadow. Outputs are compared, never a test's claim: the joined
deltas equal the final response, the greedy ids (the IdTokenizer spells
them) equal the JAX fleet's, the byte tokenizer's deltas (whose U+FFFD
hold-back random weights exercise at every step) equal the JAX fleet's
delta for delta, cancel envelopes and dli_cancelled_total match, and
every pool block comes back. The stream also stays right across a swap
preemption, a crash restart, a prefix hit, a fabric pull and verify
rows; the server's repaired flags parse as the JAX server's do."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu.utils import faults as jax_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import faults as port_faults  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
ENGINE = dict(prefill_buckets=(32, 64), prefix_cache_entries=4)
# tests/test_preemption.py's fleet: 9 usable blocks of 8 tokens cannot hold
# the long request A (35 ids + 24 tokens) and B (35 ids + 10) at once
FLEET = dict(n_slots=2, chunk_steps=2, slot_max_seq=64, kv_pool_blocks=10,
             kv_block_size=8, restart_backoff_s=0.01)
PROMPT_A = "the quick brown fox jumps over the"
PROMPT_B = "pack my box with five dozen liquor"
PROMPTS = ["a lazy dog while the band plays on", "jumps over", "hello"]
KW = dict(max_tokens=16, greedy=True, chat=False)
PKGS = ("jax", "port")


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id, so that a
    JAX fleet's response pins its exact token ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(autouse=True)
def _always_disarm():
    jax_faults.disarm()
    port_faults.disarm()
    yield
    jax_faults.disarm()
    port_faults.disarm()


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    return params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")


def _engine(weights, pkg, tok, **ecfg):
    params, tparams = weights
    ecfg = {**ENGINE, **ecfg}
    if pkg == "jax":
        return JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                         engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
    return create_engine(get_model_config(MODEL, **OVERRIDES), params=tparams,
                         engine_cfg=EngineConfig(**ecfg), tokenizer=tok, device="cpu")


def _fleet(weights, pkg, tok=None, **kw):
    ecfg = {k: kw.pop(k) for k in list(kw) if k not in FLEET}
    eng = _engine(weights, pkg, tok or IdTokenizer(), **ecfg)
    mod = JC if pkg == "jax" else TC
    return mod.ContinuousEngine(eng, **{**FLEET, **kw})


@pytest.fixture(scope="module")
def fleets(weights):
    """{pkg: fleet} with the IdTokenizer: responses spell the greedy ids."""
    out = {pkg: _fleet(weights, pkg) for pkg in PKGS}
    yield out
    for f in out.values():
        f.close()


@pytest.fixture(scope="module")
def want(fleets):
    """The JAX fleet's greedy ids of every prompt here, served alone."""
    return {p: _ids(fleets["jax"].submit(p, **KW))
            for p in PROMPTS + [PROMPT_A, PROMPT_B]}


def _ids(r) -> list:
    return [int(t) for t in r["response"].split()]


def _wait(pred, timeout=30.0, what="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _pool_clean(cont) -> bool:
    st = cont.stats()["paged"]
    return st["free_blocks"] + st["cached_blocks"] == st["pool_blocks"] - 1


def _cancelled(cont, cause="disconnect") -> float:
    return cont.engine.metrics.get("dli_cancelled_total").labels(cause=cause).value


def _hold_fetch(fm, cont, prompt):
    """Arm a rule of the fleet's own fault module that never fires: at the
    first fetch of a launch carrying `prompt` once that request holds a
    decoded token, it sets `held` and waits (the worker thread) until
    `release` is set. Returns the rule."""

    class Hold(fm.FaultRule):
        def should_fire(self, tag):
            if (prompt in tag and not self.release.is_set()
                    and any(r is not None and r.prompt == prompt and r.tokens
                            for r in cont._assignment)):
                self.held.set()
                self.release.wait(60)
            return False

    rule = Hold("fetch")
    rule.held, rule.release = threading.Event(), threading.Event()
    fm.arm([rule])
    return rule


def _split(events):
    """(deltas, final) of a finished stream, after checking its shape."""
    *deltas, final = events
    assert final["done"] is True and all("delta" in e and "done" not in e for e in deltas)
    return [e["delta"] for e in deltas], final


# -- the fleet's stream() ---------------------------------------------------


def test_stream_deltas_reassemble_full_response(weights):
    """The byte tokenizer on random weights: most steps end in a partial
    UTF-8 sequence, held back. Each package's deltas join to its final
    response, equal to the same body served unstreamed, and the two
    packages stream the same deltas, delta for delta."""
    seen = {}
    for pkg in PKGS:
        cont = _fleet(weights, pkg, ByteTokenizer())
        try:
            events = list(cont.stream(PROMPTS[0], max_tokens=24, greedy=True, chat=False))
            plain = cont.submit(PROMPTS[0], max_tokens=24, greedy=True, chat=False)
        finally:
            cont.close()
        deltas, final = _split(events)
        assert final["status"] == "success", final
        assert "".join(deltas) == final["response"] == plain["response"]
        assert [e["tokens_so_far"] for e in events[:-1]] == sorted(
            e["tokens_so_far"] for e in events[:-1])
        seen[pkg] = (deltas, final["response"], [e["tokens_so_far"] for e in events[:-1]])
    assert seen["port"] == seen["jax"]
    assert len(seen["port"][0]) >= 2, seen["port"]  # incremental, not one blob
    assert "�" in seen["port"][1]  # the hold-back was exercised


def test_stream_holds_back_a_stop_string(fleets, want):
    """A textual stop that spans launches: nothing past the truncation is
    ever streamed, and the final flush emits exactly the response."""
    ids = want[PROMPTS[0]]
    stop = f" {ids[6]} {ids[7]}"
    seen = {}
    for pkg, cont in fleets.items():
        deltas, final = _split(list(cont.stream(PROMPTS[0], stop=[stop], **KW)))
        assert final["status"] == "success" and final["finish_reason"] == "stop", final
        assert "".join(deltas) == final["response"]
        seen[pkg] = (deltas, final["response"])
    assert seen["port"] == seen["jax"]
    cut = " ".join(str(i) for i in ids)
    assert seen["port"][1] == cut[: cut.find(stop)]


def test_stream_concurrent_with_submit(fleets, want):
    """A stream and a blocking request share the fleet; both carry the
    JAX fleet's ids of their run alone."""
    for pkg, cont in fleets.items():
        out = {}
        t = threading.Thread(target=lambda: out.update(b=cont.submit(PROMPTS[1], **KW)))
        t.start()
        deltas, final = _split(list(cont.stream(PROMPTS[2], **KW)))
        t.join(timeout=120)
        assert final["status"] == "success" and out["b"]["status"] == "success", pkg
        assert "".join(deltas) == final["response"]
        assert _ids(final) == want[PROMPTS[2]] and _ids(out["b"]) == want[PROMPTS[1]], pkg
        if pkg == "port":
            assert final["token_ids"] == want[PROMPTS[2]]


def test_stream_seeded_falls_back_single_event(weights, fleets):
    """A seeded request runs solo: one final envelope, no delta. (The
    port's solo engine refuses a request when the prefix cache is on, so
    its fleet here has none.)"""
    port = _fleet(weights, "port", prefix_cache_entries=0)
    try:
        for pkg, cont in (("jax", fleets["jax"]), ("port", port)):
            events = list(cont.stream("seeded", max_tokens=5, seed=3, chat=False))
            assert len(events) == 1, (pkg, events)
            assert events[0]["status"] == "success" and events[0]["done"] is True, pkg
            assert "continuous" not in events[0], pkg
    finally:
        port.close()


def test_stream_close_cancels_and_frees(fleets, want):
    """Abandoning a stream after its first delta cancels the request: the
    slot and every block come back long before its budget, the cancel is
    counted as a disconnect, and the request admitted next gets its ids
    of a run alone."""
    for pkg, cont in fleets.items():
        before = _cancelled(cont)
        gen = cont.stream(PROMPT_A, max_tokens=2000, greedy=True, chat=False)
        first = next(gen)
        assert "delta" in first, (pkg, first)
        gen.close()
        _wait(lambda: cont.stats()["occupied"] == 0 and _pool_clean(cont),
              what=f"{pkg}: slot and blocks freed after the stream closed")
        assert _cancelled(cont) == before + 1, pkg
        assert _ids(cont.submit(PROMPT_B, **KW)) == want[PROMPT_B], pkg


def test_cancel_while_queued(fleets):
    """cancel() of a request still queued dequeues it at once with the JAX
    fleet's cancelled envelope and count. The fleet's lock is held across
    the enqueue and the cancel, so the worker cannot admit it between."""
    seen = {}
    for pkg, cont in fleets.items():
        mod = JC if pkg == "jax" else TC
        req = mod._Request("queued victim", dict(max_tokens=4, greedy=True, chat=False))
        before = _cancelled(cont)
        with cont._cv:
            assert cont._enqueue(req) is None
            cont.cancel(req)
            assert req not in cont._queue
        assert req.done.is_set()
        seen[pkg] = {k: req.result[k] for k in ("error", "status", "error_type")}
        assert _cancelled(cont) == before + 1, pkg
        assert cont.stats()["queued"] == 0
    assert seen["port"] == seen["jax"] == {
        "error": "Error: request cancelled", "status": "failed", "error_type": "cancelled"}


def test_streaming_across_crash_reassembles_exactly(fleets, want):
    """A crash mid-stream: no delta streamed before it is streamed again,
    and the joined deltas are the fault-free run's ids."""
    for pkg, cont in fleets.items():
        fm = jax_faults if pkg == "jax" else port_faults
        restarts = cont.restarts_total
        fm.arm([fm.FaultRule("fetch", "transient", on_call=3)])
        try:
            deltas, final = _split(list(cont.stream(PROMPTS[0], **KW)))
        finally:
            fm.disarm()
        assert final["status"] == "success", (pkg, final)
        assert "".join(deltas) == final["response"]
        assert _ids(final) == want[PROMPTS[0]], pkg
        assert cont.restarts_total == restarts + 1, pkg
        _wait(lambda: _pool_clean(cont), what=f"{pkg}: pool clean after the crash")


def test_stream_across_swap_preemption(fleets, want):
    """A long stream preempted ("swap", over the KV shadow) by a request
    the pool cannot also hold: its deltas still join to its response,
    whose ids are its run alone, and B's are B's."""
    seen = {}
    for pkg, cont in fleets.items():
        events, out = [], {}
        preempted = cont.stats()["preemption"]["preempted_total"]
        # the worker is held at a fetch of A's, once A decodes, until B is
        # queued: A cannot finish before B's admission preempts it
        hold = _hold_fetch(jax_faults if pkg == "jax" else port_faults, cont, PROMPT_A)

        def streamer():
            events.extend(cont.stream(PROMPT_A, max_tokens=24, greedy=True, chat=False))

        ta = threading.Thread(target=streamer)
        tb = threading.Thread(target=lambda: out.update(b=cont.submit(PROMPT_B, **KW)))
        ta.start()
        try:
            assert hold.held.wait(60), f"{pkg}: A never decoded"
            _wait(lambda: len(events) >= 1, what=f"{pkg}: A streaming")
            tb.start()
            _wait(lambda: cont.stats()["queued"] >= 1, what=f"{pkg}: B queued")
        finally:
            # released and disarmed whatever failed above: an armed rule
            # would hold a later test's fleet in this worker process
            hold.release.set()
            ta.join(timeout=120)
            if tb.ident is not None:
                tb.join(timeout=120)
            port_faults.disarm()
            jax_faults.disarm()
        deltas, final = _split(events)
        assert final["status"] == "success" and final.get("preempted", 0) >= 1, (pkg, final)
        assert cont.stats()["preemption"]["preempted_total"] > preempted
        assert "".join(deltas) == final["response"]
        assert len(_ids(final)) == 24 and _ids(final)[:16] == want[PROMPT_A], pkg
        assert _ids(out["b"]) == want[PROMPT_B], pkg
        seen[pkg] = _ids(final)
        _wait(lambda: _pool_clean(cont), what=f"{pkg}: pool clean after the pair")
    assert seen["port"] == seen["jax"]


def test_stream_prefix_hit(fleets, want):
    """The same prompt streamed twice: the second maps the first's cached
    blocks (the same depth in both packages) and streams the same ids."""
    prompt = PROMPTS[0] + " and the band plays"
    seen = {}
    for pkg, cont in fleets.items():
        runs = []
        for _ in range(2):
            deltas, final = _split(list(cont.stream(prompt, **KW)))
            assert "".join(deltas) == final["response"]
            runs.append(final)
        assert _ids(runs[0]) == _ids(runs[1])
        seen[pkg] = (_ids(runs[1]), runs[1].get("prefix_cached_tokens"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] >= FLEET["kv_block_size"]


def test_stream_verify_rows_land_several_tokens(weights, want):
    """Verify rows: the target as its own draft accepts every draft, so a
    fetched step lands several tokens; the stream still joins to the
    response and carries the JAX fleet's plain ids."""
    _, tparams = weights
    # the draft is attached before the fleet builds its draft pool
    eng = _engine(weights, "port", IdTokenizer(), spec_draft_model=MODEL,
                  spec_device_meta=False)
    eng.set_draft(get_model_config(MODEL, **OVERRIDES), tparams)
    cont = TC.ContinuousEngine(eng, **{**FLEET, "slot_max_seq": 128, "kv_pool_blocks": 40})
    try:
        events = list(cont.stream(PROMPTS[0], speculative=True, **KW))
    finally:
        cont.close()
    deltas, final = _split(events)
    assert final["status"] == "success" and final["spec_accepted"] > 0, final
    assert "".join(deltas) == final["response"]
    assert final["token_ids"] == want[PROMPTS[0]]
    steps = np.diff([0] + [e["tokens_so_far"] for e in events[:-1]])
    assert steps.max() > 1, steps  # a verify row landed several tokens at once


def test_stream_over_a_fabric_pull(weights, want):
    """A hinted stream: the chain pulled from a holder replica over HTTP
    (hit), and a dead peer (a counted miss): both stream the cold ids."""
    hold = _fleet(weights, "port")
    server = TS.InferenceServer(hold.engine, host="127.0.0.1", port=0, continuous=hold)
    server.start()
    try:
        r = hold.submit(PROMPT_A, **KW)
        hold._shadow.flush(timeout_s=10.0)
        digest = r["kv_digests"][-1]
        for peer, hit in ((f"http://127.0.0.1:{server.port}", True),
                          ("http://127.0.0.1:9", False)):
            pull = _fleet(weights, "port")
            try:
                events = list(pull.stream(PROMPT_A, kv_hint={"peer": peer, "digest": digest},
                                          **KW))
                fab = pull.stats()["kv_fabric"]
            finally:
                pull.close()
            deltas, final = _split(events)
            assert "".join(deltas) == final["response"]
            assert final["token_ids"] == want[PROMPT_A], peer
            assert (fab["hits"], fab["misses"]) == ((1, 0) if hit else (0, 1)), fab
            assert bool(final.get("kv_fabric_blocks")) == hit, final
    finally:
        server.shutdown()


# -- the server's NDJSON route ----------------------------------------------


@pytest.fixture(scope="module")
def servers(fleets):
    """{pkg: port number} of each package's server over its fleet."""
    out, ports = [], {}
    for pkg, cont in fleets.items():
        mod = JS if pkg == "jax" else TS
        srv = mod.InferenceServer(cont.engine, host="127.0.0.1", port=0,
                                  max_tokens_cap=4096, continuous=cont)
        srv.start()
        out.append(srv)
        ports[pkg] = srv.port
    yield ports
    for srv in out:
        srv.httpd.shutdown()
        srv.httpd.server_close()


def _post(port, body, headers=None, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    return urllib.request.urlopen(req, timeout=120)


def test_stream_over_http_ndjson(servers, want):
    """`"stream": true` answers application/x-ndjson with the request and
    trace ids; the deltas join to the final envelope, whose ids are the
    JAX server's."""
    seen = {}
    for pkg, port in servers.items():
        with _post(port, {"prompt": PROMPTS[1], "stream": True, **KW},
                   headers={"X-Request-Id": "stream-1"}) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            assert r.headers["X-Request-Id"] == "stream-1" and r.headers["X-Trace-Id"]
            events = [json.loads(line) for line in r]
        deltas, final = _split(events)
        assert final["status"] == "success" and final["request_id"] == "stream-1"
        assert "".join(deltas) == final["response"]
        seen[pkg] = _ids(final)
    assert seen["port"] == seen["jax"] == want[PROMPTS[1]]


@pytest.mark.parametrize("body", [{"prompt": "x", "stream": True},
                                  {"prompts": ["x", "y"], "stream": True}],
                         ids=["solo_server", "prompts_list"])
def test_stream_requires_continuous(weights, servers, body):
    """Streaming needs the fleet and one prompt: 400 from both servers."""
    for pkg in PKGS:
        mod = JS if pkg == "jax" else TS
        if "prompt" in body:  # a server without --continuous
            srv = mod.InferenceServer(_engine(weights, pkg, IdTokenizer()),
                                      host="127.0.0.1", port=0)
            srv.start()
            port = srv.port
        else:
            srv, port = None, servers[pkg]
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, body)
            assert ei.value.code == 400
            assert "continuous" in json.loads(ei.value.read())["error"], pkg
        finally:
            if srv is not None:
                srv.httpd.shutdown()
                srv.httpd.server_close()


def _vanish(port, path, body):
    """POST a streaming request on a raw socket, read its first bytes and
    close the socket mid-stream."""
    data = json.dumps(body)
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: "
               f"application/json\r\nContent-Length: {len(data)}\r\n\r\n{data}").encode())
    s.recv(1024)  # the headers and the first bytes: decoding is live
    s.close()


@pytest.mark.parametrize("route", ["ndjson", "sse"])
def test_http_disconnect_cancels(fleets, servers, want, route):
    """A client gone mid-stream (NDJSON on /generate, SSE on
    /v1/completions): the slot and its blocks come back long before
    the budget, counted as a disconnect, and the fleet serves on."""
    if route == "ndjson":
        path, body = "/generate", {"prompt": PROMPT_A, "stream": True,
                                   "max_tokens": 2000, "greedy": True, "chat": False}
    else:
        # /v1/completions: the chat template's system turn alone would not
        # fit this fleet's 64-token slots
        path, body = "/v1/completions", {
            "model": "m", "prompt": PROMPT_A, "stream": True, "max_tokens": 2000,
            "temperature": 0.0}
    for pkg, cont in fleets.items():
        before = _cancelled(cont)
        _vanish(servers[pkg], path, body)
        _wait(lambda: cont.stats()["occupied"] == 0 and _pool_clean(cont)
              and _cancelled(cont) == before + 1,
              what=f"{pkg}: the fleet freed after the {route} client vanished")
        assert _ids(cont.submit(PROMPT_B, **KW)) == want[PROMPT_B], pkg


def test_prefill_only_never_streams(servers):
    """Handoff phase 1 (X-KV-Prefill-Only) ignores the body's stream flag:
    one JSON envelope of one token from both servers."""
    for pkg, port in servers.items():
        with _post(port, {"prompt": PROMPTS[2], "stream": True, **KW},
                   headers={"X-KV-Prefill-Only": "1"}) as r:
            assert r.headers["Content-Type"] == "application/json", pkg
            out = json.loads(r.read())
        assert out["status"] == "success" and out["tokens_generated"] == 1, (pkg, out)
        assert out["prefill_only"] is True


# -- the server's repaired flags --------------------------------------------


class _Built(Exception):
    pass


def _parsed(mod, monkeypatch, argv):
    """The EngineConfig each server's main builds from argv (create_engine
    is stopped before any model is made)."""
    runtime = ("distributed_llm_inference_tpu.runtime" if mod is JS
               else "distributed_llm_inference_tpu_torch.runtime")

    def stop(*a, engine_cfg=None, **kw):
        raise _Built(engine_cfg)

    monkeypatch.setattr(f"{runtime}.create_engine", stop)
    with pytest.raises(_Built) as ei:
        mod.main(["--model", MODEL, *argv])
    return ei.value.args[0]


@pytest.mark.parametrize("argv", [
    ["--continuous", "8", "--kv-pool-blocks", "513", "--tenant-weight", "a=3"],
    ["--tenant-weight", "a=3", "--tenant-weight", "b=0.5", "--tenant-queue-share", "0.25"],
    [],
], ids=["one_weight", "two_weights_and_share", "defaults"])
def test_server_tenant_flags_parse_like_jax(monkeypatch, argv):
    cfgs = [_parsed(mod, monkeypatch, argv) for mod in (JS, TS)]
    assert cfgs[1].tenant_weights == cfgs[0].tenant_weights
    assert cfgs[1].tenant_max_queue_share == cfgs[0].tenant_max_queue_share
    if argv:
        assert cfgs[1].tenant_weights[0] == ("a", 3.0)


@pytest.mark.parametrize("argv", [
    ["--die-on-wedge", "30"],
    ["--tenant-weight", "a"],
    ["--tenant-weight", "=3"],
    ["--tenant-weight", "a=x"],
], ids=["die_on_wedge_without_deadline", "no_weight", "no_name", "weight_nan"])
def test_server_refuses_bad_flags_like_jax(monkeypatch, argv):
    """Refused by both servers with the same message, before any model."""
    msgs = []
    for mod in (JS, TS):
        monkeypatch.setattr(
            "distributed_llm_inference_tpu.runtime.create_engine"
            if mod is JS else "distributed_llm_inference_tpu_torch.runtime.create_engine",
            lambda *a, **k: pytest.fail("a model was made"))
        with pytest.raises(SystemExit) as ei:
            mod.main(["--model", MODEL, *argv])
        msgs.append(str(ei.value.code))
    assert msgs[0] == msgs[1], msgs


def test_server_warmup_and_die_on_wedge_act(monkeypatch):
    """`--warmup` runs the solo warmup, then one request through the fleet
    (kept out of /stats), before the server serves; `--die-on-wedge`
    with `--deadline` starts the reaper; the tenant weight reaches the
    fleet's scheduler."""
    seen = {}
    started = []

    def serve(self):
        seen["server"] = self

    monkeypatch.setattr(TS.InferenceServer, "serve_forever", serve)
    monkeypatch.setattr(TS, "_wedge_reaper", lambda eng, s: started.append(s))
    TS.main(["--model", MODEL, "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
             "--continuous", "2", "--kv-pool-blocks", "20", "--kv-block-size", "16",
             "--continuous-max-seq", "128", "--warmup", "--tenant-weight", "a=3",
             "--deadline", "60", "--die-on-wedge", "120"])
    srv = seen["server"]
    cont = srv.continuous
    try:
        assert started == [120.0]
        assert srv.engine.engine_cfg.tenant_weights == (("a", 3.0),)
        assert cont._sched.tenant_weights == {"a": 3.0}
        st = cont.stats()
        assert st["admitted"] == 1 and st["completed"] == 1  # the warmup request
        assert srv.engine.request_count == 0  # kept out of /stats
        assert srv.engine._cache is not None  # the solo warmup left its cache
    finally:
        srv.httpd.server_close()
        cont.close()
