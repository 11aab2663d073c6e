"""PyTorch port vs JAX package: the router tier over real replica
processes on the CPU.

Every replica serves one checkpoint store, written by the JAX package's
save_params in a temporary directory, so both packages run the same
weights. Replicas are the servers' CLIs in subprocesses (the port's with
`--device cpu`), spawned by each package's `spawn_replicas` behind an
in-process router of the same package. The JAX envelope carries no token
ids, so the fleets compared with each other serve a copy of the store
with a word-level tokenizer whose decode spells every id ("w17 w203 ..."),
and their responses pin the greedy ids; the port-only fleets use the byte
tokenizer (loading a tokenizer directory costs a replica seconds of
start) and their envelopes' `token_ids`.

  * The traced prefill->decode handoff: one prefill-class and one
    decode-class replica per package, `--trace-sample-rate 1.0`. The same
    request with the same `traceparent` through each router gives the
    same greedy ids, `replica`, `kv_fabric_blocks` / `kv_promoted_blocks`,
    and the same span names in the assembled tree, each as often (launch
    spans by kind only: launches still in flight when a request finishes
    land in its tree too, so their count follows the pipelining), with the
    chain pushed to the decode replica and, with the router's push off,
    pulled by it.
  * Two mixed port replicas: `kill -9` of one with a request held in
    flight (a DLI_FAULTS wedge) fails over with the fault-free ids of the
    JAX engine on the same weights; the dead replica is ejected and, once
    respawned, readmitted. A rolling restart under load drops no request.
  * The wedge drill on one port replica: its /ready says "wedged", the
    router ejects it, /health stays 200, and it is readmitted after the
    abandoned call drains.
  * The router CLI's `--spawn` mode end to end.
"""

import collections
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

import jax  # noqa: E402

import distributed_llm_inference_tpu.serving.router as JR  # noqa: E402
import distributed_llm_inference_tpu_torch.serving.router as PR  # noqa: E402
from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import checkpoint as JS  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.utils.tokenizer import ByteTokenizer  # noqa: E402
from distributed_llm_inference_tpu_torch.client import DistributedLLMClient  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tracing import SpanContext  # noqa: E402

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parent.parent
BS = 16
VOCAB = 256
# one word per id: "<unk>", "<s>", "</s>", then w3 .. w255
WORDS = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(3, VOCAB)]
FLEET_ARGS = [
    "--continuous", "2", "--continuous-chunk", "4", "--kv-pool-blocks", "48",
    "--kv-block-size", str(BS), "--prefix-cache", "8", "--max-tokens-cap", "64",
    "--trace-sample-rate", "1.0",
]
# 40 one-token words: two full blocks for the fabric, 160-odd bytes for
# the router's handoff gate (handoff_min_bytes=64, as the JAX suite's)
HANDOFF_PROMPT = " ".join(f"w{3 + (7 * i) % 250}" for i in range(40))
SLOW_PROMPT = "SLOWPOKE " + "the quick brown fox " * 4  # > the affinity chunk
COMPANION = "jumps over the lazy dog"
# the victim holds SLOW_PROMPT's prefill for 6 s, then would crash
# transiently (its supervisor would recover it) — unless kill -9 comes first
VICTIM_FAULTS = "prefill:transient:match=SLOWPOKE,wedge=6,times=1"


def _words(text: str) -> list:
    return [int(w[1:]) for w in text.split()]


class IdTokenizer(ByteTokenizer):
    """The JAX byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A JAX-written checkpoint store of test-llama-tiny (fp32, no EOS),
    and a copy of it with the word-level tokenizer beside it."""
    cfg = jax_cfg("test-llama-tiny", dtype="float32", eos_token_id=-1)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("fleet")
    JS.save_params(str(root / "store"), cfg, params)
    shutil.copytree(root / "store", root / "words")
    vocab = {w: i for i, w in enumerate(WORDS)}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
    ).save_pretrained(str(root / "words"))
    return str(root / "store"), str(root / "words"), cfg, params


def _env(faults=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["OMP_NUM_THREADS"] = "2"  # several replicas share the host
    env.pop("DLI_FAULTS", None)
    if faults:
        env["DLI_FAULTS"] = faults
    return env


def _port_args(store_path, extra=()):
    return ["--checkpoint", store_path, "--device", "cpu", *FLEET_ARGS, *extra]


def _close(server, reps):
    server.shutdown()  # SIGTERMs the spawned replicas
    for rep in reps:
        if rep.proc is not None:
            try:
                rep.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(timeout=20)


@pytest.fixture(scope="module")
def handoff_fleets(store):
    """The JAX and the port disaggregated fleets (one prefill-class and
    one decode-class replica each), the four replicas started together."""
    _, words, _, _ = store
    args = {"jax": (JR, ["--checkpoint", words, *FLEET_ARGS]),
            "port": (PR, _port_args(words))}
    reps = {}

    def start(which, cls):
        R, a = args[which]
        reps[which, cls] = R.spawn_replicas(1, a, env=_env(), replica_class=cls,
                                            name_prefix=cls[0])[0]

    threads = [threading.Thread(target=start, args=(w, c))
               for w in args for c in ("prefill", "decode")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    try:
        assert len(reps) == 4, "a replica did not start"
        for which, (R, _) in args.items():
            pair = [reps[which, "prefill"], reps[which, "decode"]]
            router = R.Router(pair, eject_threshold=3, probe_interval_s=3.0,
                              probe_timeout_s=2.0, request_timeout_s=120.0,
                              handoff_min_bytes=64)
            server = R.RouterServer(router, host="127.0.0.1", port=0)
            server.start()
            out[which] = (router, server, f"http://127.0.0.1:{server.port}", pair)
        yield out
    finally:
        for router, server, _, pair in out.values():
            _close(server, pair)
        for rep in reps.values():
            if rep.proc.poll() is None:
                rep.proc.kill()


def _post(base, payload, headers=None, timeout=180, path="/generate"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path, timeout=15):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _traced(base, prompt, max_tokens=8):
    ctx = SpanContext.new_root()
    t0 = time.time()
    code, body, hdrs = _post(base, {"prompt": prompt, "max_tokens": max_tokens,
                                    "greedy": True, "chat": False},
                             headers={"traceparent": ctx.header()})
    wall = time.time() - t0
    assert code == 200 and body["status"] == "success", body
    assert hdrs.get("X-Trace-Id") == ctx.trace_id
    # the router's root span ends after its response is written: read the
    # tree once it holds that span (or at the deadline, as it stands)
    deadline = time.time() + 10
    while True:
        code, tree, _ = _get(base, f"/debug/traces/{ctx.trace_id}")
        assert code == 200
        if ("router", "router.request") in _names(tree) or time.time() > deadline:
            return body, tree, wall, ctx
        time.sleep(0.01)


def _names(tree) -> collections.Counter:
    return collections.Counter((s["service"], s["name"]) for s in tree["spans"])


# the pushed handoff (the router's default) and the pulled one (kv_push
# off): the decode replica promotes the pushed chain, or pulls it over the
# fabric from the prefill replica (fabric.pull there, kv.serve here)
HANDOFFS = {"push": (True, HANDOFF_PROMPT, ("fabric.push",)),
            "pull": (False, " ".join(f"w{5 + (11 * i) % 240}" for i in range(40)),
                     ("fabric.pull", "kv.serve"))}


@pytest.mark.parametrize("kind", sorted(HANDOFFS))
def test_traced_handoff_equals_jax(handoff_fleets, kind):
    push, prompt, fabric_spans = HANDOFFS[kind]
    runs = {}
    for which in ("jax", "port"):
        router, _, base, _ = handoff_fleets[which]
        router.kv_push = push
        try:
            runs[which] = _traced(base, prompt)
        finally:
            router.kv_push = True
    (jbody, jtree, _, _), (pbody, ptree, pwall, pctx) = runs["jax"], runs["port"]
    assert _words(pbody["response"]) == _words(jbody["response"])
    assert len(_words(pbody["response"])) == 8
    for key in ("replica", "kv_fabric_blocks", "kv_promoted_blocks", "tokens_generated",
                "prompt_tokens", "finish_reason"):
        assert pbody.get(key) == jbody.get(key), key
    assert pbody["replica"] == "d0"
    assert pbody.get("kv_fabric_blocks", 0) + pbody.get("kv_promoted_blocks", 0) > 0
    # the same hops: every (service, span name) of the JAX tree, each as
    # often; launch spans by kind only (how many a request rides depends on
    # the pipelining: launches in flight when it finishes land in it too)
    jn, pn = _names(jtree), _names(ptree)
    launch = {k for k in jn.keys() | pn.keys() if k[1].startswith("launch.")}
    assert {k: v for k, v in pn.items() if k not in launch} == \
        {k: v for k, v in jn.items() if k not in launch}
    assert {k for k in launch if k in pn} == {k for k in launch if k in jn}
    assert ("replica-decode", "launch.chunk") in pn
    names = {n for _, n in pn}
    for name in ("router.request", "router.dispatch", "router.handoff_prefill",
                 "replica.request", "stage.decode", *fabric_spans):
        assert name in names, name
    # one tree, within the request's wall; both exports parse
    assert len(ptree["tree"]) == 1 and ptree["tree"][0]["name"] == "router.request"
    assert ptree["total_s"] <= pwall + 0.05
    code, chrome, _ = _get(handoff_fleets["port"][2], f"/debug/traces/{pctx.trace_id}"
                           "?format=chrome")
    assert code == 200
    lanes = {e["args"]["name"] for e in chrome["traceEvents"] if e["name"] == "process_name"}
    assert lanes == {"router", "replica-prefill", "replica-decode"}


def test_replicas_serve_traces_and_exemplars(handoff_fleets):
    """Each port replica lists its traces and links its latency exemplars
    to a trace the router assembles; no route answers 501."""
    router, _, base, reps = handoff_fleets["port"]
    for rep in reps:
        code, listing, _ = _get(rep.url, "/debug/traces")
        assert code == 200 and listing["stats"]["service"] == f"replica-{rep.replica_class}"
    code, stats, _ = _get(reps[1].url, "/stats")
    tids = [e["trace_id"] for e in
            stats.get("exemplars", {}).get("dli_request_duration_seconds", {}).values()]
    assert tids
    code, tree, _ = _get(base, f"/debug/traces/{tids[0]}")
    assert code == 200 and tree["spans"]
    for path in ("/debug/traces/" + "0" * 32, "/debug/traces"):
        assert _get(reps[0].url, path)[0] == 200


# -- two mixed port replicas: kill -9, rolling restart ------------------------------

@pytest.fixture(scope="module")
def mixed_fleet(store):
    path = store[0]
    victim = PR.spawn_replicas(1, _port_args(path), env=_env(VICTIM_FAULTS))[0]
    try:
        clean = PR.spawn_replicas(1, _port_args(path), env=_env())[0]
    except BaseException:
        victim.proc.kill()
        raise
    clean.rid = "r1"
    router = PR.Router([victim, clean], eject_threshold=3, probe_interval_s=0.25,
                       probe_timeout_s=2.0, request_timeout_s=120.0, drain_deadline_s=60.0)
    server = PR.RouterServer(router, host="127.0.0.1", port=0)
    server.start()
    try:
        yield router, server, f"http://127.0.0.1:{server.port}"
    finally:
        _close(server, router.replicas)


@pytest.fixture(scope="module")
def reference(store):
    """The fault-free single engine: the JAX package's, on the same
    weights, its greedy ids."""
    _, _, cfg, params = store
    eng = JaxEngine(cfg, params=params, tokenizer=IdTokenizer(),
                    engine_cfg=JaxEngineConfig())

    def ids(prompt, max_tokens):
        r = eng.generate(prompt, max_tokens=max_tokens, greedy=True, chat=False)
        return [int(t) for t in r["response"].split()]

    return ids


def _wait_state(router, rid, state, deadline_s):
    rep = next(r for r in router.replicas if r.rid == rid)
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if rep.state == state:
            return True
        time.sleep(0.05)
    return False


def _counter(router, name, **labels):
    return router.metrics.get(name).labels(**labels).value


def test_kill9_failover_bit_exact(mixed_fleet, reference):
    router, _, base = mixed_fleet
    victim = router.replicas[0]
    assert victim.rid == "r0"
    router.record_residency(PR.chunk_digests(SLOW_PROMPT, router.affinity_chunk, 32), "r0")
    out = {}

    def fire(name, prompt):
        out[name] = _post(base, {"prompt": prompt, "max_tokens": 10, "greedy": True,
                                 "chat": False}, timeout=120)

    t_slow = threading.Thread(target=fire, args=("slow", SLOW_PROMPT))
    t_slow.start()
    t0 = time.time()
    while victim.outstanding == 0:
        assert time.time() - t0 < 30, "the wedged request was never dispatched"
        time.sleep(0.02)
    t_comp = threading.Thread(target=fire, args=("comp", COMPANION))
    t_comp.start()
    time.sleep(0.5)  # inside the 6 s wedge
    victim.proc.kill()  # SIGKILL: no drain
    t_slow.join(timeout=120)
    t_comp.join(timeout=120)
    code, slow, _ = out["slow"]
    assert code == 200 and slow["status"] == "success", slow
    assert slow["token_ids"] == reference(SLOW_PROMPT, 10)
    assert slow["replica"] == "r1" and slow.get("router_attempts", 1) > 1
    code, comp, _ = out["comp"]
    assert code == 200 and comp["token_ids"] == reference(COMPANION, 10)
    assert _counter(router, "dli_router_failovers_total", replica="r0") >= 1
    # ejected within the probe window: eject_threshold probes at 0.25 s
    assert _wait_state(router, "r0", PR.EJECTED, deadline_s=10)
    assert _counter(router, "dli_router_replica_ready", replica="r0") == 0.0
    assert _counter(router, "dli_router_ejections_total", replica="r0") >= 1
    code, body, _ = _post(base, {"prompt": "still serving", "max_tokens": 4, "greedy": True,
                                 "chat": False}, timeout=120)
    assert code == 200 and body["replica"] == "r1"
    # respawn with the same argv and a clean environment: readmitted
    victim.spawn_env = _env()
    victim.proc = subprocess.Popen(victim.spawn_argv, env=victim.spawn_env,
                                   stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    assert _wait_state(router, "r0", PR.READY, deadline_s=120)
    assert _counter(router, "dli_router_readmissions_total", replica="r0") >= 1


def test_rolling_restart_drops_no_request(mixed_fleet, reference):
    router, _, base = mixed_fleet
    for rid in ("r0", "r1"):
        assert _wait_state(router, rid, PR.READY, deadline_s=120)
    want = reference("rolling load", 4)
    old_pids = {r.rid: r.proc.pid for r in router.replicas}
    stop = threading.Event()
    results = []

    def pump():
        c = DistributedLLMClient(base, timeout=120, max_retries=2, retry_backoff_s=0.1)
        while not stop.is_set():
            results.append(c.generate("rolling load", max_tokens=4, greedy=True,
                                      chat=False, verbose=False))

    t = threading.Thread(target=pump)
    t.start()
    try:
        code, body, _ = _post(base, {}, path="/admin/rolling-restart")
        assert code == 202, body
        t0 = time.time()
        while time.time() - t0 < 300:
            if not _get(base, "/health")[1]["rolling_restart"]["active"]:
                break
            time.sleep(0.25)
        status = _get(base, "/health")[1]["rolling_restart"]
        assert status["active"] is False and status["error"] is None, status
        assert status["done"] == ["r0", "r1"]
    finally:
        stop.set()
        t.join(timeout=120)
    assert results
    failed = [r for r in results if r.get("status") != "success"]
    assert not failed, failed[:3]
    assert all(r["token_ids"] == want for r in results)
    for rep in router.replicas:
        assert rep.proc.pid != old_pids[rep.rid]


# -- the wedge drill ---------------------------------------------------------------

# The wedge drill: the request's --deadline D abandons the solo call, which
# the fault holds for WEDGE_S; /ready flips 503 once the abandoned call is
# older than --wedge-unready U; the router ejects after EJECT_AFTER probes
# P apart. From the request's arrival the ejection is due by D + U +
# EJECT_AFTER * P plus one probe timeout T for a probe in flight, and the
# readmission by WEDGE_S + 2 * P (HALF_OPEN, then READY). Each wait below
# is that bound, times a margin for a host shared with other test
# workers, never a fixed 15 s.
D, U, P, T, EJECT_AFTER, WEDGE_S = 1.0, 0.3, 0.2, 2.0, 2, 7.0
MARGIN = 3.0
EJECT_DEADLINE_S = MARGIN * (D + U + EJECT_AFTER * P + T)
READMIT_DEADLINE_S = MARGIN * (WEDGE_S + 2 * P + T)
WEDGE_FAULTS = f"solo:transient:match=WEDGEME,wedge={WEDGE_S:g},times=1"


def test_wedge_ejection_and_readmission_after_drain(store):
    path = store[0]
    args = ["--checkpoint", path, "--device", "cpu", "--deadline", f"{D:g}",
            "--wedge-unready", f"{U:g}", "--max-tokens-cap", "64", "--warmup"]
    rep = PR.spawn_replicas(1, args, env=_env(WEDGE_FAULTS))[0]
    router = PR.Router([rep], eject_threshold=EJECT_AFTER, probe_interval_s=P,
                       probe_timeout_s=T, request_timeout_s=60.0, drain_deadline_s=30.0)
    server = PR.RouterServer(router, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _wait_state(router, "r0", PR.READY, deadline_s=120)
        code, body, _ = _post(base, {"prompt": "clean", "max_tokens": 2, "greedy": True,
                                     "chat": False}, timeout=120)
        assert code == 200 and body["status"] == "success", body
        out = {}

        def fire():
            out["r"] = _post(base, {"prompt": "WEDGEME now", "max_tokens": 4,
                                    "greedy": True, "chat": False}, timeout=60)

        t = threading.Thread(target=fire)
        t.start()
        assert _wait_state(router, "r0", PR.EJECTED, deadline_s=EJECT_DEADLINE_S), \
            "the wedged replica was never ejected"
        assert _get(base, "/ready")[0] == 503
        rcode, rbody, _ = _get(rep.url, "/ready")
        assert rcode == 503 and rbody["reason"] == "wedged", rbody
        hcode, hbody, _ = _get(rep.url, "/health")
        assert hcode == 200 and hbody["ready_reason"] == "wedged"
        t.join(timeout=60)
        assert out["r"][1].get("error_type") == "timeout", out["r"]
        assert _wait_state(router, "r0", PR.READY, deadline_s=READMIT_DEADLINE_S), \
            "the replica was never readmitted after the wedge drained"
        assert _counter(router, "dli_router_readmissions_total", replica="r0") >= 1
        code, body, _ = _post(base, {"prompt": "after the wedge", "max_tokens": 2, "greedy": True,
                                     "chat": False}, timeout=120)
        assert code == 200 and body["status"] == "success", body
    finally:
        _close(server, [rep])


# -- the router CLI ------------------------------------------------------------------

def test_router_cli_spawn_mode_end_to_end(store):
    path = store[0]
    port = PR._free_port()
    spawn_args = " ".join(["--checkpoint", path, "--device", "cpu", "--max-tokens-cap", "64"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.router",
         "--host", "127.0.0.1", "--port", str(port), "--spawn", "1",
         "--spawn-args", spawn_args, "--probe-interval", "0.5"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.time()
        while True:
            assert proc.poll() is None, proc.stdout.read().decode(errors="replace")
            try:
                if _get(base, "/ready")[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            assert time.time() - t0 < 300, "the router never became ready"
            time.sleep(0.3)
        code, body, _ = _post(base, {"prompt": "cli smoke", "max_tokens": 4, "greedy": True,
                                     "chat": False}, timeout=120)
        assert code == 200 and body["status"] == "success" and body["replica"] == "r0"
        with urllib.request.urlopen(base + "/metrics", timeout=15) as r:
            text = r.read().decode()
        assert "dli_router_requests_total" in text and "dli_router_replica_ready" in text
        assert _get(base, "/debug/traces")[0] == 200
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
