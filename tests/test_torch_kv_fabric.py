"""PyTorch port vs JAX package: the cross-replica KV fabric.

The port's serving/kv_fabric.py is a copy of the JAX module: the wire
cases of tests/test_kv_fabric.py and tests/test_kv_tiers.py run the same
numpy inputs through both modules, and every blob and frame is byte-equal.
Then the fleet cases run over HTTP on loopback, each once with two JAX
replicas and once with two port replicas on the same weights
(test-llama-tiny, fp32, no EOS, params bridged through numpy): the /kv
routes (whole and streamed, 404, 400), a remote hit streamed and
whole-blob, a streamed pull from the holder's disk tier, a dead peer, a
wedged peer and a corrupt payload, a push, a bucketed remote hit and
--no-kv-fabric. Each holds the port to the JAX fleet's greedy ids,
`kv_fabric_blocks`, `kv_digests`, hit / miss counts and /health `kv`
keys, and every remote hit and fallback to the cold run's ids. A chain
the JAX fleet serves is imported by the port's fleet, and a chain between
a raw and an int8 pool is refused into a cold run, counted as a miss.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.engine.shadow import ShadowStore as JaxShadowStore  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.serving import kv_fabric as JKF  # noqa: E402
from distributed_llm_inference_tpu.serving import server as JS  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import kv_fabric as TKF  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TSV  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=256)
BS = 16
# 101 byte-tokenizer tokens: 6 full blocks and a tail
PROMPT = "shared fabric preamble " * 4 + "tail one"
GEN = dict(max_tokens=10, greedy=True, chat=False)
FLEET = dict(n_slots=2, chunk_steps=4, kv_pool_blocks=48, kv_block_size=BS,
             slot_max_seq=192)
PKGS = {"jax": (JC, JS, JKF), "port": (TC, TSV, TKF)}


# -- the wire: the same numpy inputs through both modules ----------------------

class _E:
    def __init__(self, leaves):
        self.leaves = leaves


def _chain(n_blocks: int, bs: int = 4, base: int = 1):
    """A chain of n_blocks blocks: keys and entries whose leaves are a fp32
    data leaf, an int8 one and an int16 one (the port's bf16 carrier)."""
    ids = [(base + i) % 250 + 1 for i in range(n_blocks * bs)]
    keys = [tuple(ids[: (i + 1) * bs]) for i in range(n_blocks)]
    rng = np.random.default_rng(base)
    entries = [_E([rng.standard_normal((2, 3)).astype(np.float32),
                   (np.arange(6, dtype=np.int8) + i).reshape(2, 3),
                   rng.integers(-2 ** 15, 2 ** 15, (2, 3)).astype(np.int16)])
               for i in range(n_blocks)]
    return ids, keys, entries


def test_wire_round_trip_is_byte_equal_to_jax():
    ids, keys, entries = _chain(3)
    blob = TKF.encode_chain(4, keys, entries)
    assert blob == JKF.encode_chain(4, keys, entries)
    digest = TKF.chain_digest(ids, 4)
    assert digest == JKF.chain_digest(ids, 4)
    for kf in (TKF, JKF):
        got_keys, per_block = kf.decode_chain(blob, 4, digest)
        assert got_keys == keys and len(per_block) == 3
        for i in range(3):
            for j in range(3):
                np.testing.assert_array_equal(per_block[i][j], entries[i].leaves[j])
                assert per_block[i][j].dtype == entries[i].leaves[j].dtype


def _tampered():
    ids, _, entries = _chain(3)
    ids2 = list(ids)
    ids2[5] = (ids2[5] % 250) + 1  # one token off
    return JKF.encode_chain(4, [tuple(ids2[: (i + 1) * 4]) for i in range(3)],
                            entries), 4, JKF.chain_digest(ids, 4)


def _wire_case(name):
    ids, keys, entries = _chain(3)
    blob, digest = JKF.encode_chain(4, keys, entries), JKF.chain_digest(ids, 4)
    return {
        "wrong_digest": lambda: (blob, 4, JKF.chain_digest([9] * 12, 4)),
        "tampered_tokens": _tampered,
        "block_size_drift": lambda: (blob, 8, digest),
        "truncated": lambda: (blob[: len(blob) // 2], 4, digest),
        "garbage": lambda: (b"not an npz at all", 4, "ab12"),
    }[name]()


@pytest.mark.parametrize("case", ["wrong_digest", "tampered_tokens", "block_size_drift",
                                  "truncated", "garbage"])
def test_wire_rejects_like_jax(case):
    data, bs, digest = _wire_case(case)
    errors = []
    for kf in (TKF, JKF):
        with pytest.raises(kf.FabricPayloadError) as ei:
            kf.decode_chain(data, bs, digest)
        errors.append(str(ei.value).split(":")[0])
    assert errors[0] == errors[1]


def test_valid_digest_gate_like_jax():
    for d in ("0123abcdef", "", "../etc/passwd", "A" * 20, "a" * 64, "a" * 65, "0f"):
        assert TKF.valid_digest(d) == JKF.valid_digest(d), d
    assert TKF.valid_digest("0123abcdef") and not TKF.valid_digest("a" * 65)


class _Sock:
    """file-like over bytes for the stream reader's contract."""

    def __init__(self, data):
        self._d, self._i = data, 0

    def read(self, n):
        out = self._d[self._i:self._i + n]
        self._i += len(out)
        return out


def _frames(kf, bs, keys, entries):
    digests = kf.chunk_digests(keys[-1], bs, max_chunks=len(keys))
    out = b""
    for i, (key, e) in enumerate(zip(keys, entries)):
        payload = kf.encode_frame(bs, key[-bs:], digests[i], e.leaves)
        out += len(payload).to_bytes(8, "big") + payload
    return out + (0).to_bytes(8, "big")


def _read_frames(kf, data, bs):
    sock, out = _Sock(data), []
    while True:
        n = int.from_bytes(kf._read_exact(sock, 8), "big")
        if n == 0:
            return out
        out.append(kf.decode_frame(kf._read_exact(sock, n), bs))


def test_stream_frames_byte_equal_and_truncation_raises():
    ids, keys, entries = _chain(3)
    data = _frames(TKF, 4, keys, entries)
    assert data == _frames(JKF, 4, keys, entries)
    for kf in (TKF, JKF):
        got = _read_frames(kf, data, 4)
        assert len(got) == 3 and got[-1][1] == kf.chain_digest(ids, 4)
        for i, (chunk, _, leaves) in enumerate(got):
            assert tuple(chunk) == keys[i][-4:]
            for a, b in zip(leaves, entries[i].leaves):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(kf.FabricPayloadError):
            _read_frames(kf, data[: len(data) - 12], 4)  # cut inside the last frame


def test_serve_chain_stream_matches_whole_blob_like_jax(tmp_path):
    """Both stores hold the same chain: the streamed bodies and the whole
    blobs are byte-equal across the packages, the frames reassemble the
    whole blob's blocks, and a chain demoted to disk streams with tier
    "disk"."""
    stores = [ShadowStore(4, max_blocks=4, disk_dir=str(tmp_path / "port")),
              JaxShadowStore(4, max_blocks=4, disk_dir=str(tmp_path / "jax"))]
    try:
        ids, keys, entries = _chain(3, base=11)
        bodies = []
        for st, kf in zip(stores, (TKF, JKF)):
            st.put_host(keys, [e.leaves for e in entries], seq=0)
            deep = st.digest_of(keys[-1])
            n_chunks, tier, frames = kf.serve_chain_stream(st, deep)
            assert (n_chunks, tier) == (3, "host")
            body, whole = b"".join(frames), kf.serve_chain(st, deep)
            bodies.append((body, whole))
            keys_w, blocks_w = kf.decode_chain(whole, 4, deep)
            got = _read_frames(kf, body, 4)
            assert [tuple(c) for c, _, _ in got] == [k[-4:] for k in keys_w]
            for (_, _, leaves), want in zip(got, blocks_w):
                for a, b in zip(leaves, want):
                    np.testing.assert_array_equal(a, b)
            # a second chain demotes the first to the disk tier
            _, keys_b, entries_b = _chain(4, base=201)
            st.put_host(keys_b, [e.leaves for e in entries_b], seq=1)
            assert st.digest_tier(deep) == "disk"
            assert kf.serve_chain_stream(st, deep)[1] == "disk"
            assert kf.serve_chain_stream(st, "deadbeef00") is None
            assert kf.serve_chain(st, "../escape") is None
        assert bodies[0] == bodies[1]
    finally:
        for st in stores:
            st.close()


def test_decode_push_names_itself_like_jax():
    ids, keys, entries = _chain(3)
    data = JKF.encode_chain(4, keys, entries)
    for kf in (TKF, JKF):
        digest, keys2, per_block = kf.decode_push(data, 4)
        assert digest == kf.chain_digest(ids, 4) and keys2 == keys
        np.testing.assert_array_equal(per_block[2][0], entries[2].leaves[0])
        with pytest.raises(kf.FabricPayloadError):
            kf.decode_push(data, 8)
        with pytest.raises(kf.FabricPayloadError):
            kf.decode_push(b"junk", 4)


def test_check_layout_refuses_another_pools_leaves():
    _, _, entries = _chain(1)
    leaves = entries[0].leaves
    layout = [(a.dtype, a.shape) for a in leaves]
    TKF.check_layout(leaves, layout)
    TKF.check_layout(leaves, None)
    for bad in (layout[:2], [(np.dtype(np.float16), (2, 3))] + layout[1:],
                [(np.dtype(np.float32), (2, 4))] + layout[1:]):
        with pytest.raises(TKF.FabricPayloadError, match="not this pool's"):
            TKF.check_layout(leaves, bad)


# -- the fleets over HTTP on loopback ------------------------------------------

@pytest.fixture(scope="module")
def weights():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    return params, params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu"), \
        IdTokenizer()


_ENGINES: dict = {}


def _engine(weights, pkg, kv_quant=None, **ecfg):
    """One package's engine on the shared weights, built once per setting
    (replica_class included, so a holder and its puller never share one)."""
    key = (pkg, kv_quant, tuple(sorted(ecfg.items())))
    if key not in _ENGINES:
        params, tparams, tok = weights
        over = dict(OVERRIDES, **({"kv_quant": kv_quant} if kv_quant else {}))
        ecfg = dict(dict(prefill_buckets=(32, 64), prefix_cache_entries=8), **ecfg)
        if pkg == "jax":
            eng = JaxEngine(jax_cfg(MODEL, **over), params=params,
                            engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
        else:
            eng = create_engine(get_model_config(MODEL, **over), params=tparams,
                                engine_cfg=EngineConfig(**ecfg), tokenizer=tok,
                                device="cpu")
        _ENGINES[key] = eng
    return _ENGINES[key]


class _Replica:
    """A fleet behind its package's HTTP server on a loopback port."""

    def __init__(self, weights, pkg, role="mixed", kv_quant=None, fleet=None, **ecfg):
        mod, server, _ = PKGS[pkg]
        self.engine = _engine(weights, pkg, kv_quant, replica_class=role, **ecfg)
        self.cont = mod.ContinuousEngine(self.engine, **dict(FLEET, **(fleet or {})))
        self.srv = server.InferenceServer(self.engine, "127.0.0.1", 0, max_tokens_cap=64,
                                          continuous=self.cont)
        self.srv.start()
        self.url = f"http://127.0.0.1:{self.srv.port}"

    def stats(self) -> dict:
        return self.cont.stats()["kv_fabric"]

    def fetch_events(self) -> list:
        return [e for e in self.engine.flight.events() if e.get("kind") == "fabric_fetch"]

    def close(self):
        self.srv.shutdown()


def _ids(r) -> list:
    assert r["status"] == "success", r
    return [int(t) for t in r["response"].split()]


def _call(url, path, body=None, headers=None, method=None):
    req = urllib.request.Request(url + path, data=body, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def holders(weights):
    """One prefill-class holder per package, PROMPT served once (cold) with
    its shadow copies landed: the peer of every pull below."""
    out = {}
    for pkg in PKGS:
        rep = _Replica(weights, pkg, role="prefill")
        r = rep.cont.submit(PROMPT, **GEN)
        assert rep.cont._shadow.flush(10.0)
        out[pkg] = (rep, r)
    yield out
    for rep, _ in out.values():
        rep.close()


def test_holders_cold_runs_and_digests_equal(holders):
    (_, jr), (_, tr) = holders["jax"], holders["port"]
    assert _ids(tr) == _ids(jr)
    assert tr["kv_digests"] == jr["kv_digests"] and len(tr["kv_digests"]) == 6
    assert holders["port"][0].cont.fabric_serving and holders["jax"][0].cont.fabric_serving


def test_kv_routes_round_trip_404_and_400(holders):
    """GET /kv/{digest} whole and streamed, 404 for a digest nobody holds
    and for a malformed one, 400 for a garbage or empty push, /health's kv
    block: the same codes, headers, chains and keys from both servers."""
    seen = {}
    for pkg, (rep, r) in holders.items():
        kf = PKGS[pkg][2]
        digest = r["kv_digests"][-1]
        code, hdr, blob = _call(rep.url, f"/kv/{digest}")
        assert code == 200 and hdr["Content-Type"] == "application/octet-stream"
        keys, per_block = TKF.decode_chain(blob, BS, digest)
        scode, shdr, body = _call(rep.url, f"/kv/{digest}", headers={"X-KV-Stream": "1"})
        frames = _read_frames(kf, body, BS)
        assert [tuple(c) for c, _, _ in frames] == [k[-BS:] for k in keys]
        for (_, _, leaves), want in zip(frames, per_block):
            for a, b in zip(leaves, want):
                np.testing.assert_array_equal(a, b)
        health = json.loads(_call(rep.url, "/health")[2])
        seen[pkg] = dict(
            codes=(code, scode, _call(rep.url, "/kv/" + "0" * 20)[0],
                   _call(rep.url, "/kv/NOT-A-DIGEST")[0],
                   _call(rep.url, "/kv", b"not a chain", method="POST",
                         headers={"Content-Type": "application/octet-stream"})[0],
                   _call(rep.url, "/kv", b"", method="POST")[0]),
            headers=(hdr["X-KV-Block-Size"], hdr["X-KV-Tier"], shdr["Content-Type"],
                     shdr["X-KV-Block-Size"], shdr["X-KV-Chain-Len"], shdr["X-KV-Tier"]),
            keys=keys, kv=(sorted(health["kv"]), health["kv"]["block_size"],
                           digest in health["kv"]["resident_digests"],
                           health["replica_class"]))
    assert seen["port"] == seen["jax"]
    assert seen["port"]["codes"] == (200, 200, 404, 404, 400, 400)
    assert seen["port"]["headers"] == (str(BS), "host", TKF.STREAM_CONTENT_TYPE, str(BS),
                                       "6", "host")
    assert seen["port"]["kv"] == (["block_size", "fabric", "resident_digests"], BS, True,
                                  "prefill")


def _pull(weights, pkg, holder_url, digest, role="decode", **ecfg):
    rep = _Replica(weights, pkg, role=role, **ecfg)
    try:
        t0 = time.perf_counter()
        r = rep.cont.submit(PROMPT, **GEN, kv_hint={"peer": holder_url, "digest": digest})
        wall = time.perf_counter() - t0
        st = rep.stats()
        ev = rep.fetch_events()[-1]
        return dict(ids=_ids(r), blocks=r.get("kv_fabric_blocks"),
                    depth=r.get("prefix_cached_tokens"), digests=r.get("kv_digests"),
                    counts=(st["fetches"], st["hits"], st["misses"]), bytes=st["bytes"],
                    event=(ev["hit"], ev["tier"], ev["streamed"]), wall=wall,
                    onward=digest in rep.cont.fabric_digests(), role=st["role"])
    finally:
        rep.close()


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole_blob"])
def test_remote_hit_identical_to_cold(weights, holders, stream):
    """A replica that never saw PROMPT pulls the chain from the holder: the
    cold run's greedy ids, 6 imported blocks, a hit at depth 96, the
    JAX fleet's digests, counts and flight event; the chain onward-servable."""
    seen = {}
    for pkg, (rep, r) in holders.items():
        seen[pkg] = _pull(weights, pkg, rep.url, r["kv_digests"][-1],
                          kv_fabric_stream=stream)
        assert seen[pkg]["ids"] == _ids(r)
    t, j = seen["port"], seen["jax"]
    keys = ("ids", "blocks", "depth", "digests", "counts", "event", "onward", "role")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    assert t["blocks"] == 6 and t["depth"] == 6 * BS and t["counts"] == (1, 1, 0)
    assert t["event"] == (True, "host", stream) and t["onward"] and t["bytes"] > 0


def test_streamed_pull_from_the_disk_tier(weights, holders, tmp_path):
    """The holder's chain lives on its disk tier: the streamed serve
    promotes it, labels it "disk", and the puller's admission is the cold
    run's."""
    seen = {}
    for pkg in PKGS:
        hold = _Replica(weights, pkg, role="prefill", kv_disk_dir=str(tmp_path / pkg))
        try:
            r = hold.cont.submit(PROMPT, **GEN)
            assert hold.cont._shadow.flush(10.0)
            sh = hold.cont._shadow
            with sh._lock:
                for k in list(sh._entries):
                    sh._evict_subtree_locked(k)
            assert sh.digest_tier(r["kv_digests"][-1]) == "disk"
            seen[pkg] = _pull(weights, pkg, hold.url, r["kv_digests"][-1])
            assert seen[pkg]["ids"] == _ids(r)
        finally:
            hold.close()
    keys = ("ids", "blocks", "counts", "event")
    assert {k: seen["port"][k] for k in keys} == {k: seen["jax"][k] for k in keys}
    assert seen["port"]["event"] == (True, "disk", True) and seen["port"]["blocks"] == 6


class _Garbage(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        body = b"\x00garbage, definitely not an npz"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.mark.parametrize("rung", ["dead_peer", "wedged_peer", "corrupt_payload"])
@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole_blob"])
def test_fallback_ladder_is_the_cold_run(weights, holders, rung, stream):
    """Every failed fetch is a counted miss and the local cold prefill: the
    cold run's ids, no kv_fabric_blocks, a wedged peer bounded by the 0.5 s
    deadline; the JAX fleet's outcome."""
    seen = {}
    for pkg, (_, r) in holders.items():
        stop = lambda: None  # noqa: E731
        if rung == "dead_peer":
            peer = f"http://127.0.0.1:{_free_port()}"  # nothing listens here
        elif rung == "wedged_peer":
            wedge = socket.socket()
            wedge.bind(("127.0.0.1", 0))
            wedge.listen(4)  # accepts, never answers
            peer, stop = f"http://127.0.0.1:{wedge.getsockname()[1]}", wedge.close
        else:
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Garbage)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            peer = f"http://127.0.0.1:{httpd.server_address[1]}"

            def stop(h=httpd):
                h.shutdown()
                h.server_close()
        try:
            seen[pkg] = _pull(weights, pkg, peer, r["kv_digests"][-1],
                              kv_fabric_timeout_s=0.5, kv_fabric_stream=stream)
        finally:
            stop()
        assert seen[pkg]["ids"] == _ids(r)
    keys = ("ids", "blocks", "digests", "counts", "event")
    assert {k: seen["port"][k] for k in keys} == {k: seen["jax"][k] for k in keys}
    assert seen["port"]["blocks"] is None and seen["port"]["counts"] == (1, 0, 1)
    assert seen["port"]["event"][0] is False
    assert seen["port"]["wall"] < 30.0


def test_push_round_trip(weights, holders):
    """The handoff's phase 1 on the holder (prefill_only, pushing to the
    decode replica), then phase 2 on the decode replica with no hint: the
    pushed chain is resident there before phase 2, which promotes it with
    no pull and gives the cold run's ids; the JAX fleets' counts."""
    seen = {}
    for pkg, (hold, r) in holders.items():
        dec = _Replica(weights, pkg, role="decode")
        try:
            p1 = hold.cont.submit(PROMPT, **GEN, prefill_only=True, kv_push_to=dec.url)
            resident = r["kv_digests"][-1] in dec.cont.fabric_digests()
            p2 = dec.cont.submit(PROMPT, **GEN)
            seen[pkg] = (p1["tokens_generated"], p1.get("prefill_only"), p1.get("kv_pushed"),
                         resident, _ids(p2), p2.get("kv_promoted_blocks"),
                         dec.stats()["fetches"], [e["kind"] for e in dec.engine.flight.events()
                                                  if e["kind"] == "fabric_push_in"])
            assert _ids(p2) == _ids(r)
        finally:
            dec.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == (1, True, 6, True) and seen["port"][5:7] == (6, 0)


def test_bucketed_remote_hit(weights, holders):
    """The bucketed whole-prefill admission behind a remote hit: the
    imported chain degrades to a depth the tail bucket fits, as in the
    JAX fleet; the cold run's ids."""
    seen = {}
    for pkg, (rep, r) in holders.items():
        seen[pkg] = _pull(weights, pkg, rep.url, r["kv_digests"][-1],
                          ragged_prefill=False, chunked_prefill=False)
        assert seen[pkg]["ids"] == _ids(r)
    keys = ("ids", "blocks", "depth", "digests", "counts")
    assert {k: seen["port"][k] for k in keys} == {k: seen["jax"][k] for k in keys}
    assert seen["port"]["blocks"] == 6 and seen["port"]["depth"] > 0


def test_port_fleet_imports_a_chain_the_jax_fleet_serves(weights, holders):
    """Cross-package: the JAX holder's fp32 chain ([N, L, KV, bs, Dh]
    leaves k, v in both packages) imported by the port's fleet gives the
    JAX remote hit's ids."""
    jrep, jr = holders["jax"]
    jax_hit = _pull(weights, "jax", jrep.url, jr["kv_digests"][-1])
    got = _pull(weights, "port", jrep.url, jr["kv_digests"][-1])
    assert got["counts"] == (1, 1, 0) and got["blocks"] == jax_hit["blocks"] == 6
    assert got["ids"] == jax_hit["ids"] == _ids(jr)


@pytest.mark.parametrize("pair", ["raw_to_int8", "int8_to_raw", "int8_to_int8"])
@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole_blob"])
def test_chain_of_another_kv_quant_is_refused(weights, holders, pair, stream):
    """A chain between a raw and an int8 pool verifies by its tokens but its
    leaves are not the puller's: refused (a miss, hit false in the flight
    event), never reinterpreted, and the puller's ids are its own cold
    run's. int8 to int8 is a hit with the int8 cold run's ids."""
    src, dst = pair.split("_to_")
    quant = {"raw": None, "int8": "int8"}
    hold = (holders["port"][0] if src == "raw"
            else _Replica(weights, "port", role="prefill", kv_quant="int8"))
    cold = None
    try:
        r = hold.cont.submit(PROMPT, **GEN)
        assert hold.cont._shadow.flush(10.0)
        cold_rep = _Replica(weights, "port", role="mixed", kv_quant=quant[dst])
        try:
            cold = _ids(cold_rep.cont.submit(PROMPT, **GEN))
        finally:
            cold_rep.close()
        got = _pull(weights, "port", hold.url, r["kv_digests"][-1],
                    kv_quant=quant[dst], kv_fabric_stream=stream)
    finally:
        if src != "raw":
            hold.close()
    assert got["ids"] == cold
    if src == dst:
        assert got["counts"] == (1, 1, 0) and got["blocks"] == 6
    else:
        assert got["counts"] == (1, 0, 1) and got["blocks"] is None
        assert got["event"][0] is False


def test_no_kv_fabric_turns_it_off(weights):
    """kv_fabric=False: fabric_serving false, GET /kv/{digest} and POST /kv
    404, no kv block on /health, no kv_digests, a hint ignored; as the JAX
    fleet."""
    seen = {}
    for pkg in PKGS:
        rep = _Replica(weights, pkg, kv_fabric=False)
        try:
            r = rep.cont.submit(PROMPT, **GEN)
            digest = JKF.chain_digest(rep.engine.tokenizer.encode(PROMPT), BS)
            r2 = rep.cont.submit(PROMPT, **GEN,
                                 kv_hint={"peer": f"http://127.0.0.1:{_free_port()}",
                                          "digest": digest})
            health = json.loads(_call(rep.url, "/health")[2])
            seen[pkg] = (rep.cont.fabric_serving, "kv_digests" in r, "kv" in health,
                         _call(rep.url, f"/kv/{digest}")[0],
                         _call(rep.url, "/kv", b"x", method="POST")[0],
                         "kv_fabric" in rep.cont.stats(), _ids(r) == _ids(r2))
        finally:
            rep.close()
    assert seen["port"] == seen["jax"] == (False, False, False, 404, 404, False, True)
