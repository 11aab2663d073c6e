"""PyTorch port vs JAX package: the dense slot fleet (continuous batching
without a block pool) and its whole-prefill admission.

Device level: the same weights (test-llama-tiny, fp32, no EOS), the same
zeroed fleet cache and slot state go through the JAX package's
`insert_slot` (two prompts prefilled on a batch-1 scratch and spliced into
slots 0 and 2, one with a 3-token budget) and `decode_slots`, and through
the port's: greedy tokens, masks and slot state equal, caches within
1e-5; raw and int8 caches (the int8 cache compared after dequantizing,
within one int8 step and 1e-4 relative).

Engine level, mirroring tests/test_continuous.py's cases: the port's
dense ContinuousEngine against the JAX package's on the same weights and
prompts (greedy tokens identical, spelled by an id tokenizer): staggered
admission with more requests than slots, a stop token at once and an
exact max_tokens (zero weights), a greedy and a sampled request sharing
the fleet, an over-long prompt (invalid_request), slot_max_seq bounding
the cache and clamping the budget; raw and with kv_quant="int8". The
port's server serves `--continuous 2` with no pool on the CPU."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import (  # noqa: E402
    SingleDeviceBackend as JaxBackend,
)
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.engine import SingleDeviceBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    cache_from_numpy,
    params_from_numpy,
    slots_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1)
ENGINE = dict(prefill_buckets=(32, 64), prefix_cache_entries=0)
PROMPTS = [
    "the quick brown fox",
    "jumps over",
    "a lazy dog while the band plays on and on",
    "hello",
    "one two three four five six seven eight nine ten eleven",
]
CACHE_ATOL = 1e-5


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _kv(kv_quant):
    return {} if kv_quant is None else {"kv_quant": kv_quant}


# -- device level: insert_slot and decode_slots ------------------------------------


def _assert_cache_close(jcache, tcache, what):
    for name in ("k", "v"):
        a, b = jcache[name], tcache[name]
        if hasattr(a, "q"):
            # int8, dequantized: the fp32 K/V the two packages quantize
            # differ by ~1e-5 relative after a few layers, so an element
            # may round one int8 step apart, on scales ~1e-5 apart
            da = np.asarray(a.q, np.float32) * np.asarray(a.s)[..., None]
            db = (b.q.float() * b.s[..., None]).numpy()
            tol = np.asarray(a.s)[..., None] + CACHE_ATOL + 1e-4 * np.abs(da)
            assert (np.abs(db - da) <= tol).all(), f"{what}: {name}"
            np.testing.assert_allclose(b.s.numpy(), np.asarray(a.s), atol=CACHE_ATOL,
                                       rtol=1e-5, err_msg=f"{what}: {name} scales")
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=CACHE_ATOL,
                                       rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_insert_slot_and_decode_slots_equal_jax(kv_quant):
    jcfg = jax_cfg(MODEL, **OVERRIDES, **_kv(kv_quant))
    tcfg = get_model_config(MODEL, **OVERRIDES, **_kv(kv_quant))
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_numpy(tcfg, _np(params), "cpu")
    jbe, tbe = JaxBackend(jcfg, params), SingleDeviceBackend(tcfg, tparams, "cpu")
    B, S, V = 4, 64, jcfg.vocab_size
    rng = np.random.default_rng(3)
    jcache = jbe.init_cache(B, S)
    tcache = cache_from_numpy(tcfg, _np(jcache), "cpu")
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = slots_from_numpy(_np(jstate), _np(jsp), "cpu")
    sampling = JG.default_sampling(greedy=True)
    key, gen = jax.random.PRNGKey(7), torch.Generator().manual_seed(7)
    knobs = (1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0)
    for slot, plen, mtk in ((0, 11, 12), (2, 5, 3)):
        ids = rng.integers(3, V, plen).astype(np.int32)
        toks = np.full((1, 32), jcfg.pad_token_id, np.int32)
        toks[0, :plen] = ids
        jfirst, _, jscratch = jbe.prefill(jnp.asarray(toks), jnp.int32(plen),
                                          jbe.init_cache(1, S), key, sampling)
        tfirst, _, tscratch = tbe.prefill(torch.from_numpy(toks).long(), plen,
                                          tbe.init_cache(1, S), gen,
                                          G.default_sampling(greedy=True))
        assert int(tfirst[0]) == int(jfirst[0])
        presence = np.zeros(V, bool)
        jcache, jstate, jsp = JG.insert_slot(
            jcfg, jcache, jscratch, jstate, jsp, slot, jfirst[0], jnp.int32(plen),
            jnp.int32(mtk), *knobs, jnp.asarray(presence))
        tcache, tstate, tsp = G.insert_slot(
            tcfg, tcache, tscratch, tstate, tsp, slot, tfirst, plen, mtk, *knobs,
            torch.from_numpy(presence))
        for name, a, b in zip(G.SlotState._fields, jstate, tstate):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        _assert_cache_close(jcache, tcache, f"insert {slot}")
    jem, jmask, jstate, jcache = JG.decode_slots(jcfg, params, jstate, jcache, key,
                                                 jsp, num_steps=6)
    tem, tmask, tstate, tcache = G.decode_slots(tcfg, tparams, tstate, tcache, gen,
                                                tsp, num_steps=6)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for name, a, b in zip(G.SlotState._fields, jstate, tstate):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    _assert_cache_close(jcache, tcache, "decode_slots")
    # slot 2's 3-token budget ran out mid-chunk; slots 1 and 3 stayed silent
    assert tmask.sum(0).tolist() == [6, 0, 2, 0]
    assert tstate.active.tolist() == [True, False, False, False]


# -- engine level: the dense ContinuousEngine ----------------------------------------


@pytest.fixture(scope="module", params=[None, "int8"], ids=["raw", "int8"])
def engines(request):
    kv = _kv(request.param)
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES, **kv), get_model_config(MODEL, **OVERRIDES, **kv)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tok = IdTokenizer()
    jeng = JaxEngine(jcfg, params=params, engine_cfg=JaxEngineConfig(**ENGINE),
                     tokenizer=tok)
    teng = create_engine(tcfg, params=params_from_numpy(tcfg, _np(params), "cpu"),
                         engine_cfg=EngineConfig(**ENGINE), tokenizer=tok, device="cpu")
    return jeng, teng


def _fleets(engines, **kw):
    jeng, teng = engines
    return JaxContinuousEngine(jeng, **kw), ContinuousEngine(teng, **kw)


def _staggered(cont, prompts, together=2, **kw):
    """The first `together` requests at once (they hold every slot at the
    same time however fast a request runs), then one every 50 ms."""
    out = {}

    def run(i, delay):
        time.sleep(delay)
        out[i] = cont.submit(prompts[i], **kw)

    threads = [threading.Thread(target=run, args=(i, 0.05 * max(0, i - together + 1)))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return [out[i] for i in range(len(prompts))]


def test_staggered_admission_identical_to_jax(engines):
    """More requests than slots, the first two together and the rest 50 ms
    apart: slots recycle mid-flight, and every request gets the JAX
    fleet's greedy tokens."""
    jf, tf = _fleets(engines, n_slots=2, chunk_steps=4, max_queue=16)
    try:
        kw = dict(max_tokens=10, greedy=True, chat=False)
        want, got = _staggered(jf, PROMPTS, **kw), _staggered(tf, PROMPTS, **kw)
        for w, g in zip(want, got):
            assert w["status"] == g["status"] == "success", (w, g)
            for key in ("response", "tokens_generated", "prompt_tokens",
                        "finish_reason", "continuous"):
                assert g[key] == w[key], key
            assert g["token_ids"] == [int(t) for t in g["response"].split()]
        st = tf.stats()
        assert "paged" not in st and st["scheduler"] == {"chunked_prefill": False}
        assert st["completed"] == st["admitted"] == len(PROMPTS)
        assert st["occupied"] == 0 and st["peak_occupancy"] == 2
        assert st["launches"]["mixed"] == 0 and st["launches"]["decode_chunks"] >= 3
    finally:
        jf.close()
        tf.close()


def test_mixed_sampling_and_edge_requests_match_jax(engines):
    """A greedy and a sampled request share the fleet (the greedy one
    keeps the JAX tokens); an over-long prompt fails with invalid_request
    in both packages; slot_max_seq sizes the cache and clamps the budget."""
    jf, tf = _fleets(engines, n_slots=2, chunk_steps=4, slot_max_seq=48)
    try:
        greedy = dict(max_tokens=8, greedy=True, chat=False)
        want = jf.submit(PROMPTS[0], **greedy)
        out = {}

        def run(name, prompt, **kw):
            out[name] = tf.submit(prompt, **kw)

        threads = [threading.Thread(target=run, args=("g", PROMPTS[0]), kwargs=greedy),
                   threading.Thread(target=run, args=("s", PROMPTS[1]), kwargs=dict(
                       max_tokens=8, temperature=0.9, top_k=5, top_p=0.9, chat=False))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert out["s"]["status"] == "success" and 1 <= out["s"]["tokens_generated"] <= 8
        assert out["g"]["token_ids"] == [int(t) for t in want["response"].split()]
        # the cache is [L, n_slots, KV, slot_max_seq, Dh], the scratch one row
        assert tf.cache["k"].shape[1:4] == (2, tf.cfg.n_kv_heads, 48)
        assert tf._scratch["k"].shape[1] == 1 and tf._scratch["k"].shape[3] == 48
        over = dict(max_tokens=4, greedy=True, chat=False)
        a, b = jf.submit("x " * 40, **over), tf.submit("x " * 40, **over)
        assert a["status"] == b["status"] == "failed"
        assert a["error_type"] == b["error_type"] == "invalid_request"
        assert "slot capacity" in b["error"]
        a = jf.submit("a b c", max_tokens=400, greedy=True, chat=False)
        b = tf.submit("a b c", max_tokens=400, greedy=True, chat=False)
        assert b["tokens_generated"] == a["tokens_generated"] == 48 - b["prompt_tokens"] - 1
        assert b["response"] == a["response"]
        assert tf.stats()["occupied"] == 0
    finally:
        jf.close()
        tf.close()
    with pytest.raises(ValueError, match="smallest prefill bucket"):
        ContinuousEngine(engines[1], n_slots=2, slot_max_seq=16)


def _zero_engines(eos):
    kw = dict(dtype="float32", eos_token_id=eos, pad_token_id=3)
    jcfg, tcfg = jax_cfg(MODEL, **kw), get_model_config(MODEL, **kw)
    params = jax.tree.map(jnp.zeros_like, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    ecfg = dict(prefill_buckets=(32,), prefix_cache_entries=0)
    jeng = JaxEngine(jcfg, params=params, engine_cfg=JaxEngineConfig(**ecfg))
    teng = create_engine(tcfg, params=params_from_numpy(tcfg, _np(params), "cpu"),
                         engine_cfg=EngineConfig(**ecfg), device="cpu")
    return jeng, teng


def test_stop_token_at_once_and_exact_max_tokens_as_jax():
    """Zero weights: every logit ties, the argmax is token 0. With eos 0 a
    request finishes with no token; with eos 5 exactly max_tokens come
    back, in both packages."""
    for eos, max_tokens, want_n in ((0, 8, 0), (5, 6, 6)):
        jf, tf = _fleets(_zero_engines(eos), n_slots=2, chunk_steps=4)
        try:
            a = jf.submit("hi", max_tokens=max_tokens, greedy=True, chat=False)
            b = tf.submit("hi", max_tokens=max_tokens, greedy=True, chat=False)
            assert a["status"] == b["status"] == "success"
            assert b["tokens_generated"] == a["tokens_generated"] == want_n
            assert b["response"] == a["response"]
            assert b["finish_reason"] == a["finish_reason"]
        finally:
            jf.close()
            tf.close()


def test_server_serves_the_dense_fleet_on_the_cpu():
    from test_torch_continuous import _call, _free_port

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--model", MODEL, "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--continuous", "2", "--continuous-max-seq", "128"],
        cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 90
        while True:
            try:
                if _call(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "server did not come up"
            time.sleep(0.5)
        code, r = _call(port, "/generate", {"prompt": "Hello", "max_tokens": 6,
                                            "greedy": True})
        assert code == 200 and r["status"] == "success", r
        assert r["backend"] == "continuous" and r["continuous"] is True
        assert 1 <= r["tokens_generated"] <= 6 and r["prefill_chunks"] >= 1
        code, st = _call(port, "/stats")
        c = st["continuous"]
        assert code == 200 and c["slots"] == 2 and "paged" not in c
        assert c["scheduler"] == {"chunked_prefill": False}
        assert c["launches"]["decode_chunks"] >= 1 and c["launches"]["mixed"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
