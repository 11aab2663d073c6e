"""PyTorch port vs JAX package: whole-prefill admission on the paged fleet.

With `chunked_prefill=False` an admission's prompt lands whole before its
slot decodes, through ragged launches straight into the pool
(`extend_ragged_paged` / `prefill_ragged_paged` over a one-row table);
with `ragged_prefill=False` it is prefilled on a contiguous scratch cache
through the bucket ladder and scattered into the slot's blocks
(`insert_slot_paged`). Device level: both ingest paths against the JAX
functions on the same pool (first token equal, pool within 1e-5 outside
the trash block). Engine level: the port's fleet in each mode against the
JAX fleet in the same mode and against the port's chunked fleet (the
default), on the same weights (test-llama-tiny, fp32, no EOS) and the
same four prompts, a 301-token one among them: greedy tokens identical,
raw and with an int8 pool, and every pool block free after the fleet
drains."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    cache_from_numpy,
    params_from_numpy,
    slots_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
BASE = dict(prefix_cache_entries=0, step_token_budget=64, prefill_buckets=(64, 128, 256))
MODES = {"ragged": dict(chunked_prefill=False),
         "bucketed": dict(ragged_prefill=False),
         "chunked": dict(chunked_prefill=True)}
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16)
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",
    " ".join(f"ctx{j}" for j in range(24)) + " question one",
    "short",
    "y " * 150,
]
POOL_ATOL = 1e-5


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _kv(kv_quant):
    return {} if kv_quant is None else {"kv_quant": kv_quant}


def _assert_pool_close(jpool, tpool, what):
    for name in ("k", "v"):
        a, b = jpool[name], tpool[name]
        if hasattr(a, "q"):  # int8: compare dequantized, one step apart at most
            a = np.asarray(a.q, np.float32) * np.asarray(a.s)[..., None]
            step = np.asarray(jpool[name].s)[..., None]
            b = (b.q.float() * b.s[..., None]).numpy()
            tol = (step + POOL_ATOL + 1e-4 * np.abs(a))[:, 1:]
            assert (np.abs(b - a)[:, 1:] <= tol).all(), f"{what}: {name}"
        else:
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:],
                                       atol=POOL_ATOL, rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ragged_ingest_and_insert_slot_paged_equal_jax(kv_quant):
    """A 21-token prompt through two 8-wide extend launches and the final
    prefill launch over a one-row table; then a second prompt prefilled
    on a scratch cache and scattered into another row's blocks."""
    jcfg = jax_cfg(MODEL, **OVERRIDES, **_kv(kv_quant))
    tcfg = get_model_config(MODEL, **OVERRIDES, **_kv(kv_quant))
    params = JM.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(tcfg, _np(params), "cpu")
    V, W, bs, MB = jcfg.vocab_size, 8, 8, 4
    rng = np.random.default_rng(6)
    ids = rng.integers(3, V, 21).astype(np.int32)
    row = (rng.permutation(23)[:MB] + 1).astype(np.int32)
    jpool = JP.init_pool(jcfg, 24, bs)
    tpool = cache_from_numpy(tcfg, _np(jpool), "cpu")
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jt, tt = jnp.asarray(row[None]), torch.from_numpy(row[None])
    for c, start in enumerate(range(0, 21, W)):
        chunk = ids[start:start + W]
        meta, tok_row, tok_pos, _, _ = P.build_ragged_meta(
            [(0, start, len(chunk), P.RAGGED_PREFILL)], width=W, tile=8)
        toks = np.zeros(W, np.int32)
        toks[:len(chunk)] = chunk
        ops = (toks, tok_row, tok_pos, meta)
        if start + W < 21:
            jpool = JP.extend_ragged_paged(jcfg, params, *map(jnp.asarray, ops), jpool, jt)
            tpool = P.extend_ragged_paged(tcfg, tparams, *map(torch.from_numpy, ops),
                                          tpool, tt)
            continue
        sampling = JG.default_sampling(greedy=True)
        jfirst, jlogits, jpool = JP.prefill_ragged_paged(
            jcfg, params, *map(jnp.asarray, ops), jpool, jt, jnp.int32(len(chunk) - 1),
            key, sampling)
        tfirst, tlogits, tpool = P.prefill_ragged_paged(
            tcfg, tparams, *map(torch.from_numpy, ops), tpool, tt, len(chunk) - 1,
            gen, G.default_sampling(greedy=True))
        assert tfirst.tolist() == np.asarray(jfirst).tolist()
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    _assert_pool_close(jpool, tpool, "ragged ingest")

    # bucketed: a 10-token prompt on a [1, MB*bs] scratch, scattered into
    # a second row's blocks (its last entry left at the trash block)
    row2 = np.zeros(MB, np.int32)
    row2[:3] = [b for b in range(1, 24) if b not in row][:3]
    toks = np.full((1, 16), jcfg.pad_token_id, np.int32)
    toks[0, :10] = rng.integers(3, V, 10)
    jscratch = JM.init_kv_cache(jcfg, 1, max_seq=MB * bs)
    jfirst, _, jscratch = JG.prefill(jcfg, params, jnp.asarray(toks), jnp.int32(10),
                                     jscratch, key, JG.default_sampling(greedy=True))
    tscratch = cache_from_numpy(tcfg, _np(jscratch), "cpu")
    jstate, jsp = JG.init_slots(2, V)
    tstate, tsp = slots_from_numpy(_np(jstate), _np(jsp), "cpu")
    arm = (10, 6, 1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0)
    jpool, jstate, jsp = JP.insert_slot_paged(
        jcfg, jpool, jscratch, jstate, jsp, 1, jnp.asarray(row2), jfirst[0], *arm,
        jnp.zeros(V, bool))
    tpool, tstate, tsp = P.insert_slot_paged(
        tcfg, tpool, tscratch, tstate, tsp, 1, torch.from_numpy(row2),
        int(jfirst[0]), *arm, torch.zeros(V, dtype=torch.bool))
    for name, a, b in zip(G.SlotState._fields, jstate, tstate):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    _assert_pool_close(jpool, tpool, "insert_slot_paged")


@pytest.fixture(scope="module", params=[None, "int8"], ids=["raw", "int8"])
def setup(request):
    kv = _kv(request.param)
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES, **kv), get_model_config(MODEL, **OVERRIDES, **kv)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np(params), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams, served={})


def _wave(fleet, **kw):
    out = [None] * len(PROMPTS)

    def run(i):
        out[i] = fleet.submit(PROMPTS[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _serve(setup, mode, jax_side=False):
    """The wave's results on a fresh fleet of this mode, and its stats."""
    tok = IdTokenizer()
    ecfg = dict(BASE, **MODES[mode])
    if jax_side:
        eng = JaxEngine(setup["jcfg"], params=setup["params"],
                        engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
        fleet = JaxContinuousEngine(eng, **FLEET)
    else:
        eng = create_engine(setup["tcfg"], params=setup["tparams"],
                            engine_cfg=EngineConfig(**ecfg), tokenizer=tok, device="cpu")
        fleet = ContinuousEngine(eng, **FLEET)
    try:
        return _wave(fleet, max_tokens=8, greedy=True, chat=False), fleet.stats()
    finally:
        fleet.close()


@pytest.mark.parametrize("mode", ["ragged", "bucketed"])
def test_whole_prefill_fleet_identical_to_jax_and_to_chunked(setup, mode):
    want, jstats = _serve(setup, mode, jax_side=True)
    got, st = _serve(setup, mode)
    if "chunked" not in setup["served"]:
        setup["served"]["chunked"] = _serve(setup, "chunked")[0]
    chunked = setup["served"]["chunked"]
    for w, g, c in zip(want, got, chunked):
        assert w["status"] == g["status"] == c["status"] == "success", (w, g, c)
        for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason"):
            assert g[key] == w[key], key
        assert g["token_ids"] == c["token_ids"] == [int(t) for t in w["response"].split()]
    # the 301-token prompt: five 64-wide ragged launches, or one 256-token
    # extend chunk and a 64-token bucket
    assert got[3]["prompt_tokens"] == 301
    assert got[3]["prefill_chunks"] == (5 if mode == "ragged" else 2)
    assert st["paged"]["ragged_prefill"] == jstats["paged"]["ragged_prefill"] \
        == (mode == "ragged")
    assert st["scheduler"] == {"chunked_prefill": False}
    assert st["launches"]["mixed"] == 0 and st["launches"]["decode_chunks"] >= 1
    # every block is back: the pool less its trash block
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    assert st["occupied"] == 0 and st["completed"] == st["admitted"] == len(PROMPTS)
