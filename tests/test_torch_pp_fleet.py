"""The continuous paged fleet over the port's pipeline mesh, against the
JAX fleet over the JAX PipelineBackend on the same mesh shape and weights
(the counterparts of tests/test_paged.py:381-500, test_continuous.py
:371-430 and test_constrained_pp.py), on the CPU: each rank a process,
gloo groups.

Scripted launches hold the programs themselves: `mixed_step_ragged`'s
packed fetch and slot state with and without verify rows, the decode
chunk after it, and the pool's blocks (gathered whole through
`gather_shadow_blocks` on both sides) within POOL_ATOL; the dense slots'
`decode_slots_constrained` bit-exact. Then staggered waves through both
fleets, and the server's --pp flag.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu import MeshConfig as JaxMeshConfig  # noqa: E402
from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.runtime import create_backend as jax_backend  # noqa: E402
from distributed_llm_inference_tpu.runtime import create_engine as jax_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from distributed_llm_inference_tpu_torch.parallel.pipeline import PipelineBackend  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1)
POOL_ATOL = 1e-5
TIMEOUT_S = 10.0
B, W, TILE, BS, MB, N_BLOCKS, K = 4, 64, 8, 8, 4, 24, 8
PROMPT_LENS = {0: 10, 1: 5, 2: 20}
MAX_TOKENS = {0: 24, 1: 7, 2: 16}
# launch -> (prefill chunks (slot, start, n), {slot: n_draft} verify rows,
# plain decode slots)
SCRIPT = [
    ([(0, 0, 10), (1, 0, 5)], {}, []),
    ([(2, 0, 8)], {0: 3}, [1]),
    ([(2, 8, 8)], {0: 8, 1: 2}, []),
    ([(2, 16, 4)], {}, [0, 1]),
]
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog while the band plays on",
           "hello", "one two three four five six seven"]


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pp2(request):
    """The JAX and the port's pp = 2 backends on the same weights."""
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES), get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(tcfg, _np(params), "cpu")
    _, jb = jax_backend(jcfg, mesh_cfg=JaxMeshConfig(pp=2), params=params)
    tb = PipelineBackend(tcfg, tparams, build_mesh(MeshConfig(pp=2), ["cpu"] * 2,
                                                   timeout_s=TIMEOUT_S))
    request.addfinalizer(tb.close)
    return jcfg, tcfg, jb, tb


def _assert_state_equal(jstate, tstate, what):
    for name, a, b in zip(G.SlotState._fields, jstate, tstate):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")


def _assert_blocks_close(jb, tb, jpool, tpool, what):
    """Every non-trash block, all layers and heads, gathered on both."""
    ids = np.arange(1, N_BLOCKS, dtype=np.int32)
    jg = jb.gather_shadow_blocks(jpool, jnp.asarray(ids))
    tg = tb.gather_shadow_blocks(tpool, torch.from_numpy(ids))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tg[leaf].numpy(), np.asarray(jg[leaf]), atol=POOL_ATOL,
                                   rtol=0, err_msg=f"{what}: {leaf}")


def _arm(V, arming, offsets):
    on = np.zeros(B, bool)
    idx, plen, mtk = (np.zeros(B, np.int32) for _ in range(3))
    sp = [np.ones(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32),
          np.ones(B, bool), np.zeros(B, np.float32), np.ones(B, np.float32),
          np.zeros(B, np.float32), np.zeros(B, np.float32)]
    for s, (e, n) in arming.items():
        on[s] = True
        idx[s] = offsets[e] + n - 1
        plen[s], mtk[s] = PROMPT_LENS[s], MAX_TOKENS[s]
    return on, idx, plen, mtk, sp, np.zeros((B, V), bool)


def test_scripted_mixed_launches_equal_jax(pp2):
    """Mixed launches (prompt chunks, decode rows, verify rows of one and
    two tiles with n-gram drafts) through both pp = 2 backends: the packed
    [5, B] fetch (5 + 2(K+1) + 1 rows with verify rows), slot state and
    knobs equal, the pool's blocks within POOL_ATOL; then a decode chunk."""
    jcfg, tcfg, jb, tb = pp2
    rng = np.random.default_rng(13)
    V = jcfg.vocab_size
    prompts = {s: rng.integers(3, V, n).astype(np.int32) for s, n in PROMPT_LENS.items()}
    table = np.zeros((B, MB), np.int32)
    table[:3] = (rng.permutation(N_BLOCKS - 1)[: 3 * MB] + 1).reshape(3, MB)
    jpool, tpool = jb.init_paged_pool(N_BLOCKS, BS), tb.init_paged_pool(N_BLOCKS, BS)
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = G.init_slots(B, V)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    for li, (chunks, verify, dec_slots) in enumerate(SCRIPT):
        pos_now = tstate.pos.numpy()
        rows = sorted(list(verify) + dec_slots)
        entries = [(s, int(pos_now[s]), 1 + verify[s], P.RAGGED_PREFILL) if s in verify
                   else (s, int(pos_now[s]), 1, P.RAGGED_DECODE) for s in rows]
        entries += [(s, start, n, P.RAGGED_PREFILL) for s, start, n in chunks]
        meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W, tile=TILE)
        toks = np.zeros(W, np.int32)
        dec_flag = np.zeros(W, bool)
        dec_idx = np.zeros(B, np.int32)
        sp_on, dec_on = np.zeros(B, bool), np.zeros(B, bool)
        sp_idx, sp_nd = np.zeros((B, K + 1), np.int32), np.zeros(B, np.int32)
        for s, off in zip(rows, offsets):
            dec_flag[off] = True
            if s in verify:
                nd = verify[s]
                sp_on[s], sp_nd[s] = True, nd
                idxs = off + np.arange(K + 1, dtype=np.int32)
                idxs[nd + 1:] = off + nd
                sp_idx[s] = idxs
                toks[off + 1: off + 1 + nd] = rng.integers(3, V, nd)
            else:
                dec_on[s], dec_idx[s] = True, off
        arming = {}
        for e, ((s, start, n), off) in enumerate(zip(chunks, offsets[len(rows):])):
            toks[off: off + n] = prompts[s][start: start + n]
            if start + n == PROMPT_LENS[s]:
                arming[s] = (len(rows) + e, n)
        on, idx, plen, mtk, sp, presence = _arm(V, arming, offsets)
        jarm = JP.MixedArm(*(jnp.asarray(a) for a in (on, idx, plen, mtk)),
                           JG.SlotParams(*(jnp.asarray(a) for a in sp)), jnp.asarray(presence))
        tarm = P.MixedArm(*(torch.from_numpy(a) for a in (on, idx, plen, mtk)),
                          G.SlotParams(*(torch.from_numpy(a) for a in sp)),
                          torch.from_numpy(presence))
        ops = (toks, tok_row, tok_pos, dec_flag, meta)
        jspec = tspec = None
        if verify:
            plan = (dec_on, sp_on, sp_idx, sp_nd)
            jspec = JP.SpecPlan(*(jnp.asarray(a) for a in plan))
            tspec = P.SpecPlan(*(torch.from_numpy(a) for a in plan))
        jpacked, jstate, jsp, jpool = jb.mixed_step_ragged(
            *(jnp.asarray(a) for a in ops), jpool, jtable, jstate, jsp, key,
            jnp.asarray(dec_idx), jarm, spec=jspec)
        tpacked, tstate, tsp, tpool = tb.mixed_step_ragged(
            *(torch.from_numpy(a) for a in ops), tpool, ttable, tstate, tsp, gen,
            torch.from_numpy(dec_idx), tarm, spec=tspec)
        what = f"launch {li + 1}"
        assert tpacked.shape == (5 + (2 * (K + 1) + 1 if verify else 0), B)
        np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked), err_msg=what)
        _assert_state_equal(jstate, tstate, what)
        for name, a, b in zip(G.SlotParams._fields, jsp, tsp):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")
        _assert_blocks_close(jb, tb, jpool, tpool, what)
    jem, jmask, jstate, jpool = jb.decode_slots_paged(jstate, jpool, jtable, key, jsp,
                                                      num_steps=4)
    tem, tmask, tstate, tpool = tb.decode_slots_paged(tstate, tpool, ttable, gen, tsp,
                                                      num_steps=4)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _assert_state_equal(jstate, tstate, "decode chunk")
    _assert_blocks_close(jb, tb, jpool, tpool, "decode chunk")


def test_shadow_blocks_restore_round_trip(pp2):
    """restore_shadow_blocks lands whole-model blocks on each rank's layers
    and heads: gathered back, they are bit-equal."""
    _, tcfg, _, tb = pp2
    pool = tb.init_paged_pool(8, BS)
    g = torch.Generator().manual_seed(3)
    blocks = {n: torch.randn((2, tcfg.n_layers, tcfg.n_kv_heads, BS, tcfg.head_dim),
                             generator=g) for n in ("k", "v")}
    ids = torch.tensor([3, 5], dtype=torch.int32)
    tb.restore_shadow_blocks(pool, blocks, ids)
    back = tb.gather_shadow_blocks(pool, ids)
    for n in ("k", "v"):
        assert torch.equal(back[n], blocks[n])
    assert [tuple(x.shape) for x in tb.pool_layout(pool)] == \
        [(tcfg.n_layers, 8, tcfg.n_kv_heads, BS, tcfg.head_dim)] * 2


def test_decode_slots_constrained_bit_exact(pp2):
    """Dense slots armed from a pp prefill, then constrained decode chunks
    through both backends: tokens, masks, state and FSM states equal."""
    jcfg, tcfg, jb, tb = pp2
    V = jcfg.vocab_size
    cmask = np.zeros((2, V), bool)
    cmask[0, 10:40] = True
    cmask[1, 100:200] = True
    ctrans = np.zeros((2, V), np.int32)
    ctrans[0, :] = 1
    rng = np.random.default_rng(2)
    toks = rng.integers(3, V, (1, 12)).astype(np.int32)
    knobs_j = (jnp.float32(1.0), jnp.int32(0), jnp.float32(1.0), True, jnp.float32(0.0),
               jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0), jnp.zeros((V,), bool))
    knobs_t = (1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0, torch.zeros((V,), dtype=torch.bool))
    samp_j, samp_t = JG.default_sampling(greedy=True), G.default_sampling(greedy=True)
    jscratch = jb.init_cache(1, 32)
    jf, _, jscratch = jb.prefill(jnp.asarray(toks), jnp.int32(12), jscratch,
                                 jax.random.PRNGKey(0), samp_j)
    tscratch = tb.init_cache(1, 32)
    tf, _, _ = tb.prefill(torch.from_numpy(toks).long(), 12, tscratch, torch.Generator(),
                          samp_t)
    assert int(tf[0]) == int(jf[0])
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = G.init_slots(B, V)
    jcache, tcache = jb.init_cache(B, 32), tb.init_cache(B, 32)
    jcache, jstate, jsp = JG.insert_slot(jcfg, jcache, jscratch, jstate, jsp, 1, jf[0],
                                         jnp.int32(12), jnp.int32(12), *knobs_j)
    _, tstate, tsp = tb.insert_slot(tcache, tscratch, tstate, tsp, 1, tf[0], 12, 12,
                                    *knobs_t)
    jfsm, tfsm = jnp.zeros((B,), jnp.int32), torch.zeros((B,), dtype=torch.int32)
    for _ in range(2):
        jem, jmask, jstate, jcache, jfsm = jb.decode_slots_constrained(
            jstate, jcache, jax.random.PRNGKey(1), jsp, jfsm, jnp.asarray(cmask),
            jnp.asarray(ctrans), num_steps=4)
        tem, tmask, tstate, _, tfsm = tb.decode_slots_constrained(
            tstate, tcache, torch.Generator(), tsp, tfsm, torch.from_numpy(cmask),
            torch.from_numpy(ctrans), num_steps=4)
        np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tfsm.numpy(), np.asarray(jfsm))
        _assert_state_equal(jstate, tstate, "constrained chunk")
    emitted = tem.numpy()[tmask.numpy()]
    assert len(emitted) and all(10 <= t < 40 or 100 <= t < 200 for t in emitted)


def _staggered(fleet, prompts, **kw):
    out = {}

    def run(i):
        time.sleep(0.05 * i)
        out[i] = fleet.submit(prompts[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return [out[i] for i in range(len(prompts))]


@pytest.mark.parametrize("pp,kv_quant", [(2, None), (3, "int8")], ids=["pp2", "pp3-int8"])
def test_paged_fleet_greedy_ids_equal_jax(pp, kv_quant):
    """A staggered wave (more requests than slots, 50 ms apart) through the
    paged fleet over pp stages (4 layers; pp = 3 with an int8 pool): every
    request gets the JAX fleet's greedy ids on the same mesh shape; the
    launches ran eagerly."""
    ov = dict(OVERRIDES, kv_quant=kv_quant)
    jcfg, tcfg = jax_cfg(MODEL, **ov), get_model_config(MODEL, **ov)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tok = IdTokenizer()
    ecfg = dict(prefix_cache_entries=0)
    jeng = jax_engine(jcfg, params=params, mesh_cfg=JaxMeshConfig(pp=pp),
                      engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok)
    teng = create_engine(tcfg, params=params_from_numpy(tcfg, _np(params), "cpu"),
                         mesh_cfg=MeshConfig(pp=pp), engine_cfg=EngineConfig(**ecfg),
                         tokenizer=tok, device="cpu")
    kw = dict(n_slots=2, chunk_steps=4, kv_pool_blocks=40, kv_block_size=8,
              slot_max_seq=128)
    req = dict(max_tokens=10, greedy=True, chat=False)
    try:
        jf = JaxContinuousEngine(jeng, **kw)
        try:
            want = _staggered(jf, PROMPTS, **req)
        finally:
            jf.close()
        tf = ContinuousEngine(teng, **kw)
        try:
            got = _staggered(tf, PROMPTS, **req)
            st = tf.stats()
        finally:
            tf.close()
        for w, g in zip(want, got):
            assert w["status"] == g["status"] == "success", (w, g)
            assert g["response"] == w["response"]
            assert g["tokens_generated"] == w["tokens_generated"]
        assert st["completed"] == len(PROMPTS)
        assert st["launches"]["mixed"] >= 1
        assert all(g["captures"] == 0 for g in st["graphs"].values())
        assert teng.backend.wire_bytes["microstep"] > 0
        snap = teng.metrics.snapshot()["dli_pp_wire_bytes_total"]["series"]
        assert sum(s["value"] for s in snap) == sum(teng.backend.wire_bytes.values())
    finally:
        teng.backend.close()


def test_server_pp2_answers_with_the_single_device_ids():
    """The server with --pp 2 --continuous 4 --kv-pool-blocks serves
    /generate with the single device's greedy ids on the same seeded
    weights and lists two ranks on /workers; SIGTERM joins both."""
    from test_torch_continuous import _call, _free_port

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--model", MODEL, "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
         "--port", str(port), "--pp", "2", "--continuous", "4", "--kv-pool-blocks", "48",
         "--continuous-max-seq", "128"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
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
        code, r = _call(port, "/generate", {"prompt": "Hello there", "max_tokens": 6,
                                            "greedy": True, "chat": False})
        assert code == 200 and r["status"] == "success", r
        assert r["continuous"] is True
        code, wk = _call(port, "/workers")
        assert code == 200 and wk["worker_1"] == wk["worker_2"] == "online", wk
        ranks = [rk for s in wk["detail"] for rk in s["ranks"]]
        assert sorted(rk["rank"] for rk in ranks) == [0, 1]
        assert all(rk["status"] == "online" for rk in ranks)
        solo = create_engine(MODEL, dtype="float32", device="cpu",
                             engine_cfg=EngineConfig(prefix_cache_entries=0))
        want = solo.generate("Hello there", max_tokens=6, greedy=True, chat=False)
        assert r["response"] == want["response"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert proc.returncode is not None
