"""PyTorch port vs JAX package: speculation on the mixed launch.

The same inputs (numpy, from seeds) go through the JAX package's
speculation functions and the port's, on test-llama-tiny in fp32 with no
EOS (the verify units keep the preset's EOS id 2), the weights carried
over by models/bridge.py (the draft model's too):

  * `spec_verify` on the windows, drafts, draft lengths and live /
    budget / EOS patterns of tests/test_spec_fleet.py: equal state and
    equal spec_emit / mask / adv;
  * scripted `mixed_step_ragged` launches with a SpecPlan (verify rows of
    one and two query tiles beside plain decode rows and prompt chunks),
    with n-gram drafts in the flat tokens and with a draft model's
    proposals (`mixed_fill_draft`, `draft_propose_paged`), host-planned
    and device-derived positions: packed results and state equal, the
    target and the draft pool within POOL_ATOL;
  * the fleet: greedy ids of the port's speculating fleet (device-meta,
    host-planned, draft model) equal its plain fleet's and the JAX
    fleet's; an identical draft accepts every drafted token the budget
    leaves room for; a crash and a preemption mid-speculation answer in
    full with the plain fleet's ids; the `/stats` and envelope keys are
    the JAX fleet's; a speculative request stays in a spec-capable fleet
    and goes to the solo engine (which refuses it) on a dense one.

Acceptance counts that depend on thread timing are not asserted."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from distributed_llm_inference_tpu_torch.utils import faults  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
POOL_ATOL = 1e-5
TILE = 8
# tests/test_spec_fleet.py's prompts: a fully periodic stream the n-gram
# planner drafts on, two others and a short one
REPEAT_PROMPT = "the cat sat on the mat " * 10
MIXED_PROMPTS = [REPEAT_PROMPT, "the quick brown fox jumps over the lazy dog",
                 "abc xyz " * 14, "short"]
ENGINE = dict(chunked_prefill=True, prefix_cache_entries=0, step_token_budget=64,
              prefill_buckets=(64, 128, 256))
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16, restart_backoff_s=0.01)
GREEDY = dict(max_tokens=12, greedy=True, chat=False)


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id, so that a
    JAX fleet's response pins its exact token ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(autouse=True)
def _always_disarm():
    faults.disarm()
    yield
    faults.disarm()


# -- spec_verify ------------------------------------------------------------


def _verify_both(window, draft, n_draft, live, state_np):
    """spec_verify of both packages on the same numpy operands."""
    jcfg, tcfg = jax_cfg(MODEL), get_model_config(MODEL)  # eos_token_id 2
    jstate = JG.SlotState(*(jnp.asarray(a) for a in state_np))
    tstate, _ = slots_from_numpy(state_np, [np.asarray(a) for a in JG.init_slots(
        len(live), jcfg.vocab_size)[1]], "cpu")
    ops = [np.asarray(window, np.int32), np.asarray(draft, np.int32),
           np.asarray(n_draft, np.int32), np.asarray(live, bool)]
    j = JP.spec_verify(jcfg, jstate, *(jnp.asarray(a) for a in ops))
    t = P.spec_verify(tcfg, tstate, *(torch.from_numpy(a) for a in ops))
    return j, t


def _assert_verify_equal(j, t):
    (jstate, jemit, jmask, jadv), (tstate, temit, tmask, tadv) = j, t
    _assert_state_equal(jstate, tstate, "spec_verify")
    assert temit.dtype == tadv.dtype == torch.int32 and tmask.dtype == torch.bool
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tadv.numpy(), np.asarray(jadv))


def _one_slot(remaining, V=256):
    state = [np.array(a) for a in JG.init_slots(1, V)[0]]
    state[0] = np.asarray([5], np.int32)  # token
    state[1] = np.asarray([10], np.int32)  # pos
    state[2] = np.asarray([True])  # active
    state[3] = np.asarray([remaining], np.int32)
    return state


@pytest.mark.parametrize(
    "window,draft,n_draft,remaining",
    [
        ([5, 6, 7, 8, 9], [5, 6, 7, 8], 4, 20),  # full accept + correction
        ([5, 6, 7, 8, 9], [5, 9, 7, 8], 4, 20),  # partial accept
        ([5, 6, 7, 8, 9], [1, 2, 3, 4], 4, 20),  # all rejected
        ([5, 2, 7, 8, 9], [5, 2, 7, 8], 4, 20),  # EOS (id 2) mid-window
        ([2, 6, 7, 8, 9], [5, 6, 7, 8], 4, 20),  # EOS first
        ([5, 6, 7, 8, 9], [5, 6, 7, 8], 4, 3),  # the budget clamps
        ([5, 6, 2, 8, 9], [5, 6, 2, 8], 4, 2),  # budget before the EOS
        ([5, 6, 7, 8, 9], [5, 6, 0, 0], 2, 20),  # short draft
    ],
)
def test_spec_verify_matches_slot_step_semantics(window, draft, n_draft, remaining):
    state = _one_slot(remaining)
    # presence / counts carry some history, so their updates are compared
    state[4][0, [5, 40]] = True
    state[5][0, 5] = 3
    j, t = _verify_both([window], [draft], [n_draft], [True], state)
    _assert_verify_equal(j, t)


def test_spec_verify_inactive_and_off_rows_frozen():
    V = 256
    state = [np.array(a) for a in JG.init_slots(2, V)[0]]
    state[2] = np.asarray([False, True])
    state[3] = np.asarray([0, 5], np.int32)
    state[1] = np.asarray([3, 7], np.int32)
    # row 0: on but inactive on the device; row 1: no verify row at all
    j, t = _verify_both([[5, 6], [5, 6]], [[5], [5]], [1, 1], [False, False], state)
    _assert_verify_equal(j, t)
    assert not t[2].any()
    assert t[0].pos.tolist() == [3, 7] and t[0].remaining.tolist() == [0, 5]


# -- scripted launches ----------------------------------------------------------

B, N_BLOCKS, BS, MB = 4, 40, 8, 8
W = 48
K = 8  # the largest draft: a verify row of 9 tokens spans two query tiles
PROMPT_LENS = {0: 10, 1: 5, 2: 20}
MAX_TOKENS = {0: 24, 1: 7, 2: 6}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    tcfg = get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tparams


def _state_np(state):
    return [np.asarray(a) for a in state]


def _assert_state_equal(jstate, tstate, what):
    for name, a, b in zip(G.SlotState._fields, jstate, tstate):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")


def _assert_pool_close(jpool, tpool, what):
    for leaf in ("k", "v"):
        a = np.asarray(jpool[leaf])[:, P.TRASH_BLOCK + 1:]
        b = tpool[leaf].numpy()[:, P.TRASH_BLOCK + 1:]
        np.testing.assert_allclose(b, a, atol=POOL_ATOL, rtol=0, err_msg=f"{what}: {leaf}")


def _arm(V, arming, offsets, prompts):
    """numpy MixedArm operands (all greedy) for the slots whose last chunk
    rides this launch: {slot: (entry index, chunk length)}."""
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


# launch -> (prefill chunks (slot, start, n), {slot: n_draft} verify rows,
# plain decode slots)
SCRIPT = [
    ([(0, 0, 10), (1, 0, 5)], {}, []),
    ([(2, 0, 8)], {0: 3}, [1]),  # a one-tile verify row
    ([(2, 8, 8)], {0: 8, 1: 2}, []),  # K = 8: two tiles, tile_off 8
    ([(2, 16, 4)], {1: 5}, [0]),  # slot 1's 7-token budget runs out
]


@pytest.mark.parametrize("device_meta", [False, True], ids=["host_meta", "device_meta"])
@pytest.mark.parametrize("drafts", ["ngram", "draft_model"])
def test_scripted_spec_launches_equal_jax(model, device_meta, drafts):
    """Scripted mixed launches with verify rows, then a decode chunk, through
    both packages: packed, state and knobs equal, the pool (and the draft
    pool with the draft chain's proposals) within POOL_ATOL."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(13)
    V = jcfg.vocab_size
    draft_model = drafts == "draft_model"
    prompts = {s: rng.integers(3, V, n).astype(np.int32) for s, n in PROMPT_LENS.items()}
    table = np.zeros((B, MB), np.int32)
    table[:3] = (rng.permutation(N_BLOCKS - 1)[: 3 * MB] + 1).reshape(3, MB)
    jpool = JP.init_pool(jcfg, N_BLOCKS, BS)
    tpool = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jpool), "cpu")
    # the draft model: the target's own weights, its own pool
    jdpool = JP.init_pool(jcfg, N_BLOCKS, BS)
    tdpool = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jdpool), "cpu")
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = slots_from_numpy(_state_np(jstate), _state_np(jsp), "cpu")
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    accepted = 0
    for li, (chunks, verify, dec_slots) in enumerate(SCRIPT):
        pos_now = tstate.pos.numpy()
        rows = sorted(list(verify) + dec_slots)
        entries = []
        for s in rows:
            start = 0 if device_meta else int(pos_now[s])
            if s in verify:
                entries.append((s, start, 1 + verify[s], P.RAGGED_PREFILL))
            else:
                entries.append((s, start, 1, P.RAGGED_DECODE))
        entries += [(s, start, n, P.RAGGED_PREFILL) for s, start, n in chunks]
        meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W,
                                                                 tile=TILE)
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
                if not draft_model:  # n-gram drafts: host tokens
                    toks[off + 1: off + 1 + nd] = rng.integers(3, V, nd)
            else:
                dec_on[s], dec_idx[s] = True, off
        arming = {}
        for e, ((s, start, n), off) in enumerate(zip(chunks, offsets[len(rows):])):
            toks[off: off + n] = prompts[s][start: start + n]
            if start + n == PROMPT_LENS[s]:
                arming[s] = (len(rows) + e, n)
        on, idx, plen, mtk, sp, presence = _arm(V, arming, offsets, prompts)
        jarm = JP.MixedArm(*(jnp.asarray(a) for a in (on, idx, plen, mtk)),
                           JG.SlotParams(*(jnp.asarray(a) for a in sp)),
                           jnp.asarray(presence))
        tarm = P.MixedArm(*(torch.from_numpy(a) for a in (on, idx, plen, mtk)),
                          G.SlotParams(*(torch.from_numpy(a) for a in sp)),
                          torch.from_numpy(presence))
        jdev = tdev = None
        if device_meta:
            dev = P.build_device_meta(entries, offsets, len(rows), width=W, tile=TILE)
            jdev = JP.DeviceMeta(*(jnp.asarray(a) for a in dev))
            tdev = P.DeviceMeta(*(torch.from_numpy(a) for a in dev))
        ops = (toks, tok_row, tok_pos, dec_flag, meta)
        jops = [jnp.asarray(a) for a in ops]
        tops = [torch.from_numpy(a) for a in ops]
        what = f"{drafts} launch {li + 1}"
        jspec = tspec = jprops = tprops = None
        if draft_model:
            jdpool = JP.mixed_fill_draft(jcfg, jparams, *jops, jdpool, jtable,
                                         jstate.token, jstate.pos, dev=jdev)
            tdpool = P.mixed_fill_draft(tcfg, tparams, *tops, tdpool, ttable,
                                        tstate.token, tstate.pos, dev=tdev)
            if verify:
                jprops, jdpool = JP.draft_propose_paged(
                    jcfg, jparams, jstate.token, jstate.pos, jdpool, jtable, draft_len=K)
                tprops, tdpool = P.draft_propose_paged(
                    tcfg, tparams, tstate.token, tstate.pos, tdpool, ttable, draft_len=K)
                assert tprops.dtype == torch.int32
                np.testing.assert_array_equal(tprops.numpy(), np.asarray(jprops),
                                              err_msg=what)
            _assert_pool_close(jdpool, tdpool, what + ": draft pool")
        if verify:
            plan = (dec_on, sp_on, sp_idx, sp_nd)
            jspec = JP.SpecPlan(*(jnp.asarray(a) for a in plan))
            tspec = P.SpecPlan(*(torch.from_numpy(a) for a in plan))
        jpacked, jstate, jsp, jpool = JP.mixed_step_ragged(
            jcfg, jparams, *jops, jpool, jtable, jstate, jsp, key,
            jnp.asarray(dec_idx), jarm, spec=jspec, spec_toks=jprops, dev=jdev)
        tpacked, tstate, tsp, tpool = P.mixed_step_ragged(
            tcfg, tparams, *tops, tpool, ttable, tstate, tsp, gen,
            torch.from_numpy(dec_idx), tarm, spec=tspec, spec_toks=tprops, dev=tdev)
        rows_want = 5 + (2 * (K + 1) + 1 if verify else 0)
        assert tpacked.shape == (rows_want, B) and tpacked.dtype == torch.int32
        np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked), err_msg=what)
        _assert_state_equal(jstate, tstate, what)
        for name, a, b in zip(G.SlotParams._fields, jsp, tsp):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")
        _assert_pool_close(jpool, tpool, what)
        if verify:
            sp_mask = tpacked[5 + K + 1: 5 + 2 * (K + 1)].numpy().astype(bool)
            accepted += sum(max(0, int(sp_mask[:, s].sum()) - 1) for s in verify)
    if draft_model:
        # the draft is the target itself, so it accepts every drafted token
        # the budget leaves room for: slot 0 (24 tokens) 3, then 8; slot 1
        # (7 tokens) 2, then 1 of 5 (it had 2 tokens left: the accepted
        # one and the correction)
        assert accepted == 3 + 8 + 2 + 1, accepted
        assert tstate.active.tolist() == [True, False, True, False]
    jem, jmask, jstate, jpool = JP.decode_slots_paged(
        jcfg, jparams, jstate, jpool, jtable, key, jsp, num_steps=4)
    tem, tmask, tstate, tpool = P.decode_slots_paged(
        tcfg, tparams, tstate, tpool, ttable, gen, tsp, num_steps=4)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _assert_state_equal(jstate, tstate, "decode chunk")
    _assert_pool_close(jpool, tpool, "decode chunk")


# -- the fleet ------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """test-llama-tiny's JAX params (PRNGKey 0) and the same weights for the
    port, with the JAX plain fleet's greedy ids on MIXED_PROMPTS."""
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    tcfg = get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    fleet = _jax_fleet(jcfg, params, spec=False)
    try:
        want = [fleet.submit(p, **GREEDY) for p in MIXED_PROMPTS]
    finally:
        fleet.close()
    assert all(r["status"] == "success" for r in want)
    return jcfg, params, tcfg, tparams, [[int(t) for t in r["response"].split()]
                                         for r in want]


def _ecfg(spec, **kw):
    return {**ENGINE, "spec_decode": spec, "spec_draft_len": 4 if spec else 0, **kw}


def _jax_fleet(jcfg, params, spec, draft=False, **kw):
    fleet_kw = {k: kw.pop(k) for k in list(kw) if k in FLEET}
    eng = JaxEngine(jcfg, params=params, tokenizer=IdTokenizer(),
                    engine_cfg=JaxEngineConfig(**_ecfg(spec, **kw)))
    if draft:
        eng.set_draft(jcfg, params)
    return JaxContinuousEngine(eng, **{**FLEET, **fleet_kw})


def _port_fleet(tcfg, tparams, spec, draft=False, **kw):
    fleet_kw = {k: kw.pop(k) for k in list(kw) if k in FLEET}
    eng = create_engine(tcfg, params=tparams, engine_cfg=EngineConfig(**_ecfg(spec, **kw)),
                        tokenizer=IdTokenizer(), device="cpu")
    if draft:
        eng.set_draft(tcfg, tparams)
    return ContinuousEngine(eng, **{**FLEET, **fleet_kw})


def _wave(fleet, prompts, **kw):
    out = [None] * len(prompts)

    def run(i):
        out[i] = fleet.submit(prompts[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


MODES = {
    "devmeta": dict(),
    "legacy": dict(spec_device_meta=False),
    "draft_model": dict(spec_draft_model=MODEL),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_fleet_greedy_ids_equal_plain_and_jax(weights, mode):
    """The speculating fleet serves the plain fleet's and the JAX fleet's
    greedy ids, one request at a time and as a threaded wave, with verify
    rows launched; every pool block comes back."""
    jcfg, params, tcfg, tparams, want = weights
    draft = mode == "draft_model"
    plain = _port_fleet(tcfg, tparams, spec=False)
    try:
        got_plain = [plain.submit(p, **GREEDY)["token_ids"] for p in MIXED_PROMPTS]
    finally:
        plain.close()
    assert got_plain == want
    fleet = _port_fleet(tcfg, tparams, spec=True, draft=draft, **MODES[mode])
    try:
        seq = [fleet.submit(p, **GREEDY) for p in MIXED_PROMPTS]
        wave = _wave(fleet, MIXED_PROMPTS, **GREEDY)
        # a request answers before the launches pipelined behind its last
        # token are fetched: wait, a few seconds at most, for them to drain
        deadline = time.time() + 5.0
        while (fleet.stats()["speculative"]["inflight_rows"]
               and time.time() < deadline):
            time.sleep(0.01)
        st = fleet.stats()
    finally:
        fleet.close()
    for r in seq + wave:
        assert r["status"] == "success" and r["continuous"] is True, r
        # the envelope marks a request that launched verify rows
        assert ("speculative" in r) == (r.get("spec_drafted", 0) > 0), r
        if "speculative" in r:
            assert r["speculative"] is True and r["spec_path"] == "fleet"
            assert r["spec_drafted"] >= r["spec_accepted"] >= 0
    assert seq[0]["spec_drafted"] > 0  # the periodic stream speculated
    assert [r["token_ids"] for r in seq] == want
    assert [r["token_ids"] for r in wave] == want
    sb = st["speculative"]
    assert sb["mode"] == ("draft_model" if draft else "ngram")
    assert sb["device_meta"] == (mode != "legacy") and sb["fleet_wide"] is True
    assert sb["launches"] > 0 and sb["drafted_tokens"] > 0, sb
    assert sb["inflight_rows"] == 0
    if mode == "legacy":
        assert sb["pipelined_launches"] == 0  # one verify row per round trip
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    kinds = {"decode_chunk", "mixed_launch", "mixed_spec"}
    assert set(st["graphs"]) == kinds | ({"draft_fill", "draft_propose"} if draft else set())


def test_identical_draft_accepts_every_drafted_token(weights):
    """A draft model that IS the target proposes the target's own argmax,
    so every drafted token is accepted, in both packages, except where the
    budget leaves no room: one request at a time on the host-planned
    discipline, only its last verify row can fall short. The /stats
    speculative block and the envelope carry the JAX fleet's keys."""
    jcfg, params, tcfg, tparams, want = weights
    prompts = MIXED_PROMPTS[:2]
    kw = dict(spec_draft_model=MODEL, spec_device_meta=False)
    out = {}
    for name, make, p in (("jax", _jax_fleet, (jcfg, params)),
                          ("port", _port_fleet, (tcfg, tparams))):
        fleet = make(*p, spec=True, draft=True, **kw)
        try:
            rs = [fleet.submit(q, **GREEDY) for q in prompts]
            out[name] = (rs, fleet.stats()["speculative"])
        finally:
            fleet.close()
    for name, (rs, sb) in out.items():
        assert sb["mode"] == "draft_model" and sb["accepted_tokens"] > 0, (name, sb)
        for r in rs:
            assert r["status"] == "success" and r["spec_path"] == "fleet", (name, r)
            assert 0 <= r["spec_drafted"] - r["spec_accepted"] <= 4, (name, r)
    (jrs, jsb), (trs, tsb) = out["jax"], out["port"]
    assert set(tsb) == set(jsb)
    spec_keys = ("speculative", "spec_path", "spec_drafted", "spec_accepted")
    for jr, tr, ids in zip(jrs, trs, want):
        assert [int(t) for t in jr["response"].split()] == tr["token_ids"] == ids
        assert {k for k in jr if k.startswith("spec")} == {
            k for k in tr if k.startswith("spec")} == set(spec_keys)


def _serve(tcfg, tparams, spec, prompts, rules=None, **kw):
    faults.disarm()
    fleet = _port_fleet(tcfg, tparams, spec, **kw)
    try:
        if rules:
            faults.arm(rules)
        out = [fleet.submit(p, **GREEDY) for p in prompts]
        return out, fleet.stats()
    finally:
        faults.disarm()
        fleet.close()


@pytest.mark.parametrize("devmeta", [True, False], ids=["devmeta", "legacy"])
def test_crash_mid_spec_salvages_the_plain_ids(weights, devmeta):
    """A scheduler crash while verify rows are in flight: every request
    answers in full with the fault-free plain fleet's (and the JAX fleet's)
    ids; unfetched verify emissions drop as unfetched chunks do."""
    _, _, tcfg, tparams, want = weights
    prompts = MIXED_PROMPTS[:2]
    got, st = _serve(tcfg, tparams, True, prompts,
                     rules=[faults.FaultRule("decode_launch", "transient", on_call=4)],
                     spec_device_meta=devmeta)
    assert st["supervisor"]["restarts"] >= 1
    assert st["speculative"]["launches"] > 0
    for r, ids in zip(got, want):
        assert r["status"] == "success" and r["token_ids"] == ids, r
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    assert set(st["graphs"]) == {"decode_chunk", "mixed_launch", "mixed_spec"}


def test_preemption_mid_spec_keeps_the_plain_ids(weights):
    """A pool-pressure preemption landing on a speculating decoder: it
    resumes with the plain fleet's ids (in-flight verify emissions drop
    behind the drop_seq barrier and are regenerated)."""
    _, _, tcfg, tparams, _ = weights
    kw = dict(kv_pool_blocks=24, n_slots=2, slot_max_seq=256,
              preempt_policy="recompute", kv_shadow=False, kv_fabric=False)

    def serve(spec):
        fleet = _port_fleet(tcfg, tparams, spec, **kw)
        try:
            fleet.submit("warm", max_tokens=2, greedy=True, chat=False)
            out = [None, None]
            started = threading.Event()

            def decoder():
                started.set()
                out[0] = fleet.submit(REPEAT_PROMPT, max_tokens=24, greedy=True,
                                      chat=False)

            def long_prompt():
                started.wait(10)
                for _ in range(200):  # wait until the decoder decodes
                    st = fleet.stats()
                    if st["occupied"] >= 1 and st["scheduler"]["prefilling"] == 0:
                        break
                    time.sleep(0.02)
                out[1] = fleet.submit("z " * 120, max_tokens=4, greedy=True,
                                      chat=False)

            threads = [threading.Thread(target=decoder),
                       threading.Thread(target=long_prompt)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return out, fleet.stats()
        finally:
            fleet.close()

    plain, pst = serve(False)
    spec, sst = serve(True)
    assert all(r is not None and r["status"] == "success" for r in plain + spec)
    # the eviction really landed (else this pins nothing)
    assert pst["preemption"]["preempted_total"] > 0
    assert sst["preemption"]["preempted_total"] > 0
    assert [r["token_ids"] for r in spec] == [r["token_ids"] for r in plain]
    assert sst["paged"]["free_blocks"] == kw["kv_pool_blocks"] - 1


def test_speculative_requests_route_like_jax(weights):
    """"speculative": true stays in a spec-capable fleet (spec_decode off)
    and matches the plain stream; a seeded one and one on a fleet that
    cannot speculate (the dense fleet, or spec_draft_len 0) go to the solo
    engine, which speculates there (prompt lookup, `spec_path` "solo") with
    the plain stream's ids, as the JAX fleet routes them. A sampled
    request stays in the fleet and never speculates."""
    _, _, tcfg, tparams, want = weights
    fleet = _port_fleet(tcfg, tparams, spec=False,
                        **{"spec_draft_len": 4, "spec_decode": False})
    try:
        assert fleet.stats()["speculative"]["fleet_wide"] is False
        plain = fleet.submit(REPEAT_PROMPT, **GREEDY)
        spec = fleet.submit(REPEAT_PROMPT, **GREEDY, speculative=True)
        sampled = fleet.submit(REPEAT_PROMPT, max_tokens=6, temperature=0.9,
                               chat=False, speculative=True)
        seeded = fleet.submit(REPEAT_PROMPT, **GREEDY, speculative=True, seed=7)
        st = fleet.stats()
    finally:
        fleet.close()
    assert plain["token_ids"] == spec["token_ids"] == want[0]
    assert "speculative" not in plain
    assert spec["continuous"] is True and spec["spec_path"] == "fleet"
    assert spec["spec_drafted"] > 0 and st["speculative"]["launches"] > 0
    assert sampled["continuous"] is True and "speculative" not in sampled
    tok = IdTokenizer()
    want_text = tok.decode(want[0])
    assert seeded["status"] == "success" and seeded["speculative"] is True
    assert seeded["spec_path"] == "solo" and "continuous" not in seeded
    assert seeded["response"] == want_text
    for fl in (ContinuousEngine(create_engine(tcfg, params=tparams, device="cpu",
                                              tokenizer=tok),
                                n_slots=2, slot_max_seq=256),
               _port_fleet(tcfg, tparams, spec=False)):
        try:
            assert "speculative" not in fl.stats()
            r = fl.submit(REPEAT_PROMPT, **GREEDY, speculative=True)
        finally:
            fl.close()
        assert r["status"] == "success" and "continuous" not in r
        assert r["speculative"] is True and r["spec_path"] == "solo"
        assert r["response"] == want_text


def test_set_draft_checks_and_the_server_flags(weights, monkeypatch):
    """set_draft takes a draft of the other family (gpt2), as the JAX
    engine does, and refuses another vocabulary as the JAX engine does; the server's
    --spec-* flags reach the fleet, and the solo engine's --draft-model
    attaches its draft at start (it was refused until the solo engine's
    speculation was ported)."""
    from distributed_llm_inference_tpu_torch.serving import server as S

    _, _, tcfg, tparams, _ = weights
    eng = create_engine(tcfg, params=tparams, device="cpu")
    eng.set_draft(get_model_config("test-gpt2-tiny"))
    assert eng._draft[0].arch == "gpt2" and "pos_embed" in eng._draft[1]
    with pytest.raises(ValueError, match="vocab"):
        eng.set_draft(get_model_config("test-llama-tiny", vocab_size=128))
    eng.set_draft(get_model_config("test-llama-tiny"), seed=1)
    assert eng._draft[0].attn_impl == eng.cfg.attn_impl
    with pytest.raises(ValueError, match="spec_draft_len"):
        EngineConfig(spec_draft_len=-1)

    built = {}

    class Server:
        def __init__(self, engine, *a, continuous=None, **kw):
            built["fleet"] = continuous
            built["engine"] = engine

        def serve_forever(self):
            pass

    monkeypatch.setattr(S, "InferenceServer", Server)
    S.main(["--model", MODEL, "--device", "cpu", "--continuous", "2",
            "--kv-pool-blocks", "40", "--continuous-max-seq", "128", "--spec-decode",
            "--spec-draft-len", "3", "--spec-draft-model", MODEL])
    fleet = built["fleet"]
    try:
        sb = fleet.stats()["speculative"]
    finally:
        fleet.close()
    assert (sb["mode"], sb["draft_len"], sb["fleet_wide"]) == ("draft_model", 3, True)
    S.main(["--model", MODEL, "--device", "cpu", "--draft-model", MODEL])
    assert built["fleet"] is None and built["engine"]._draft[0].name == MODEL
