"""PyTorch port vs JAX package: the block-paged fleet's launches.

The same weights, pool and slot state (numpy, from seeds) go through the
JAX package's `mixed_step_ragged` / `decode_slots_paged` and the port's,
launch after launch, on test-llama-tiny in fp32 with no EOS (every row
runs its budget): two slots prefill and arm in launch 1 and decode in
launches 2-4 (one with a penalised greedy stream, one whose 3-token
budget runs out and goes inactive), while a third slot's 20-token prompt
lands in chunks of 8, 8 and 4 and arms in launch 4; then one decode
chunk. Every row is greedy: the two packages' samplers draw other random
streams, so sampled rows are held filter by filter in
test_torch_sampling.py. The packed [5, B] results and the slot state
must be equal; the pool agrees to atol 1e-5 outside the trash block (the
write-only spill of launch padding, which nothing attends)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.engine import generate as JG  # noqa: E402
from distributed_llm_inference_tpu.engine import paged as JP  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import (  # noqa: E402
    cache_from_numpy,
    params_from_numpy,
    slots_from_numpy,
)
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1)
B, N_BLOCKS, BS, MB = 4, 32, 8, 6
W, TILE = 32, 8
POOL_ATOL = 1e-5
# prompts: slots 0 and 1 land whole in launch 1, slot 2 in chunks of 8/8/4
PROMPT_LENS = {0: 10, 1: 5, 2: 20}
MAX_TOKENS = {0: 12, 1: 3, 2: 6}
# (greedy, temperature, top_k, top_p, min_p, rep, freq, pres): all greedy;
# slot 0's penalties act on its argmax
KNOBS = {0: (True, 1.0, 0, 1.0, 0.0, 1.3, 0.5, 0.2),
         1: (True, 0.7, 40, 0.9, 0.0, 1.0, 0.0, 0.0),
         2: (True, 1.0, 0, 1.0, 0.0, 1.1, 0.0, 0.0)}


def test_block_allocator_hands_out_the_jax_ids():
    j, t = JP.BlockAllocator(12), P.BlockAllocator(12)
    script = [("alloc", 3), ("alloc", 4), ("decref", 0), ("alloc", 2),
              ("incref", 1), ("decref", 1), ("alloc", 6), ("decref", 1),
              ("alloc", 5), ("alloc", 1)]
    held_j, held_t = [], []
    for op, arg in script:
        if op == "alloc":
            a, b = j.alloc(arg), t.alloc(arg)
            assert a == b, (op, arg)
            if a is not None:
                held_j.append(a)
                held_t.append(b)
        else:
            getattr(j, op)(held_j[arg])
            getattr(t, op)(held_t[arg])
        assert (j.free_blocks, j.outstanding, j.shared_blocks) == (
            t.free_blocks, t.outstanding, t.shared_blocks), (op, arg)
        assert [j.refcount(b) for b in range(12)] == [t.refcount(b) for b in range(12)]
    with pytest.raises(ValueError):
        P.BlockAllocator(1)
    assert P.blocks_needed(10, 12, 8) == JP.blocks_needed(10, 12, 8) == 3


@pytest.fixture(scope="module")
def model():
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    tcfg = get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tparams


def _arm(cfg, arming, offsets, prompts):
    """numpy MixedArm operands for the slots whose last chunk rides this
    launch: {slot: entry index}."""
    V = cfg.vocab_size
    on = np.zeros(B, bool)
    idx, plen, mtk = (np.zeros(B, np.int32) for _ in range(3))
    sp = [np.ones(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32),
          np.ones(B, bool), np.zeros(B, np.float32), np.ones(B, np.float32),
          np.zeros(B, np.float32), np.zeros(B, np.float32)]
    presence = np.zeros((B, V), bool)
    for s, (e, n) in arming.items():
        greedy, temp, top_k, top_p, min_p, rep, freq, pres = KNOBS[s]
        on[s] = True
        idx[s] = offsets[e] + n - 1
        plen[s], mtk[s] = PROMPT_LENS[s], MAX_TOKENS[s]
        for field, v in zip(sp, (temp, top_k, top_p, greedy, min_p, rep, freq, pres)):
            field[s] = v
        if rep != 1.0:
            presence[s, prompts[s]] = True
    return on, idx, plen, mtk, sp, presence


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


@pytest.mark.parametrize("device_meta", [False, True], ids=["host_meta", "device_meta"])
def test_scripted_mixed_launches_then_decode_chunk_equal_jax(model, device_meta):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(11)
    V = jcfg.vocab_size
    prompts = {s: rng.integers(3, V, n).astype(np.int32) for s, n in PROMPT_LENS.items()}
    table = np.zeros((B, MB), np.int32)
    table[:3] = (rng.permutation(N_BLOCKS - 1)[: 3 * MB] + 1).reshape(3, MB)

    jpool = JP.init_pool(jcfg, N_BLOCKS, BS)
    tpool = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jpool), "cpu")
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = slots_from_numpy(_state_np(jstate), _state_np(jsp), "cpu")
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    jtable, ttable = jnp.asarray(table), torch.from_numpy(table)

    # launch -> (prefill chunks (slot, start, n), slots with a decode row)
    launches = [([(0, 0, 10), (1, 0, 5)], []),
                ([(2, 0, 8)], [0, 1]),
                ([(2, 8, 8)], [0, 1]),
                ([(2, 16, 4)], [0, 1])]
    armed_seen = []
    for li, (chunks, dec_slots) in enumerate(launches):
        tpos_now = tstate.pos.numpy()
        # the host plans decode rows from the exact positions without
        # DeviceMeta, and from stale placeholders (0) with it
        entries = [(s, 0 if device_meta else int(tpos_now[s]), 1, P.RAGGED_DECODE)
                   for s in dec_slots]
        entries += [(s, start, n, P.RAGGED_PREFILL) for s, start, n in chunks]
        meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(
            entries, width=W, tile=TILE)
        toks = np.zeros(W, np.int32)
        dec_flag = np.zeros(W, bool)
        dec_idx = np.zeros(B, np.int32)
        for s, off in zip(dec_slots, offsets):
            dec_flag[off] = True
            dec_idx[s] = off
        arming = {}
        for e, ((s, start, n), off) in enumerate(zip(chunks, offsets[len(dec_slots):])):
            toks[off: off + n] = prompts[s][start: start + n]
            if start + n == PROMPT_LENS[s]:
                arming[s] = (len(dec_slots) + e, n)
        on, idx, plen, mtk, sp, presence = _arm(jcfg, arming, offsets, prompts)
        jarm = JP.MixedArm(*(jnp.asarray(a) for a in (on, idx, plen, mtk)),
                           JG.SlotParams(*(jnp.asarray(a) for a in sp)),
                           jnp.asarray(presence))
        tarm = P.MixedArm(*(torch.from_numpy(a) for a in (on, idx, plen, mtk)),
                          G.SlotParams(*(torch.from_numpy(a) for a in sp)),
                          torch.from_numpy(presence))
        jdev = tdev = None
        if device_meta:
            dev = P.build_device_meta(entries, offsets, len(dec_slots), width=W,
                                      tile=TILE)
            jdev = JP.DeviceMeta(*(jnp.asarray(a) for a in dev))
            tdev = P.DeviceMeta(*(torch.from_numpy(a) for a in dev))
        ops = (toks, tok_row, tok_pos, dec_flag, meta)
        jpacked, jstate, jsp, jpool = JP.mixed_step_ragged(
            jcfg, jparams, *(jnp.asarray(a) for a in ops), jpool, jtable, jstate,
            jsp, key, jnp.asarray(dec_idx), jarm, dev=jdev)
        tpacked, tstate, tsp, tpool = P.mixed_step_ragged(
            tcfg, tparams, *(torch.from_numpy(a) for a in ops), tpool, ttable,
            tstate, tsp, gen, torch.from_numpy(dec_idx), tarm, dev=tdev)
        what = f"launch {li + 1}"
        assert tpacked.shape == (5, B) and tpacked.dtype == torch.int32
        np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked), err_msg=what)
        _assert_state_equal(jstate, tstate, what)
        for name, a, b in zip(G.SlotParams._fields, jsp, tsp):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")
        _assert_pool_close(jpool, tpool, what)
        armed_seen.append(sorted(np.flatnonzero(tpacked[4].numpy())))
    # the script did what it says: two arms in launch 1, the third in 4,
    # and slot 1's 3-token budget ran out
    assert armed_seen == [[0, 1], [], [], [2]]
    assert tstate.active.tolist() == [True, False, True, False]

    jem, jmask, jstate, jpool = JP.decode_slots_paged(
        jcfg, jparams, jstate, jpool, jtable, key, jsp, num_steps=4)
    tem, tmask, tstate, tpool = P.decode_slots_paged(
        tcfg, tparams, tstate, tpool, ttable, gen, tsp, num_steps=4)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _assert_state_equal(jstate, tstate, "decode chunk")
    _assert_pool_close(jpool, tpool, "decode chunk")
    packed = G.pack_chunk(tem, tmask, tstate.active)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JG.pack_chunk(jem, jmask, jstate.active)))


def test_arm_and_kill_slot_equal_jax(model):
    jcfg, _, tcfg, _ = model
    V = jcfg.vocab_size
    jstate, jsp = JG.init_slots(B, V)
    tstate, tsp = slots_from_numpy(_state_np(jstate), _state_np(jsp), "cpu")
    presence = np.zeros(V, bool)
    presence[[5, 9]] = True
    for slot, first, plen, mtk in ((1, 17, 9, 4), (3, 40, 2, 1)):
        knobs = (0.8, 40, 0.95, False, 0.05, 1.2, 0.1, 0.3)
        jstate, jsp = JP.arm_slot_only(jcfg, jstate, jsp, slot, first, plen, mtk,
                                       *knobs, jnp.asarray(presence))
        tstate, tsp = P.arm_slot_only(tcfg, tstate, tsp, slot, first, plen, mtk,
                                      *knobs, torch.from_numpy(presence))
        _assert_state_equal(jstate, tstate, f"arm {slot}")
        for name, a, b in zip(G.SlotParams._fields, jsp, tsp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name)
    _assert_state_equal(JG.kill_slot(jstate, 1), G.kill_slot(tstate, 1), "kill")
