"""The fleet's launches over static buffers: the precondition of its CUDA
graphs, held on the CPU.

On CUDA the continuous fleet captures its decode chunk and its mixed
launch as CUDA graphs (engine/graphs.py). A graph reads and writes fixed
device buffers, so the fleet's slot state, sampling knobs, block table,
mixed-launch inputs and KV pool or cache must keep their storage across
every launch and every eager site. That in-place code is the same on
every device, and these tests hold it on the CPU:

  * for the chunked, ragged whole-prefill, bucketed and dense fleets, no
    static buffer changes its storage (data_ptr) across mixed launches,
    decode chunks, admission arms (`arm_slot_paged`, `insert_slot_paged`,
    the dense `insert_slot`), releases (table changes) and a textual stop
    (`kill_slot`), and the greedy tokens equal the JAX fleet's in the same
    mode on the same weights (test-llama-tiny, fp32, no EOS);
  * each launch body against the functional launch it wraps, on cloned
    inputs and equal generator seeds: the same packed result, the same new
    state, written in place (exact: the same arithmetic on the same CPU);
  * LaunchGraph on the CPU runs its function eagerly on every call and
    captures nothing; `commit`; the mixed launch's static inputs alias
    nothing.

The capture and the replay themselves run only on a card: the `cuda`
tests in tests/test_torch_cuda.py."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import generate as G  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import graphs  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import paged as P  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
BASE = dict(prefix_cache_entries=0, step_token_budget=64, prefill_buckets=(64, 128, 256))
PAGED = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16)
# mode -> (engine flags, fleet arguments)
MODES = {
    "chunked": (dict(chunked_prefill=True), PAGED),
    "ragged": (dict(chunked_prefill=False), PAGED),
    "bucketed": (dict(ragged_prefill=False), PAGED),
    "dense": ({}, dict(n_slots=4, chunk_steps=8, slot_max_seq=512)),
}
PROMPTS = [
    "the quick brown fox jumps over the lazy dog",
    " ".join(f"ctx{j}" for j in range(24)) + " question one",
    "short",
    "y " * 150,
]


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _tensors(tree):
    """Every tensor of a nested tuple / dict / KVQuant, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, KVQuant):
        yield tree.q
        yield tree.s
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif isinstance(tree, tuple):
        for leaf in tree:
            yield from _tensors(leaf)


def _static_buffers(fleet):
    """Every static buffer of the fleet: state, knobs, KV pool or cache,
    and (paged) the block table, (chunked) the mixed launch's inputs."""
    bufs = [fleet.state, fleet.sparams, fleet.cache]
    if fleet.paged:
        bufs.append(fleet._table_dev)
    if fleet._mixed_in is not None:
        bufs.append(fleet._mixed_in)
    return list(_tensors(tuple(bufs)))


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


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jax_cfg(MODEL, **OVERRIDES), get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("mode", list(MODES))
def test_fleet_buffers_keep_their_storage_and_tokens_equal_jax(weights, mode):
    jcfg, tcfg, params, tparams = weights
    flags, fleet_kw = MODES[mode]
    ecfg, tok = dict(BASE, **flags), IdTokenizer()
    kw = dict(max_tokens=8, greedy=True, chat=False)
    jfleet = JaxContinuousEngine(
        JaxEngine(jcfg, params=params, engine_cfg=JaxEngineConfig(**ecfg), tokenizer=tok),
        **fleet_kw)
    try:
        want = _wave(jfleet, **kw)
    finally:
        jfleet.close()
    fleet = ContinuousEngine(
        create_engine(tcfg, params=tparams, engine_cfg=EngineConfig(**ecfg),
                      tokenizer=tok, device="cpu"),
        **fleet_kw)
    try:
        bufs = _static_buffers(fleet)
        ptrs = [t.data_ptr() for t in bufs]
        got = _wave(fleet, **kw)
        # a textual stop kills its slot mid-chunk (kill_slot)
        ids = got[2]["response"].split()
        stopped = fleet.submit(PROMPTS[2], **dict(kw, stop=[f" {ids[3]} "]))
        st = fleet.stats()
        after = _static_buffers(fleet)
    finally:
        fleet.close()
    for w, g in zip(want, got):
        assert w["status"] == g["status"] == "success", (w, g)
        for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason"):
            assert g[key] == w[key], key
    assert stopped["status"] == "success" and stopped.get("stopped") is True
    assert len(after) == len(bufs) and all(a is b for a, b in zip(after, bufs))
    assert [t.data_ptr() for t in after] == ptrs
    # every launch kind ran, eagerly: the CPU captures no graph
    launches = st["launches"]
    assert launches["decode_chunks"] >= 1
    assert (launches["mixed"] >= 5) == (mode == "chunked")
    kinds = ["decode_chunk"] + (["mixed_launch"] if mode == "chunked" else [])
    assert st["graphs"] == {k: {"captures": 0, "replays": 0} for k in kinds}
    if fleet.paged:
        assert st["paged"]["free_blocks"] == PAGED["kv_pool_blocks"] - 1


# -- the launch bodies against the functional launches they wrap ---------------


@pytest.fixture(scope="module")
def engine():
    return create_engine(MODEL, dtype="float32", seed=5, device="cpu")


def _operands(cfg, paged: bool, seed: int = 0):
    """A 4-slot fleet at tiny widths: slots 0-2 armed (greedy and sampled
    in turn) at positions 40, 57 and 90 over random K/V, slot 3 free; a
    paged pool with a shuffled table row per slot, or a dense cache."""
    B, V, S, bs = 4, cfg.vocab_size, 128, 16
    g = torch.Generator().manual_seed(seed)
    if paged:
        cache = P.init_pool(cfg, B * (S // bs) + 1, bs)
        table = (torch.randperm(B * (S // bs), generator=g) + 1).reshape(
            B, S // bs).to(torch.int32)
    else:
        from distributed_llm_inference_tpu_torch.models import api as M

        cache = M.init_kv_cache(cfg, B, max_seq=S)
        table = None
    for leaf in _tensors(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    state, sparams = G.init_slots(B, V)
    none = torch.zeros(V, dtype=torch.bool)
    for b, p in enumerate((40, 57, 90)):
        knobs = ((1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0) if b % 2 == 0
                 else (0.8, 20, 0.95, False, 0.0, 1.1, 0.2, 0.1))
        state, sparams = P.arm_slot_only(cfg, state, sparams, b, 10 + b, p, 12,
                                         *knobs, none)
    return cache, table, state, sparams


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, KVQuant):
        return KVQuant(tree.q.clone(), tree.s.clone())
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [_clone(v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def _assert_equal(a, b, what):
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y), what


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_chunk_body_equals_functional_decode(engine, paged):
    cfg, be = engine.cfg, engine.backend
    cache, table, state, sparams = _operands(cfg, paged)
    ref = _clone((cache, state, sparams))
    ptrs = [t.data_ptr() for t in _tensors((cache, state, sparams))]
    packed = graphs.decode_chunk(be, state, sparams, cache, table,
                                 torch.Generator().manual_seed(9), 6)
    rcache, rstate, rsparams = ref
    gen = torch.Generator().manual_seed(9)
    if paged:
        em, mask, rstate, _ = P.decode_slots_paged(cfg, be.params, rstate, rcache, table,
                                                   gen, rsparams, num_steps=6)
    else:
        em, mask, rstate, _ = G.decode_slots(cfg, be.params, rstate, rcache, gen,
                                             rsparams, num_steps=6)
    assert torch.equal(packed, G.pack_chunk(em, mask, rstate.active))
    _assert_equal((cache, state, sparams), (rcache, rstate, rsparams), "after the chunk")
    assert [t.data_ptr() for t in _tensors((cache, state, sparams))] == ptrs
    assert packed[6:12, :3].sum() > 0  # the armed slots emitted


def _mixed_operands(cfg, state, arm_on: bool):
    """Static mixed-launch inputs at width 48 (tiles of 8): decode rows of
    slots 0-2 and, with `arm_on`, slot 3's 12-token prompt landing whole
    and arming (sampled, with penalties)."""
    B, V, W, tile = 4, cfg.vocab_size, 48, 8
    entries = [(b, 0, 1, P.RAGGED_DECODE) for b in range(3)]
    if arm_on:
        entries.append((3, 0, 12, P.RAGGED_PREFILL))
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W, tile=tile)
    dev = P.build_device_meta(entries, offsets, 3, width=W, tile=tile)
    toks = np.zeros(W, np.int32)
    dec_flag = np.zeros(W, bool)
    dec_idx = np.zeros(B, np.int32)
    for b, off in zip(range(3), offsets):
        dec_flag[off] = True
        dec_idx[b] = off
    inp = graphs.mixed_inputs(W, tile, B, V)
    if arm_on:
        toks[offsets[3]: offsets[3] + 12] = np.arange(30, 42)
        arm = inp.arm
        arm.on[3], arm.idx[3], arm.prompt_len[3], arm.max_tokens[3] = True, offsets[3] + 11, 12, 9
        for field, value in zip(arm.params, (0.7, 10, 0.9, False, 0.05, 1.2, 0.0, 0.0)):
            field[3] = value
        arm.presence[3, 30:42] = True
    for dst, a in zip((inp.tokens, inp.tok_row, inp.tok_pos, inp.dec_flag, inp.meta,
                       inp.dec_idx, *inp.dev),
                      (toks, tok_row, tok_pos, dec_flag, meta, dec_idx, *dev)):
        dst.copy_(torch.from_numpy(a))
    return inp


@pytest.mark.parametrize("arm_on", [True, False], ids=["arming", "idle"])
def test_mixed_launch_body_equals_functional_mixed_step(engine, arm_on):
    cfg, be = engine.cfg, engine.backend
    pool, table, state, sparams = _operands(cfg, paged=True, seed=1)
    inp = _mixed_operands(cfg, state, arm_on)
    ref = _clone((pool, state, sparams, inp))
    ptrs = [t.data_ptr() for t in _tensors((pool, state, sparams, inp))]
    packed = graphs.mixed_launch(be, inp, pool, table, state, sparams,
                                 torch.Generator().manual_seed(3))
    rpool, rstate, rsparams, rinp = ref
    want, rstate, rsparams, _ = P.mixed_step_ragged(
        cfg, be.params, rinp.tokens, rinp.tok_row, rinp.tok_pos, rinp.dec_flag, rinp.meta,
        rpool, table, rstate, rsparams, torch.Generator().manual_seed(3), rinp.dec_idx,
        rinp.arm, dev=rinp.dev)
    assert torch.equal(packed, want)
    _assert_equal((pool, state, sparams), (rpool, rstate, rsparams), "after the launch")
    assert [t.data_ptr() for t in _tensors((pool, state, sparams, inp))] == ptrs
    assert packed[4].tolist() == [0, 0, 0, int(arm_on)]  # the armed row
    assert packed[1, :3].tolist() == [1, 1, 1]  # every decode row emitted
    assert bool(state.active[3]) == arm_on


# -- the capture helper and the static buffers, on the CPU ------------------------


def test_launch_graph_runs_eagerly_on_the_cpu():
    calls = []
    lg = graphs.LaunchGraph(lambda: calls.append(1) or torch.tensor([len(calls)]),
                            "test launch", "cpu", torch.Generator())
    assert [int(lg()) for _ in range(3)] == [1, 2, 3]
    assert (lg.graph, lg.captures, lg.replays, lg.deltas) == (None, 0, 0, None)
    lg.close()


def test_commit_writes_nested_tuples_in_place():
    dst = P.idle_mixed_arm(3, 5)
    src = P.MixedArm(torch.tensor([True, False, True]), torch.tensor([1, 2, 3]),
                     torch.tensor([4, 5, 6]), torch.tensor([7, 8, 9]),
                     G.SlotParams(*(torch.full((3,), i).to(dt) for i, dt in
                                    enumerate(G.SLOT_PARAM_DTYPES))),
                     torch.ones(3, 5, dtype=torch.bool))
    ptrs = [t.data_ptr() for t in _tensors(dst)]
    graphs.commit(dst, src)
    _assert_equal(dst, src, "committed arm")
    assert [t.data_ptr() for t in _tensors(dst)] == ptrs
    assert [t.dtype for t in _tensors(dst)] == [t.dtype for t in _tensors(P.idle_mixed_arm(3, 5))]
    state, _ = G.init_slots(3, 5)
    killed = G.kill_slot(state._replace(active=torch.ones(3, dtype=torch.bool)), 1)
    graphs.commit(state, killed)
    assert state.active.tolist() == [True, False, True]


def test_static_buffers_alias_nothing():
    """Each static buffer is a tensor of its own: an upload into one must
    never land in another (the idle arm once shared one zeros tensor for
    three fields)."""
    inp = graphs.mixed_inputs(32, 8, 4, 50)
    state, sparams = G.init_slots(4, 50)
    ptrs = [t.data_ptr() for t in _tensors((inp, state, sparams))]
    assert len(set(ptrs)) == len(ptrs)
    assert inp.meta.shape == (4, 4) and inp.arm.presence.shape == (4, 50)
    assert [t.dtype for t in _tensors(inp.arm.params)] == list(G.SLOT_PARAM_DTYPES)


def test_launch_counts_name_every_kernel_counter():
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa

    counts = graphs.launch_counts()
    assert set(counts) == {
        "flash_attend", "flash_attend[int8]", "ragged_paged_attend",
        "ragged_paged_attend[int8]", "paged_flash_attend", "paged_flash_attend[int8]",
        "flash_attend_slots", "q4_matmul_rows"}
    pa.paged_flash_attend.launches_int8 += 2
    try:
        after = graphs.launch_counts()
        assert after["paged_flash_attend[int8]"] == counts["paged_flash_attend[int8]"] + 2
    finally:
        pa.paged_flash_attend.launches_int8 -= 2
