"""PyTorch port vs JAX package: weight quantization (int8 and int4).

The same numpy weights go through the JAX package's ops/quant.py and the
port's: `quantize_tensor` / `quantize_tensor4` must give bit-equal q and s,
and the int4 unpack must round-trip. The port's `q4_matmul_rows` on CPU
tensors (its plain twin) is held to the JAX Pallas kernel in interpret
mode, and `matmul` above the kernel's gate to the JAX einsum, fp32 at
atol 1e-4 (the two sum a few hundred products in another order). The
slice as a whole: the port's continuous paged fleet under quant="int4",
kv_quant="int8" gives the JAX fleet's greedy tokens exactly on
test-llama-tiny (fp32, the same weights), and the port's server serves
`--quant int4 --kv-quant int8` on the CPU."""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.continuous import (  # noqa: E402
    ContinuousEngine as JaxContinuousEngine,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu.ops import quant as JQ  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.ops import quant as Q  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4
MODEL = "test-llama-tiny"


def _w(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t4(t):
    """A JAX Q4Tensor as the port's."""
    return Q.Q4Tensor(torch.from_numpy(np.array(t.q)), torch.from_numpy(np.array(t.s)), t.g)


@pytest.mark.parametrize("shape", [(64, 96), (3, 48, 40)])
def test_quantize_tensor_bit_equal_jax(shape):
    w = _w(0, *shape)
    w[..., 0, 1] = 0.0  # a column of one zero: unchanged by the floor
    w[..., :, 2] = 0.0  # an all-zero column: the 1e-12 floor
    want = JQ.quantize_tensor(jnp.asarray(w))
    got = Q.quantize_tensor(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(Q.dequantize_tensor(got).numpy(),
                                  np.asarray(JQ.dequantize_tensor(want)))


@pytest.mark.parametrize("shape,group", [((256, 384), 64), ((2, 128, 256), 32),
                                         ((48, 16), 64)],  # one-group fallback
                         ids=["g64", "stacked_g32", "odd_in"])
def test_quantize_tensor4_bit_equal_and_unpack_round_trips(shape, group):
    w = _w(1, *shape)
    want = JQ.quantize_tensor4(jnp.asarray(w), group=group)
    got = Q.quantize_tensor4(torch.from_numpy(w), group=group)
    assert got.g == want.g and tuple(got.shape) == tuple(want.shape) == shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    unpacked = Q._unpack_int4(got.q)
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(JQ._unpack_int4(want.q)))
    # every nibble is a value of [-7, 7], and packing the unpacked halves
    # again gives the same bytes
    assert int(unpacked.abs().max()) <= 7
    half = got.q.shape[-2]
    repacked = (unpacked[..., half:, :] << 4) | (unpacked[..., :half, :] & 15)
    assert torch.equal(repacked, got.q)
    np.testing.assert_array_equal(Q.dequantize_tensor4(got).numpy(),
                                  np.asarray(JQ.dequantize_tensor4(want)))


@pytest.mark.parametrize("R", [1, 5, 32])
def test_q4_matmul_rows_twin_matches_pallas_kernel(R):
    w = JQ.quantize_tensor4(jnp.asarray(_w(2, 256, 384)), group=64)
    x = _w(3 + R, R, 256)
    want = np.asarray(JQ.q4_matmul_rows(jnp.asarray(x), w, interpret=True))
    before = Q.q4_matmul_rows.launches
    got = Q.q4_matmul_rows(torch.from_numpy(x), _t4(w))
    assert Q.q4_matmul_rows.launches == before  # a CPU tensor runs the twin
    assert got.shape == (R, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(got, Q.q4_matmul_rows_plain(torch.from_numpy(x), _t4(w)))


@pytest.mark.parametrize("lead,d_in,d_out", [((2, 20), 256, 384),  # 40 rows
                                             ((3,), 128, 96),  # out % 128 != 0
                                             ((1, 4), 128, 256)],  # the kernel
                         ids=["rows_above_gate", "narrow_out", "kernel_rows"])
def test_matmul_matches_jax(lead, d_in, d_out):
    w = _w(4, d_in, d_out)
    x = _w(5, *lead, d_in)
    for jq, tq in ((JQ.quantize_tensor4(jnp.asarray(w)), None),
                   (JQ.quantize_tensor(jnp.asarray(w)), None)):
        if isinstance(jq, JQ.Q4Tensor):
            tq = _t4(jq)
            assert Q._q4_kernel_ok(int(np.prod(lead)), tq) == JQ._q4_kernel_ok(
                int(np.prod(lead)), jq)
        else:
            tq = Q.QTensor(torch.from_numpy(np.array(jq.q)),
                           torch.from_numpy(np.array(jq.s)))
        want = np.asarray(JQ.matmul(jnp.asarray(x), jq))
        got = Q.matmul(torch.from_numpy(x), tq)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_jax_tree_carried_across_equals_port_quantization(mode):
    """params_from_numpy takes the JAX quantize_params output; it equals,
    bit for bit, the port's own quantize_params of the dense tree."""
    jcfg = jax_cfg(MODEL, dtype="float32", quant=mode)
    tcfg = get_model_config(MODEL, dtype="float32", quant=mode)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    carried = params_from_numpy(
        tcfg, jax.tree.map(np.asarray, JQ.quantize_params(jcfg, params)), "cpu")
    own = Q.quantize_params(tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"))
    kind = Q.QTensor if mode == "int8" else Q.Q4Tensor
    for name in Q._QUANT_KEYS["llama"]:
        a, b = carried["layers"][name], own["layers"][name]
        assert isinstance(a, kind) and isinstance(b, kind), name
        assert a.q.dtype == torch.int8 and a.s.dtype == torch.float32
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), name
        assert getattr(a, "g", None) == getattr(b, "g", None)
        # one layer's slice slices every leaf
        assert a[1].q.shape == a.q.shape[1:] and a[1].s.shape == a.s.shape[1:]
    assert torch.equal(carried["lm_head"].q, own["lm_head"].q)
    assert torch.equal(carried["embed"], own["embed"])  # embeddings stay dense
    # already-quantized leaves are left as they are
    again = Q.quantize_params(tcfg, own)
    assert again["layers"]["wq"] is own["layers"]["wq"]


def test_moe_expert_banks_are_not_ported():
    """Once refused, the expert banks are ported: a 4-D bank becomes an
    int8 QTensor with per-(layer, expert, out-channel) scales bit-equal to
    the JAX quantize_params' under int8, stays dense under int4, and
    expert_einsum on the int8 bank equals the JAX function's."""
    cfg = get_model_config(MODEL)
    bank = np.random.RandomState(0).randn(2, 4, 8, 16).astype(np.float32)
    params = {"layers": {"w_gate": torch.from_numpy(bank)}}
    jq = JQ.quantize_params(jax_cfg(MODEL), {"layers": {"w_gate": jnp.asarray(bank)}},
                            "int8")["layers"]["w_gate"]
    q = Q.quantize_params(cfg, params, "int8")["layers"]["w_gate"]
    assert isinstance(q, Q.QTensor) and tuple(q.s.shape) == (2, 4, 16)
    assert np.array_equal(q.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(q.s.numpy(), np.asarray(jq.s))
    dense = Q.quantize_params(cfg, params, "int4")["layers"]["w_gate"]
    assert dense is params["layers"]["w_gate"]
    x = np.random.RandomState(1).randn(1, 3, 8).astype(np.float32)
    got = Q.expert_einsum("btd,edf->btef", torch.from_numpy(x), q[0])
    want = JQ.expert_einsum("btd,edf->btef", jnp.asarray(x), jax.tree.map(lambda a: a[0], jq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# -- the slice as a whole: the quantized fleet -----------------------------------

OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512,
                 quant="int4", kv_quant="int8")
ENGINE = dict(chunked_prefill=True, prefix_cache_entries=0, step_token_budget=64,
              prefill_buckets=(64, 128, 256))
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16)
PROMPTS = ["the quick brown fox jumps over the lazy dog",
           " ".join(f"ctx{j}" for j in range(24)) + " question one",
           "short", "y " * 90]


def _wave(cont, prompts, **kw):
    out = [None] * len(prompts)

    def run(i):
        out[i] = cont.submit(prompts[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id, so that a
    response pins the exact token ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def test_quantized_fleet_greedy_tokens_identical_to_jax():
    jcfg = jax_cfg(MODEL, **OVERRIDES)
    tcfg = get_model_config(MODEL, **OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tok = IdTokenizer()
    jeng = JaxEngine(jcfg, params=JQ.quantize_params(jcfg, params),
                     engine_cfg=JaxEngineConfig(**ENGINE), tokenizer=tok)
    # the port quantizes the dense weights itself (create_engine)
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ENGINE), tokenizer=tok, device="cpu")
    assert isinstance(teng.backend.params["layers"]["w_up"], Q.Q4Tensor)
    jax_fleet = JaxContinuousEngine(jeng, **FLEET)
    port_fleet = ContinuousEngine(teng, **FLEET)
    try:
        assert port_fleet.cache["k"].q.dtype == torch.int8
        kw = dict(max_tokens=8, greedy=True, chat=False)
        want = _wave(jax_fleet, PROMPTS, **kw)
        got = _wave(port_fleet, PROMPTS, **kw)
        for w, g in zip(want, got):
            assert w["status"] == g["status"] == "success", (w, g)
            for key in ("response", "tokens_generated", "prompt_tokens",
                        "finish_reason"):
                assert g[key] == w[key], key
        assert got[3]["prefill_chunks"] >= 3
        st = port_fleet.stats()
        assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
    finally:
        jax_fleet.close()
        port_fleet.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_server_serves_quantized_fleet_on_the_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--model", MODEL, "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--quant", "int4", "--kv-quant", "int8",
         "--attn-impl", "kernel", "--continuous", "2", "--kv-pool-blocks", "20",
         "--kv-block-size", "16", "--continuous-max-seq", "128"],
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
        code, r = _call(port, "/generate", {"prompt": "Hello", "max_tokens": 6,
                                            "greedy": True})
        assert code == 200 and r["status"] == "success", r
        assert r["backend"] == "continuous" and 1 <= r["tokens_generated"] <= 6
        assert _call(port, "/stats")[1]["continuous"]["paged"]["free_blocks"] == 19
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    with pytest.raises(SystemExit):
        from distributed_llm_inference_tpu_torch.serving import server as S

        S.main(["--model", MODEL, "--device", "cpu", "--quant", "int3"])


# -- the q4 gate: a decode step in a mixed launch or in a decode chunk ----------------


def _split_streams(pkg, cfg, params, K=12, B=4, W=64, seed=0):
    """Greedy tokens [K, B] of four 6-token prompts, landed together in one
    mixed launch, then decoded K steps twice from the same state: each
    step in its own width-W mixed launch (projections over W > 32 flat
    rows: the int4 einsum) and in one decode chunk (B <= 32 rows: the q4
    kernel, or its twin). Returns (mixed, chunk)."""
    from distributed_llm_inference_tpu.engine import generate as JG
    from distributed_llm_inference_tpu.engine import paged as JP
    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.engine import paged as P

    jax_side = pkg == "jax"
    PK, GK = (JP, JG) if jax_side else (P, G)
    V, N, BS, MB = cfg.vocab_size, 32, 8, 6
    rng = np.random.default_rng(seed)
    table = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(np.int32)
    arr = jnp.asarray if jax_side else torch.from_numpy
    gen = jax.random.PRNGKey(0) if jax_side else torch.Generator()
    entries = [(s, 0, 6, P.RAGGED_PREFILL) for s in range(B)]
    meta, tok_row, tok_pos, offs, _ = P.build_ragged_meta(entries, width=W, tile=8)
    toks = np.zeros(W, np.int32)
    for off in offs:
        toks[off:off + 6] = rng.integers(3, V, 6)
    idle = PK.idle_mixed_arm(B, V)
    sp = GK.init_slots(B, 1)[1]._replace(greedy=arr(np.ones(B, bool)))
    arm = idle._replace(on=arr(np.ones(B, bool)),
                        idx=arr(np.array([o + 5 for o in offs], np.int32)),
                        prompt_len=arr(np.full(B, 6, np.int32)),
                        max_tokens=arr(np.full(B, 40, np.int32)), params=sp)

    def mixed(ops, pool, state, sparams, dec_idx, arm):
        return PK.mixed_step_ragged(cfg, params, *(arr(a) for a in ops), pool,
                                    arr(table), state, sparams, gen, arr(dec_idx), arm)

    state, sparams = GK.init_slots(B, V)
    pool = PK.init_pool(cfg, N, BS)
    _, state0, sp0, pool0 = mixed((toks, tok_row, tok_pos, np.zeros(W, bool), meta),
                                  pool, state, sparams, np.zeros(B, np.int32), arm)
    # both branches start from this pool: the JAX programs donate it, the
    # port's write it in place
    keep = np.array if jax_side else torch.clone
    snapshot = {k: keep(v) for k, v in pool0.items()}

    def copy():
        return {k: jnp.asarray(v) if jax_side else v.clone() for k, v in snapshot.items()}

    pool, state, sparams, out = copy(), state0, sp0, []
    for _ in range(K):
        pos = np.asarray(state.pos)
        ents = [(s, int(pos[s]), 1, P.RAGGED_DECODE) for s in range(B)]
        m, tr, tp, of, _ = P.build_ragged_meta(ents, width=W, tile=8)
        flag = np.zeros(W, bool)
        flag[of] = True
        packed, state, sparams, pool = mixed(
            (np.zeros(W, np.int32), tr, tp, flag, m), pool, state, sparams,
            np.array(of, np.int32), idle)
        out.append(np.asarray(packed)[0])
    em, _, _, _ = PK.decode_slots_paged(cfg, params, state0, copy(), arr(table), gen,
                                        sp0, num_steps=K)
    return np.stack(out), np.asarray(em)


@pytest.mark.parametrize("dtype,quant,split", [
    ("bfloat16", "int4", True), ("bfloat16", None, False), ("float32", "int4", False)])
def test_q4_gate_splits_bf16_tokens_between_launch_kinds_as_in_jax(dtype, quant, split):
    """Under --quant int4 in bf16 the same greedy request gets other
    tokens when its decode steps run in mixed launches (the JAX einsum
    formulation, which sums the per-group partials in bf16) than in
    decode chunks (the q4 kernel, fp32 sums): the JAX package splits,
    and the port splits with it. Raw bf16 weights and int4 in fp32 do
    not split, in either package; in fp32 the port's streams are the
    JAX package's, path by path."""
    kw = dict(dtype=dtype, eos_token_id=-1, **({"quant": quant} if quant else {}))
    jcfg, tcfg = jax_cfg(MODEL, **kw), get_model_config(MODEL, **kw)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    if quant:
        params = JQ.quantize_params(jcfg, params)
        tparams = Q.quantize_params(tcfg, tparams)
    jm, jc = _split_streams("jax", jcfg, params)
    tm, tc = _split_streams("torch", tcfg, tparams)
    assert (not np.array_equal(jm, jc)) == split
    assert (not np.array_equal(tm, tc)) == split
    if dtype == "float32":
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tc, jc)
