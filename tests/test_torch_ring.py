"""The port's ring attention and context-parallel decode (parallel/ring.py)
against the JAX package's functions under shard_map over an sp mesh (the
counterparts of tests/test_ring.py), and the sp Group's collectives.

Each port rank is a process of a gloo sp ring (tests/torch_mesh_ranks.py
ring_server, which imports no jax), holding the whole input and taking its
own chunk. The rings are module-scoped and shared.

Tolerance: fp32 outputs within 1e-5 of the JAX function's (the same
online-softmax steps; the einsums sum in another order).
"""

import functools
from concurrent.futures import ThreadPoolExecutor
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from distributed_llm_inference_tpu.ops.attention import attend, causal_mask  # noqa: E402
from distributed_llm_inference_tpu.ops.wire_quant import quantize_rows as jax_qrows  # noqa: E402
from distributed_llm_inference_tpu.parallel import ring as JR  # noqa: E402

import torch_mesh_ranks  # noqa: E402  (the spawned ranks' entry points, no jax)

ATOL = 1e-5
SP = JR.AXIS_SP


class Ring:
    """An sp ring of gloo ranks serving ring_server jobs."""

    def __init__(self, world):
        ctx = torch.multiprocessing.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="dli-ring-test-")
        path = os.path.join(self.dir, "store")
        self.procs, self.conns = [], []
        for r in range(world):
            a, b = ctx.Pipe()
            p = ctx.Process(target=torch_mesh_ranks.ring_server, args=(r, world, path, b),
                            daemon=True)
            p.start()
            self.procs.append(p)
            self.conns.append(a)

    def run(self, name, **kw):
        for c in self.conns:
            c.send_bytes(pickle.dumps((name, kw)))
        outs = []
        for r, c in enumerate(self.conns):
            assert c.poll(60), f"rank {r} did not answer"
            status, out = pickle.loads(c.recv_bytes())
            assert status == "ok", (r, out)
            outs.append(out)
        return outs

    def close(self):
        for c in self.conns:
            try:
                c.send_bytes(pickle.dumps(None))
            except OSError:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def rings(request):
    made = {}

    def get(world):
        if world not in made:
            made[world] = Ring(world)
        return made[world]

    def close():  # every ring at once: each close waits for its ranks to exit
        with ThreadPoolExecutor() as ex:
            list(ex.map(lambda r: r.close(), made.values()))

    request.addfinalizer(close)
    return get


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (SP,))


def _qkv(B, S, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))


def _jax_prefill(fn, sp, q, k, v, *, int8=False, **kw):
    """The JAX function under shard_map over the sequence axis."""
    seq = P(None, SP)
    args, specs = [jnp.asarray(q)], [seq]
    k, v = jnp.asarray(k), jnp.asarray(v)
    if int8:
        (k, ks), (v, vs) = jax_qrows(k), jax_qrows(v)
        args += [k, v, ks, vs]
        specs += [seq] * 4
    else:
        args += [k, v]
        specs += [seq, seq]
    vstart = kw.pop("valid_start", None)
    if vstart is not None:
        kw["valid_start"] = jnp.asarray(vstart)

    def body(*a):
        return fn(*a[:3], SP, *a[3:], **kw)

    # check_vma off, as the JAX backends build their programs
    out = shard_map(body, mesh=_mesh(sp), in_specs=tuple(specs), out_specs=seq,
                    check_vma=False)
    return np.asarray(jax.jit(out)(*args))


CASES = {
    "plain": {},
    "window": {"window": 5},
    "softcap": {"softcap": 3.0},
    "ragged": {"valid_start": np.asarray([0, 7], np.int32)},
    "int8": {"int8": True},
    "wire": {"wire": True},
}


RING_CASES = [(4, 2, 32, 4, 2, 16, c) for c in CASES] + \
    [(2, 2, 16, 4, 4, 8, c) for c in ("plain", "ragged", "int8")]


@pytest.mark.parametrize("sp,B,S,H,KV,Dh,case", RING_CASES)
def test_ring_attend_matches_jax(rings, sp, B, S, H, KV, Dh, case):
    """ring_attend per rank's chunk, concatenated, against the JAX ring
    under shard_map (a window, a softcap, left-padded rows, an int8 cache's
    chunks with their scales, the int8 wire); the plain case also against
    full causal attention."""
    q, k, v = _qkv(B, S, H, KV, Dh)
    kw = dict(CASES[case])
    got = np.concatenate(rings(sp).run("ring", q=q, k=k, v=v, **kw), axis=1)
    int8 = kw.pop("int8", False)
    want = _jax_prefill(JR.ring_attend, sp, q, k, v, int8=int8, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if case == "plain":
        S_ = q.shape[1]
        ref = attend(jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
                     jnp.asarray(v).transpose(0, 2, 1, 3), causal_mask(jnp.int32(0), S_, S_))
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", ["plain", "ragged", "int8", "window"])
def test_ulysses_attend_matches_jax(rings, sp, case):
    """ulysses_attend's two all-to-alls and blocked local attention
    against the JAX function (8 heads, 4 kv heads: both divide by 2 and
    4)."""
    q, k, v = _qkv(2, 16, 8, 4, 8, seed=1)
    kw = dict(CASES[case])
    got = np.concatenate(rings(sp).run("ulysses", q=q, k=k, v=v, **kw), axis=1)
    int8 = kw.pop("int8", False)
    want = _jax_prefill(JR.ulysses_attend, sp, q, k, v, int8=int8, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 3])
def test_cp_decode_attend_matches_jax(rings, T):
    """A 20-token history scattered over 4 ranks in reversed slot order:
    the merged decode attention equals the JAX function's and the single
    device's cached attention."""
    sp, B, H, KV, Dh, Sc, hist = 4, 2, 4, 2, 16, 8, 20
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kh = rng.standard_normal((B, hist + T, KV, Dh)).astype(np.float32)
    vh = rng.standard_normal((B, hist + T, KV, Dh)).astype(np.float32)
    lk = rng.standard_normal((sp, B, KV, Sc, Dh)).astype(np.float32)
    lv = rng.standard_normal((sp, B, KV, Sc, Dh)).astype(np.float32)
    lpos = np.full((sp, Sc), -1, np.int32)
    fill = np.zeros(sp, np.int32)
    for p in range(hist + T):
        d = p % sp
        slot = Sc - 1 - fill[d]
        lk[d, :, :, slot], lv[d, :, :, slot], lpos[d, slot] = kh[:, p], vh[:, p], p
        fill[d] += 1
    outs = rings(sp).run("decode", q=q, lk=lk, lv=lv, lpos=lpos, pos=hist)
    fn = shard_map(functools.partial(JR.cp_decode_attend, axis_name=SP), mesh=_mesh(sp),
                   in_specs=(P(), P(SP), P(SP), P(SP), P()), out_specs=P())
    want = np.asarray(jax.jit(fn)(jnp.asarray(q), jnp.asarray(lk).reshape(sp * B, KV, Sc, Dh),
                                  jnp.asarray(lv).reshape(sp * B, KV, Sc, Dh),
                                  jnp.asarray(lpos).reshape(sp * Sc), jnp.int32(hist)))
    S = 32
    ck = np.zeros((B, KV, S, Dh), np.float32)
    cv = np.zeros((B, KV, S, Dh), np.float32)
    ck[:, :, :hist + T], cv[:, :, :hist + T] = kh.transpose(0, 2, 1, 3), vh.transpose(0, 2, 1, 3)
    ref = np.asarray(attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            causal_mask(jnp.int32(hist), T, S)))
    for o in outs:  # the same on every rank
        np.testing.assert_allclose(o, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(o, ref, atol=2e-5, rtol=1e-5)


def _jax_appends(sp, shape, values):
    B, KV, Sc, Dh = shape
    fn = shard_map(lambda ck, cv, pids, fill, kn, vn, pos: JR.cp_cache_append(
        ck, cv, pids, kn, vn, pos, fill), mesh=_mesh(sp),
        in_specs=(P(SP), P(SP), P(SP), P(SP), P(), P(), P()),
        out_specs=(P(SP), P(SP), P(SP), P(SP), P()))
    ck = jnp.zeros((sp * B, KV, Sc, Dh))
    cv = jnp.zeros((sp * B, KV, Sc, Dh))
    pids = jnp.full((sp * Sc,), -1, jnp.int32)
    fill = jnp.zeros((sp,), jnp.int32)
    flags = []
    for p, val in enumerate(values):
        kn = jnp.full((B, 1, KV, Dh), float(val))
        ck, cv, pids, fill, ov = jax.jit(fn)(ck, cv, pids, fill, kn, kn * 2, jnp.int32(p))
        flags.append(bool(ov[0]))
    return (np.asarray(ck).reshape(sp, B, KV, Sc, Dh), np.asarray(cv).reshape(sp, B, KV, Sc, Dh),
            np.asarray(pids).reshape(sp, Sc), np.asarray(fill), flags)


def test_cp_cache_append_round_robin(rings):
    """Six appends over 4 ranks land on the least-filled rank (position
    p on rank p % 4) at its next free slot, every rank's cache, tags and
    fill equal to the JAX function's."""
    shape, values = (1, 2, 4, 8), [p + 1 for p in range(6)]
    outs = rings(4).run("append", shape=shape, values=values)
    ck, cv, pids, fill, flags = _jax_appends(4, shape, values)
    assert [o["fill"] for o in outs] == fill.tolist() == [2, 2, 1, 1]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["ck"], ck[r])
        np.testing.assert_array_equal(o["cv"], cv[r])
        np.testing.assert_array_equal(o["pids"], pids[r])
        assert o["overflow"] == flags == [False] * 6


def test_cp_cache_append_overflow_flag(rings):
    """Two one-slot shards full: the third append sets overflow on every
    rank and stores nothing, as in the JAX function."""
    shape, values = (1, 1, 1, 8), [1, 2, 99]
    outs = rings(2).run("append", shape=shape, values=values)
    ck, _, pids, fill, flags = _jax_appends(2, shape, values)
    assert flags == [False, False, True]
    for r, o in enumerate(outs):
        assert o["overflow"] == flags
        np.testing.assert_array_equal(o["ck"], ck[r])
        np.testing.assert_array_equal(o["pids"], pids[r])
        assert o["fill"] == fill[r] == 1


def test_group_shift_pmax_all_to_all(rings):
    """The sp Group's collectives on four gloo ranks: the ring shift (and
    a half-open one, whose idle ends send and receive nothing), the
    elementwise max, the tiled all-to-all, and their counted bytes."""
    outs = rings(4).run("collectives")
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["shift"], base + 10 * ((r - 1) % 4))
        assert (o["half"] is None) == (r != 1)
        if r == 1:
            np.testing.assert_array_equal(o["half"], base)
        np.testing.assert_array_equal(o["pmax"], np.maximum(base + 20, -(base + 10)))
        want = np.concatenate([np.arange(4 * r, 4 * r + 4, dtype=np.float32) + 100 * j
                               for j in range(4)])
        np.testing.assert_array_equal(o["a2a"], want[None] if o["a2a"].ndim == 2 else want)
        assert o["bytes"]["t"] == 24
        assert o["bytes"].get("h", 0) == (24 if r == 0 else 0)
        assert o["bytes"]["a"] == 3 * 4 * 4
