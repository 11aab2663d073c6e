"""Entry points of the processes the mesh tests spawn as ranks. A
spawned process imports its target's module, so they live here, in a
module that imports no jax."""

import pickle

import torch

from distributed_llm_inference_tpu_torch.ops import wire_quant as WQ


def wire_ppermute(x, group, perm, *, quant):
    """The JAX ring shift `lax.ppermute` on the port's wire_send /
    wire_recv: every rank sends x to its target in `perm` ([(src, dst),
    ...] over group ranks) and returns what its source sent, or zeros when
    none sends to it (as ppermute fills). The sends go out in pairs ordered
    by rank parity, so a ring of blocking sends cannot deadlock."""
    me = group.rank
    dst = dict(perm).get(me)
    src = {d: s for s, d in perm}.get(me)
    out = torch.zeros_like(x)
    for phase in (0, 1):
        if dst is not None and me % 2 == phase:
            WQ.wire_send(x, group, dst, quant=quant)
        if src is not None and src % 2 == phase:
            out = WQ.wire_recv(x, group, src, quant=quant)
    return out


def wire_rank(rank, world, path, conn):
    """One rank of a gloo group running the wire collectives on the JAX
    test's inputs (every rank knows the whole input)."""
    torch.set_num_threads(1)
    from distributed_llm_inference_tpu_torch.config import MeshConfig as MC
    from distributed_llm_inference_tpu_torch.parallel.mesh import build_groups

    g = build_groups(MC(pp=world), rank, "gloo", path, 20.0)["pp"]
    x = pickle.loads(conn.recv_bytes())
    perm = [(j, (j + 1) % world) for j in range(world)]
    out = {}
    for quant in (False, True):
        out[("ring", quant)] = wire_ppermute(x[rank], g, perm, quant=quant).numpy()
        out[("bcast", quant)] = WQ.masked_psum(x[rank], g, 0, quant=quant).numpy()
    out["bytes"] = dict(g.wire_bytes)
    conn.send_bytes(pickle.dumps(out))


def _ring_job(g, name, kw):
    """One job of ring_server on this rank's sp group `g`: every rank
    holds the whole input and takes its own shard."""
    from distributed_llm_inference_tpu_torch.parallel import ring as R

    me, sp = g.rank, g.size
    if name in ("ring", "ulysses"):
        q, k, v = (torch.from_numpy(kw[n]) for n in ("q", "k", "v"))
        Tc = q.shape[1] // sp
        sl = slice(me * Tc, (me + 1) * Tc)
        extra = {}
        if kw.get("int8"):
            kq, ks = R.quantize_rows(k[:, sl])
            vq, vs = R.quantize_rows(v[:, sl])
            args, extra = (q[:, sl], kq, vq), {"k_scale": ks, "v_scale": vs}
        else:
            args = (q[:, sl], k[:, sl], v[:, sl])
        vstart = kw.get("valid_start")
        fn = R.ring_attend if name == "ring" else R.ulysses_attend
        out = fn(*args, g, **extra, window=kw.get("window"), softcap=kw.get("softcap"),
                 wire=kw.get("wire", False),
                 valid_start=None if vstart is None else torch.from_numpy(vstart))
        return out.numpy()
    if name == "decode":
        return R.cp_decode_attend(torch.from_numpy(kw["q"]), torch.from_numpy(kw["lk"][me]),
                                  torch.from_numpy(kw["lv"][me]),
                                  torch.from_numpy(kw["lpos"][me]), kw["pos"], g).numpy()
    if name == "append":
        B, KV, Sc, Dh = kw["shape"]
        ck, cv = torch.zeros(B, KV, Sc, Dh), torch.zeros(B, KV, Sc, Dh)
        pids = torch.full((Sc,), -1, dtype=torch.int32)
        fill, flags = 0, []
        for p, val in enumerate(kw["values"]):
            k_new = torch.full((B, 1, KV, Dh), float(val))
            ck, cv, pids, fill, overflow = R.cp_cache_append(ck, cv, pids, k_new, k_new * 2,
                                                             p, fill, g)
            flags.append(overflow)
        return {"ck": ck.numpy(), "cv": cv.numpy(), "pids": pids.numpy(), "fill": fill,
                "overflow": flags}
    if name == "collectives":
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * me
        g.wire_bytes.clear()
        shifted = g.shift(x, x, "t")
        half = g.shift(x if me == 0 else None, x if me == 1 else None, "h")
        a2a = g.all_to_all(torch.arange(4 * sp, dtype=torch.float32).reshape(sp, 4) + 100 * me,
                           0, 1, "a")
        return {"shift": shifted.numpy(), "half": None if half is None else half.numpy(),
                "pmax": g.pmax(x * (-1) ** me).numpy(), "a2a": a2a.numpy(),
                "bytes": dict(g.wire_bytes)}
    raise KeyError(name)


def ring_server(rank, world, path, conn):
    """One rank of an sp ring of gloo groups serving the ring tests' jobs
    ((name, kwargs) in, the rank's result out) until it receives None."""
    torch.set_num_threads(1)
    from distributed_llm_inference_tpu_torch.config import MeshConfig as MC
    from distributed_llm_inference_tpu_torch.parallel.mesh import build_groups

    g = build_groups(MC(sp=world), rank, "gloo", path, 20.0)["sp"]
    while True:
        job = pickle.loads(conn.recv_bytes())
        if job is None:
            return
        try:
            out = ("ok", _ring_job(g, *job))
        except Exception as e:  # the test reports it
            out = ("error", repr(e))
        conn.send_bytes(pickle.dumps(out))
