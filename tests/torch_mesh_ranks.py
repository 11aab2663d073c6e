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
