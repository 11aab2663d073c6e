"""The collectives of the port's meshes, over torch.distributed process
groups: the counterparts of the JAX package's `lax.psum`,
`lax.ppermute`, the masked-psum broadcast and `lax.all_gather` inside its
shard_map programs.

A `Group` is one axis group of one rank (the pp ring of its other
coordinates, its dp, sp, tp or ep group): a process group of its own,
built by parallel/mesh.py over the mesh's store, never the process's
default group, so one process may hold several meshes at once (the tests
keep a few worlds alive side by side). Ranks are numbered inside the
group.

Device tensors: an NCCL group moves them directly. A gloo group moves
host tensors only (gloo carries CUDA tensors for broadcast and all-reduce
but not for point-to-point), so every op here on a gloo group whose
tensor lies on a CUDA device copies it into a host buffer, runs the op
there and copies the result back onto the device. That is the path two
ranks sharing one card take; the model's compute and its kernels stay on
the card either way.

`wire_bytes` counts, per transfer family ("microstep" for a stage's
activation hand-off, "1f1b" for the microbatched ring's shifts,
"broadcast" for the last stage's window reaching every rank, "sp" for
the K/V chunks the sequence ring rotates or Ulysses re-shards, the JAX
package's link paths), the bytes this rank SENT:
a point-to-point send counts its payload, a broadcast counts it once, at
its root, an all-to-all the chunks that leave the rank. The pipeline sums every rank's counts into
dli_pp_wire_bytes_total.

`comm_s` adds up, per kind of collective ("send", "recv", "shift",
"broadcast", "psum", "pmax", "all_gather", "all_to_all"), the host seconds this rank spent inside it: from
its operand being ready (a staged operand's device work is waited for
first, outside the clock) to its result landed, the wait for a peer that
arrives late included. On an NCCL group a collective is queued on the
device's stream, so its clock holds the host's share alone.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch
import torch.distributed as dist


class Group:
    """One axis group of one rank: `pg` its process group, `rank` / `size`
    within the group, `ranks` the members' global ranks in group order."""

    def __init__(self, pg, rank: int, size: int, ranks: tuple, backend: str,
                 wire_bytes: collections.Counter, comm_s: collections.Counter):
        self.pg = pg
        self.rank = rank
        self.size = size
        self.ranks = tuple(ranks)
        self.backend = backend
        self.wire_bytes = wire_bytes
        self.comm_s = comm_s

    def __repr__(self):
        return f"Group(rank={self.rank}/{self.size}, ranks={self.ranks}, {self.backend})"

    # -- host staging for gloo ---------------------------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().to("cpu") if self._staged(x) else x

    def _start(self, x: torch.Tensor) -> float:
        """The clock of one collective on x, started once x is ready."""
        if self._staged(x):
            torch.cuda.current_stream(x.device).synchronize()
        return time.perf_counter()

    def _stop(self, op: str, t0: float):
        self.comm_s[op] += time.perf_counter() - t0

    @staticmethod
    def _land(dst: torch.Tensor, host: torch.Tensor):
        if host is not dst:
            dst.copy_(host)

    def _count(self, path, x: torch.Tensor):
        # a group of one rank moves nothing
        if path is not None and self.size > 1:
            self.wire_bytes[path] += x.numel() * x.element_size()

    # -- the collectives -------------------------------------------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the group, returned as a new tensor (the
        `lax.psum` of a shard_map body)."""
        out = x.contiguous().clone()
        t0 = self._start(out)
        h = self._host(out)
        self.pg.allreduce([h]).wait()
        self._land(out, h)
        self._stop("psum", t0)
        return out

    def broadcast(self, x: torch.Tensor, src: int, path=None) -> torch.Tensor:
        """`src`'s x on every rank of the group (a new tensor; the other
        ranks' x gives the shape and dtype only)."""
        out = x.contiguous().clone()
        if self.rank == src:
            self._count(path, out)
        t0 = self._start(out)
        h = self._host(out)
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self.pg.broadcast([h], opts).wait()
        self._land(out, h)
        self._stop("broadcast", t0)
        return out

    def send(self, x: torch.Tensor, dst: int, path=None):
        """Point-to-point send to group rank `dst`."""
        x = x.contiguous()
        t0 = self._start(x)
        x = self._host(x)
        self._count(path, x)
        self.pg.send([x], dst, 0).wait()
        self._stop("send", t0)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """Receive from group rank `src` into a new tensor shaped and typed
        like `like`, on like's device."""
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        t0 = self._start(out)
        h = self._host(out)
        self.pg.recv([h], src, 0).wait()
        self._land(out, h)
        self._stop("recv", t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's x concatenated along `dim` in group order (the
        tiled `lax.all_gather`)."""
        x = x.contiguous()
        t0 = self._start(x)
        h = self._host(x)
        outs = [torch.empty_like(h) for _ in range(self.size)]
        self.pg.allgather([outs], [h]).wait()
        out = torch.cat(outs, dim=dim)
        out = out.to(x.device) if out.device != x.device else out
        self._stop("all_gather", t0)
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of x over the group (the `lax.pmax`)."""
        out = x.contiguous().clone()
        t0 = self._start(out)
        h = self._host(out)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX
        self.pg.allreduce([h], opts).wait()
        self._land(out, h)
        self._stop("pmax", t0)
        return out

    def shift(self, x: Optional[torch.Tensor], like: Optional[torch.Tensor] = None,
              path=None) -> Optional[torch.Tensor]:
        """One step of the ring: x to group rank + 1, and what rank - 1
        sent back, shaped and typed like `like` (the `lax.ppermute` of a
        ring). x None sends nothing and like None receives nothing, so a
        hop whose payload no one reads is skipped on both of its ends
        (every rank knows which hops carry one). gloo posts both halves at
        once; NCCL, whose send waits for its peer's receive, orders them by
        the parity of the rank, so a ring of any size completes."""
        if self.size == 1:
            return None if like is None else x
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        if x is not None:
            x = x.contiguous()
        probe = x if x is not None else like
        if probe is None:
            return None
        out = None if like is None else torch.empty_like(
            like, memory_format=torch.contiguous_format)
        t0 = self._start(probe)
        hx = None if x is None else self._host(x)
        ho = None if out is None else self._host(out)
        if hx is not None:
            self._count(path, hx)
        if self.backend == "gloo" or self.rank % 2 == 0:
            works = ([] if hx is None else [self.pg.send([hx], nxt, 1)])
            if ho is not None:
                works.append(self.pg.recv([ho], prv, 1))
            for w in works:
                w.wait()
        else:
            if ho is not None:
                self.pg.recv([ho], prv, 1).wait()
            if hx is not None:
                self.pg.send([hx], nxt, 1).wait()
        if out is not None:
            self._land(out, ho)
        self._stop("shift", t0)
        return out

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   path=None) -> torch.Tensor:
        """The tiled all-to-all (`lax.all_to_all(..., tiled=True)`): x
        split into `size` chunks along split_dim, chunk j sent to group
        rank j, and the chunks received concatenated along concat_dim in
        group order."""
        parts = torch.stack(x.chunk(self.size, dim=split_dim)).contiguous()
        t0 = self._start(parts)
        h = self._host(parts)
        if path is not None:
            self.wire_bytes[path] += (self.size - 1) * h[0].numel() * h.element_size()
        got = torch.empty_like(h)
        self.pg.alltoall_base(got, h, [], [], dist.AllToAllOptions()).wait()
        if got.device != x.device:
            got = got.to(x.device)
        out = torch.cat(got.unbind(0), dim=concat_dim)
        self._stop("all_to_all", t0)
        return out
