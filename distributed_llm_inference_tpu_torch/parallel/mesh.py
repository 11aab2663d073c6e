"""The device mesh of the port: one process per rank over torch.distributed
(the JAX package's parallel/mesh.py, a `jax.sharding.Mesh` that one
controller drives).

`build_mesh(mesh_cfg, devices)` lays the ranks out as the JAX mesh lays
its devices, row-major over the axes (dp, pp, sp, tp, ep): tp and ep
innermost, so a stage's tp ranks are neighbours. Rank 0 is the caller's
own process, the DRIVER; `build_mesh` spawns the others, the WORKERS,
through torch.multiprocessing's spawn context, each on its device from
`devices` (rank r on devices[r]). Each worker sits in a loop serving the
programs the driver sends it (parallel/pipeline.py). The caller keeps
one controller: an engine above the mesh never sees a rank.

Every rank builds its axis groups (parallel/comm.Group): for each of
dp, pp, sp, tp and ep, a process group over the ranks that share every
other coordinate, each its own process group over one store, never the
process's default group, in the same axis order on every rank. The
rendezvous is a `FileStore` in a fresh temporary directory, so meshes
built side by side (the tests' worlds, several test processes) never
race for a TCP port.

The process-group backend follows one rule: NCCL where every rank has a
CUDA device of its own, gloo otherwise (on the CPU, and where ranks
share a card: NCCL refuses two ranks on one device). Every process group
is made with the timeout GROUP_TIMEOUT_S: a collective whose peer is
gone raises within it, and the driver notices a dead worker's exit
while it waits for the worker's answer, so no program waits forever.

`multihost_initialize` is part C of the ROADMAP item and raises the
not-ported error naming it.
"""

from __future__ import annotations

import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .comm import Group

AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP, AXIS_EP = "dp", "pp", "sp", "tp", "ep"
AXES = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP, AXIS_EP)
# the axes that own a process group on every rank, in construction order
GROUP_AXES = AXES

# every process group's timeout, and so the longest a program can block
# on a peer that is gone
GROUP_TIMEOUT_S = 30.0

# the ROADMAP.md heading that ports what this package still refuses
SPMD = "Multi-GPU SPMD"


def not_ported(what: str) -> NotImplementedError:
    """NotImplementedError naming the ROADMAP.md heading that ports `what`."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md \"{SPMD}\")")


class MeshError(RuntimeError):
    """A rank of the mesh died, timed out or raised: the mesh is unusable."""


def mesh_shape(mesh_cfg: MeshConfig) -> tuple:
    return tuple(getattr(mesh_cfg, a) for a in AXES)


def rank_coords(mesh_cfg: MeshConfig, rank: int) -> dict:
    """{axis: index} of global rank `rank` (row-major over AXES)."""
    out = {}
    for axis, size in reversed(list(zip(AXES, mesh_shape(mesh_cfg)))):
        rank, out[axis] = divmod(rank, size)
    return {a: out[a] for a in AXES}


def coords_rank(mesh_cfg: MeshConfig, coords: dict) -> int:
    r = 0
    for axis, size in zip(AXES, mesh_shape(mesh_cfg)):
        r = r * size + coords[axis]
    return r


def axis_group_ranks(mesh_cfg: MeshConfig, rank: int, axis: str) -> tuple:
    """The global ranks of `rank`'s group along `axis`, in axis order."""
    c = rank_coords(mesh_cfg, rank)
    return tuple(coords_rank(mesh_cfg, {**c, axis: i})
                 for i in range(getattr(mesh_cfg, axis)))


def process_group_backend(devices: Sequence) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def default_devices(n: int, device="cuda") -> list:
    """`n` rank devices of `device`'s type: the CPU for every rank, or the
    CUDA cards round-robin (ranks share a card when there are fewer cards
    than ranks)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the mesh on the CPU")
    return [torch.device("cuda", i % cards) for i in range(n)]


def _process_group(backend: str, store, rank: int, size: int, timeout_s: float):
    td = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, td)


def build_groups(mesh_cfg: MeshConfig, rank: int, backend: str, store_path: str,
                 timeout_s: float) -> dict:
    """This rank's Group per axis of GROUP_AXES (one process group each
    over the mesh's FileStore), and the rank's wire-byte counter under
    "wire_bytes" and collective clocks under "comm_s"."""
    import collections

    store = dist.FileStore(store_path, mesh_cfg.n_devices)
    counter, clocks = collections.Counter(), collections.Counter()
    groups = {"wire_bytes": counter, "comm_s": clocks}
    for axis in GROUP_AXES:
        ranks = axis_group_ranks(mesh_cfg, rank, axis)
        me = ranks.index(rank)
        prefix = f"{axis}/" + "-".join(map(str, ranks))
        pg = _process_group(backend, dist.PrefixStore(prefix, store), me,
                            len(ranks), timeout_s)
        groups[axis] = Group(pg, me, len(ranks), ranks, backend, counter, clocks)
    return groups


def abort_groups(groups: dict):
    """Stop every process group of a rank: no program runs after this. An
    NCCL group's watchdog and heartbeat threads keep the process from
    exiting otherwise; abort waits on no peer, which may be gone."""
    for axis in GROUP_AXES:
        if axis in groups:
            groups[axis].pg.abort()


class Mesh:
    """The driver's handle on a mesh: the config, each rank's device, the
    process-group backend, the driver's own groups, and the workers (their
    processes and control pipes)."""

    def __init__(self, mesh_cfg: MeshConfig, devices: list, backend: str,
                 timeout_s: float, store_dir: str, procs: list, conns: list,
                 groups: dict):
        self.cfg = mesh_cfg
        self.devices = devices
        self.backend = backend
        self.timeout_s = timeout_s
        self.store_dir = store_dir
        self.procs = procs
        self.conns = conns
        self.groups = groups
        self.broken: Optional[str] = None
        self.closed = False

    @property
    def world(self) -> int:
        return self.cfg.n_devices

    def coords(self, rank: int) -> dict:
        return rank_coords(self.cfg, rank)

    def dead_ranks(self) -> list:
        return [r for r, p in enumerate(self.procs, start=1) if not p.is_alive()]

    def check(self):
        """Raise MeshError if the mesh broke or a worker is gone."""
        if self.closed:
            raise MeshError("the mesh is closed")
        dead = self.dead_ranks()
        if dead and self.broken is None:
            self.broken = f"worker rank(s) {dead} exited"
        if self.broken is not None:
            raise MeshError(f"the mesh is unusable: {self.broken}")

    def send(self, msg: bytes):
        for conn in self.conns:
            conn.send_bytes(msg)

    def collect(self) -> list:
        """Every worker's reply to the program just sent, in rank order.
        Waits while the workers live, ten group timeouts at most (a
        program's own compute included), and raises MeshError when one
        died or never answered."""
        replies: list = [None] * len(self.conns)
        limit = self.timeout_s * 10  # a program's own compute time included
        t0 = time.monotonic()
        while any(r is None for r in replies):
            for i, conn in enumerate(self.conns):
                if replies[i] is None and conn.poll(0.02):
                    try:
                        replies[i] = pickle.loads(conn.recv_bytes())
                    except (EOFError, OSError) as e:
                        self.broken = f"worker rank {i + 1}'s pipe closed ({e})"
                        raise MeshError(self.broken) from e
            pending = [i + 1 for i, r in enumerate(replies) if r is None]
            dead = [r for r in pending if not self.procs[r - 1].is_alive()]
            if dead:
                self.broken = f"worker rank(s) {dead} exited"
                raise MeshError(f"the mesh is unusable: {self.broken}")
            if pending and time.monotonic() - t0 > limit:
                self.broken = f"worker rank(s) {pending} did not answer in {limit:.0f} s"
                raise MeshError(self.broken)
        return replies

    def close(self, timeout_s: float = 10.0):
        """Stop every worker (a close message, then a kill for any that does
        not exit) and join them; stop the driver's groups and remove the
        store."""
        if self.closed:
            return
        self.closed = True
        for conn in self.conns:
            try:
                conn.send_bytes(pickle.dumps(("close", (), {}, ())))
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self.conns:
            conn.close()
        abort_groups(self.groups)
        shutil.rmtree(self.store_dir, ignore_errors=True)


_mesh_ids = itertools.count()


def build_mesh(mesh_cfg: MeshConfig, devices: Optional[Sequence] = None, *,
               timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """Spawn the workers of a (dp, pp, sp, tp, ep) mesh and build the
    driver's groups. devices: one per rank (rank r on devices[r]); default
    every CUDA card round-robin. The caller's process is rank 0 on
    devices[0]."""
    n = mesh_cfg.n_devices
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices(n))]
    if len(devs) < n:
        raise ValueError(f"need {n} devices (dp*pp*sp*tp*ep), have {len(devs)}")
    devs = devs[:n]
    backend = process_group_backend(devs)
    store_dir = tempfile.mkdtemp(prefix=f"dli-mesh-{os.getpid()}-{next(_mesh_ids)}-")
    store_path = os.path.join(store_dir, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(1, n):
        parent, child = ctx.Pipe(duplex=True)
        p = ctx.Process(
            target=_worker_main, name=f"dli-mesh-rank{rank}", daemon=True,
            args=(mesh_cfg, rank, [str(d) for d in devs], backend, store_path,
                  timeout_s, child))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    mesh = Mesh(mesh_cfg, devs, backend, timeout_s, store_dir, procs, conns, {})
    try:
        if devs[0].type == "cuda":
            torch.cuda.set_device(devs[0])
        mesh.groups = build_groups(mesh_cfg, 0, backend, store_path, timeout_s)
        for rank, reply in enumerate(mesh.collect(), start=1):
            if reply[0] != "ready":
                raise MeshError(f"worker rank {rank} failed to start:\n{reply[2]}")
    except BaseException:
        mesh.close(timeout_s=2.0)
        raise
    return mesh


def _worker_main(mesh_cfg, rank, devices, backend, store_path, timeout_s, conn):
    """A worker rank: set its device, build its groups, report ready, and
    serve programs until the driver closes the mesh."""
    device = torch.device(devices[rank])
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        groups = build_groups(mesh_cfg, rank, backend, store_path, timeout_s)
    except BaseException as e:
        conn.send_bytes(pickle.dumps(("error", {}, f"{type(e).__name__}: {e}\n"
                                      f"{traceback.format_exc()}")))
        return
    from .pipeline import serve_rank

    conn.send_bytes(pickle.dumps(("ready", {}, None)))
    serve_rank(mesh_cfg, rank, device, groups, conn)


def multihost_initialize(coordinator_address=None, num_processes=None,
                         process_id=None, **kwargs):
    """Multi-host bring-up (the JAX `jax.distributed.initialize` seam)."""
    raise not_ported("multi-host meshes (serving/multihost.py, "
                     "--coordinator / --num-processes / --process-id)")
