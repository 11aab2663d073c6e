"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C interface and is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under the
repository's `build/` directory, then loaded with `ctypes`. Nothing is
compiled when a module is imported: a wrapper calls `load_library` the
first time it launches its kernel, and `build` compiles any number of
sources at once, one `nvcc` process each, all started together.

Libraries are named by a digest of their source, the headers under
csrc/ it includes, and the flags, so an edited source or header rebuilds
and an unchanged one is reused across processes. `set_build_dir` points
the library directory elsewhere before the first load (the server's
`--compile-cache DIR`: restarted or spawned replicas reuse the libraries
built there).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


def set_build_dir(path) -> Path:
    """Build and load the kernels' libraries under `path` from now on.
    Only before the first load: a library already loaded stays where it
    was, so a later switch would split one process over two directories."""
    global BUILD
    if load_library.cache_info().currsize:
        raise RuntimeError(
            f"set_build_dir({path!r}) after a kernel library was loaded "
            f"from {BUILD}; set the build directory before the first launch"
        )
    BUILD = Path(path).resolve()
    return BUILD


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda: the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return path


def sources() -> list:
    """The names of every kernel source under csrc/ (`<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _local_includes(path: Path, seen: set) -> None:
    """Add to `seen` every header under csrc/ that `path` includes, at any
    depth (`#include "..."`; a name not found under csrc/ is left to the
    compiler's search path)."""
    for name in _INCLUDE.findall(path.read_bytes()):
        header = (path.parent / name.decode()).resolve()
        if header.is_relative_to(CSRC) and header.is_file() and header not in seen:
            seen.add(header)
            _local_includes(header, seen)


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by the source, every header
    under csrc/ it includes, and the flags."""
    src = CSRC / f"{name}.cu"
    headers = set()
    _local_includes(src, headers)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(headers):
        h.update(str(header.relative_to(CSRC)).encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named source not built yet, in parallel. Returns
    {name: library path}; the compiler's output (register and shared
    memory use per kernel, from `-Xptxas -v`) lands beside each library
    as `<library>.log`. Raises with the compiler's output on failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    todo = [name for name, out in paths.items() if not out.exists()]
    nvcc = _nvcc() if todo else None
    procs = {}
    for name in todo:
        out = paths[name]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(out.with_name(out.name + ".log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[name])  # atomic: readers never see a partial file
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(
            paths[n].with_name(paths[n].name + ".log").read_text() for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def bind(lib, signatures: dict):
    """Declare each C entry point's argument types (`signatures`: name ->
    list of ctypes types) and its int return (the CUDA error code of the
    launch); returns `lib`."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
