"""The port's kernel build step (distributed_llm_inference_tpu_torch/kernels.py)
on the CPU: a library's path is a digest of its source, every header under
csrc/ that the source includes (at any depth) and the compiler flags, so
an edited header never loads a stale library from build/. Nothing is
compiled here."""

import pytest

pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)
from distributed_llm_inference_tpu_torch import kernels  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path.resolve() / "csrc"
    root.mkdir()
    (root / "walk.cu").write_text('#include "shared.cuh"\n#include <cuda_runtime.h>\n')
    (root / "shared.cuh").write_text('#pragma once\n#include "deep/inner.cuh"\nint a;\n')
    (root / "deep").mkdir()
    (root / "deep" / "inner.cuh").write_text("int b;\n")
    (root / "alone.cu").write_text("int c;\n")
    (root / "unused.cuh").write_text("int d;\n")
    monkeypatch.setattr(kernels, "CSRC", root)
    return root


@pytest.mark.parametrize("header", ["shared.cuh", "deep/inner.cuh"])
def test_an_edited_header_moves_the_library_path(csrc, header):
    before = kernels.library_path("walk")
    assert before == kernels.library_path("walk")  # a function of the files alone
    alone = kernels.library_path("alone")
    (csrc / header).write_text((csrc / header).read_text() + "int e;\n")
    assert kernels.library_path("walk") != before
    assert kernels.library_path("alone") == alone  # a source that does not include it


def test_a_header_nothing_includes_and_a_system_include_leave_the_path(csrc):
    before = kernels.library_path("walk")
    (csrc / "unused.cuh").write_text("int f;\n")
    assert kernels.library_path("walk") == before
    assert kernels.sources() == ["alone", "walk"]  # headers are no sources


def test_the_sources_of_the_port_digest_the_walk_header():
    """Both decode kernels' sources include csrc/decode_walk.cuh, both
    flash walks' csrc/flash_walk.cuh (the paged source holds one of each),
    and each walk csrc/tile_ops.cuh: an edit of any of them rebuilds."""
    want = {"paged_attention": {"decode_walk.cuh", "flash_walk.cuh", "tile_ops.cuh"},
            "slots_attention": {"decode_walk.cuh", "tile_ops.cuh"},
            "flash_attention": {"flash_walk.cuh", "tile_ops.cuh"}}
    for name, headers in want.items():
        found = set()
        kernels._local_includes(kernels.CSRC / f"{name}.cu", found)
        assert {p.name for p in found} == headers
