"""The kernel build's cache key: a library is rebuilt when its source, a
local header the source includes (directly or through another header), or
a compiler flag changes, and only then.  Nothing here compiles."""

import os

import pytest

from bundletrack_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n  #  include "missing.h"\nint k;\n'
    )
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text('#pragma once\n#include "../a.cuh"\nint b;\n')
    (tmp_path / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    return tmp_path


def test_local_files_follow_includes_recursively(csrc):
    # system headers and headers that are not under csrc/ are not followed;
    # an include cycle ends
    assert build.local_files("k.cu") == ["k.cu", "a.cuh", os.path.join("sub", "b.cuh")]


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True),
    ("a.cuh", True),
    ("sub/b.cuh", True),  # included only through a.cuh
    ("other.cuh", False),  # not included
])
def test_library_path_follows_included_files(csrc, edited, rebuilds):
    before = build.library_path("k.cu")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (build.library_path("k.cu") != before) == rebuilds


def test_library_path_follows_flags(csrc, monkeypatch):
    before = build.library_path("k.cu")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-Iextra_headers",))
    assert build.library_path("k.cu") != before


def test_the_matcher_kernel_hashes_its_header():
    assert build.local_files("fused_mutual_match.cu") == ["fused_mutual_match.cu", "hopper_ptx.cuh"]
