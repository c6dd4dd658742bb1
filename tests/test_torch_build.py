"""The port's kernel builds (``clipspm_tpu_torch/ops/build.py``): a library's
name hashes its ``.cu`` source and every ``csrc/*.cuh`` header, so an edited
header is never served by a stale build. Nothing here runs ``nvcc``."""

import os

import pytest

from clipspm_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    return tmp_path


def test_library_name_is_stable(csrc):
    assert build.library_path("kern") == build.library_path("kern")
    assert build.library_path("kern").startswith(build.BUILD_DIR)


@pytest.mark.parametrize("edit", ["header", "new-header", "source"])
def test_library_name_changes_with_what_the_build_reads(csrc, edit):
    before = build.library_path("kern")
    if edit == "header":
        (csrc / "shared.cuh").write_text("// v2\n")
    elif edit == "new-header":
        (csrc / "other.cuh").write_text("// helpers\n")
    else:
        (csrc / "kern.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("kern") != before


def test_shipped_sources_include_the_shared_header():
    # the digest covers what the kernels include
    for name in ("otam_dp", "softdtw_dp"):
        with open(os.path.join(build.CSRC_DIR, f"{name}.cu")) as f:
            assert '#include "dp_wavefront.cuh"' in f.read()
