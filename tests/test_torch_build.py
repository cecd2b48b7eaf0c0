"""The port's kernel build, on the CPU: a library's name carries a hash of
its sources and of every header under ``csrc/``, so editing a header that a
source includes (the attention body, the GEMM mainloop, the PTX wrappers)
rebuilds the library (nothing is compiled here)."""

import shutil

import pytest

pytest.importorskip("torch")

from t2v_metrics_tpu_torch import build  # noqa: E402


@pytest.mark.parametrize("lib,header", [
    ("flash_flat", "flash_common.cuh"), ("flash_flat", "sm90.cuh"),
    ("grouped_gemm", "gemm_sm90.cuh"), ("grouped_gemm", "sm90.cuh"),
    ("quant_matmul", "gemm_sm90.cuh"), ("quant_matmul", "sm90.cuh"),
    ("layer_norm", "sm90.cuh"), ("layer_norm", "row_norm.cuh"),
    ("rms_norm", "row_norm.cuh"), ("rms_norm", "sm90.cuh"),
])
def test_editing_a_header_renames_the_library(tmp_path, lib, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    src = [csrc / f"{lib}.cu"]
    before = build.library_path(lib, src, csrc)
    assert before == build.library_path(lib, src, csrc)
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    after = build.library_path(lib, src, csrc)
    assert after != before and after.parent == before.parent
    (csrc / "new_header.cuh").write_text("#pragma once\n")
    assert build.library_path(lib, src, csrc) != after


def test_every_attention_header_is_hashed():
    headers = {p.name for p in build.CSRC_DIR.glob("*.cuh")}
    assert {"flash_common.cuh", "sm90.cuh"} <= headers
    for cu in ("flash_flat.cu", "flash_attention.cu"):
        text = (build.CSRC_DIR / cu).read_text()
        assert '#include "flash_common.cuh"' in text
    assert '#include "sm90.cuh"' in (build.CSRC_DIR / "flash_common.cuh").read_text()


def test_every_gemm_header_is_hashed():
    headers = {p.name for p in build.CSRC_DIR.glob("*.cuh")}
    assert {"gemm_sm90.cuh", "sm90.cuh"} <= headers
    for cu in ("grouped_gemm.cu", "quant_matmul.cu"):
        assert '#include "gemm_sm90.cuh"' in (build.CSRC_DIR / cu).read_text()
    assert '#include "sm90.cuh"' in (build.CSRC_DIR / "gemm_sm90.cuh").read_text()


@pytest.mark.parametrize("lib", ["layer_norm", "rms_norm"])
def test_layer_norm_is_built_with_the_others(tmp_path, lib):
    """csrc/layer_norm.cu and csrc/rms_norm.cu are build_all's libraries,
    each source in its library's hash."""
    assert getattr(build, f"{lib}_lib") in build.CUDA_LIBS
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    src = [csrc / f"{lib}.cu"]
    before = build.library_path(lib, src, csrc)
    assert before.name.startswith(f"lib{lib}_")
    src[0].write_text(src[0].read_text() + "\n// edited\n")
    assert build.library_path(lib, src, csrc) != before
