"""Build the port's Hopper kernels from the sources in this package.

The CUDA kernel (``csrc/flash_flat.cu``, one instantiation per head dim) is
compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. The library's name carries a hash of its source and flags, so an
edited source is rebuilt. Triton kernels compile at their first launch; their
cache is kept beside the library. Everything lands in ``_build/`` inside the
package, which git ignores. Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def triton_cache_env() -> None:
    """Keep Triton's compile cache inside the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_shared_lib(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``_build/lib<name>_<hash>.so`` unless built.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is written beside the library as ``.log``.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


@functools.cache
def flash_flat_lib():
    """The ``flash_flat_forward`` C entry point, built on first use."""
    so = build_shared_lib("flash_flat", [CSRC_DIR / "flash_flat.cu"])
    fn = ctypes.CDLL(str(so)).flash_flat_forward
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([vp] * 7            # q, k, v, o, bias, kv_mask, seg
                   + [i32] * 6         # B, H, KVH, Sq, Sk, D
                   + [i64] * 14        # q/k/v (batch, row, col offset), o, bias
                   + [i32, ctypes.c_float, vp])  # causal, scale, stream
    fn.restype = ctypes.c_int
    return fn


def build_log(name: str) -> str:
    """The compiler output kept for the newest build of ``name``."""
    logs = sorted(BUILD_DIR.glob(f"lib{name}_*.log"),
                  key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""
