"""Build the port's Hopper kernels from the sources in this package.

Each CUDA source (``csrc/flash_flat.cu`` and ``csrc/flash_attention.cu``,
which share the body in ``csrc/flash_common.cuh``; ``csrc/grouped_gemm.cu``
and ``csrc/quant_matmul.cu``, which share the GEMM mainloop in
``csrc/gemm_sm90.cuh``; all four the Hopper primitives in ``csrc/sm90.cuh``;
``csrc/layer_norm.cu`` and ``csrc/rms_norm.cu``, which share the row-norm
body in ``csrc/row_norm.cuh`` and include none of the others) is
compiled with ``nvcc`` for ``sm_90a`` into a shared library of its own with
a plain C interface and loaded with ``ctypes``. The library's name carries a
hash of its sources, of every header under ``csrc/`` and of the flags, so an
edited source or header is rebuilt. ``build_all`` starts one ``nvcc`` per
source at once. Triton kernels compile at their first launch; their cache is kept
beside the libraries. Everything lands in ``_build/`` inside the package,
which git ignores. Nothing is downloaded.
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


def library_path(name: str, sources: list[Path], csrc: Path = CSRC_DIR) -> Path:
    """``_build/lib<name>_<hash>.so``: the hash covers the flags, ``sources``
    and every header (``*.cuh``) in ``csrc``, whichever a source includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(csrc.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_shared_lib(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``library_path(name, sources)`` unless built.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is written beside the library as ``.log``.
    """
    so = library_path(name, sources)
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


def _attention_entry(name: str):
    """The C entry ``<name>_forward`` of csrc/<name>.cu; both attention
    entries take the same arguments."""
    so = build_shared_lib(name, [CSRC_DIR / f"{name}.cu"])
    fn = getattr(ctypes.CDLL(str(so)), f"{name}_forward")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ctypes.POINTER(i64)]  # geo: q, k, v tensor maps
                   + [vp] * 7            # o, bias, kv_mask, seg, bidir, rel, rel_bucket
                   + [i32] * 7           # B, H, KVH, Sq, Sk, D, num_buckets
                   + [i64] * 7           # o (batch, row, head), bias (b, h, q, k)
                   + [i32] * 4           # bias_vec2, causal, window, head_major
                   + [ctypes.c_float, vp])  # scale, stream
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def flash_flat_lib():
    """The ``flash_flat_forward`` C entry point, built on first use."""
    return _attention_entry("flash_flat")


@functools.cache
def flash_attention_lib():
    """The ``flash_attention_forward`` C entry point, built on first use."""
    return _attention_entry("flash_attention")


@functools.cache
def grouped_gemm_lib():
    """The ``grouped_gemm_forward`` C entry point, built on first use."""
    so = build_shared_lib("grouped_gemm", [CSRC_DIR / "grouped_gemm.cu"])
    fn = ctypes.CDLL(str(so)).grouped_gemm_forward
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # geo (xg, w maps); be, num_blocks, o; P, K, N, E, grid; stream
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)] + [vp] * 3 + [i32] * 5 + [vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def quant_matmul_lib():
    """The ``quant_matmul_forward`` C entry point, built on first use."""
    fn = _quant_matmul_cdll().quant_matmul_forward
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # geo (x_q, w_qt maps); xs, ws, o, part; M, N, K, splits, grid; stream
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)] + [vp] * 4 + [i32] * 5 + [vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def quant_matmul_dequant_lib():
    """The ``quant_matmul_dequant`` C entry point (the second pass alone)."""
    fn = _quant_matmul_cdll().quant_matmul_dequant
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # part, xs, ws, o; M, N, splits; stream
    fn.argtypes = [vp] * 4 + [i32] * 3 + [vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _quant_matmul_cdll():
    return ctypes.CDLL(str(build_shared_lib("quant_matmul", [CSRC_DIR / "quant_matmul.cu"])))


def _row_norm_lib(name: str):
    """The library of csrc/<name>.cu, one norm of csrc/row_norm.cuh: its C
    entries ``row_norm_forward`` and ``row_norm_blocks_per_sm``, the same in
    both norms' libraries."""
    lib = ctypes.CDLL(str(build_shared_lib(name, [CSRC_DIR / f"{name}.cu"])))
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # x, r, scale, bias, s, y; x and r row strides; rows, d, dtype, vec,
    # nv_cap, nv, warps_per_row, block_warps, grid; eps, offset; cast; stream
    lib.row_norm_forward.argtypes = ([vp] * 6 + [i64] * 2 + [i32] * 9 + [f32] * 2
                                     + [i32, vp])
    lib.row_norm_forward.restype = i32
    # dtype, vec, nv_cap, add, d, has_bias, block_warps; out: resident blocks an SM
    lib.row_norm_blocks_per_sm.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.row_norm_blocks_per_sm.restype = i32
    return lib


@functools.cache
def layer_norm_lib():
    """The library of csrc/layer_norm.cu, built on first use."""
    return _row_norm_lib("layer_norm")


@functools.cache
def rms_norm_lib():
    """The library of csrc/rms_norm.cu, built on first use."""
    return _row_norm_lib("rms_norm")


CUDA_LIBS = (flash_flat_lib, flash_attention_lib, grouped_gemm_lib, quant_matmul_lib,
             layer_norm_lib, rms_norm_lib)


def build_all() -> None:
    """Build every CUDA library, one ``nvcc`` per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    libs = CUDA_LIBS
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(lib) for lib in libs]:
            fut.result()


def build_log(name: str) -> str:
    """The compiler output kept for the newest build of ``name``."""
    logs = sorted(BUILD_DIR.glob(f"lib{name}_*.log"),
                  key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def ptxas_usage(name: str) -> dict[str, tuple[int, int, int]]:
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from the ``-Xptxas -v`` lines of the newest build of ``name``."""
    usage, fn = {}, None
    for line in build_log(name).splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = m.group(1)
            usage[fn] = [0, 0, 0]
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[fn][1:] = int(m.group(1)), int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}
