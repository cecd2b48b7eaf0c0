"""Published peaks of one NVIDIA H100 SXM, the roofline bound, and the table
that names a device kernel's family.

The peaks and ``bound_s`` are a frozen copy of chip_smoke.py's ``bound``
arithmetic (NVIDIA's data sheet, dense rates, at the 700 W limit). The
family table is chip_smoke.py's ``KERNEL_FAMILIES`` widened to the library
kernels that could replace the port's own (cuDNN / flash / memory-efficient
SDPA kernels, cuBLAS nvjet and sm90 GEMMs, ``torch._grouped_mm``), so a
family's device time, and the roofline read from it, covers the same work
whichever implementation runs it.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

# by a substring of the lowered kernel name, first match wins: the attention
# libraries' names hold "cutlass" too, and a grouped GEMM's "gemm"
KERNEL_FAMILIES = (
    ("quant_matmul", ("quant_matmul_kernel",)),
    ("quantize_rows", ("quant_rows_kernel",)),
    ("grouped_gemm", ("grouped_gemm", "groupedgemm", "grouped_mm", "grouped")),
    ("attention", ("attention_kernel", "attention", "flash", "fmha", "sdpa")),
    ("rope", ("rope_kernel",)),
    ("rms_norm", ("rmsnorm", "rms_norm")),
    ("layer_norm", ("layernorm", "layer_norm")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "wgmma")),
)


def kernel_family(name: str) -> str:
    """The family of a device operation's name; "other" for the rest
    (elementwise, gathers, reductions, copies, the resize)."""
    name = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES
                 if any(k in name for k in keys)), "other")


def bound_s(ops: float, nbytes: float, kind: str = "bf16") -> float:
    """The least seconds for ``ops`` operations of type ``kind`` that must
    move ``nbytes`` through HBM: the larger of the two times."""
    return max(ops / PEAK_OPS_S[kind], nbytes / HBM_BYTES_S)
