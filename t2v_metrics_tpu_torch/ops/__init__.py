"""Tensor ops of the port: plain PyTorch versions and the Hopper kernels."""

from __future__ import annotations

from .. import tracing

# each kernel's launches are the counter "launch.<kernel>" (tracing.py)
KERNELS = ("flash_attention_flat", "flash_attention", "layer_norm", "rms_norm",
           "rope_pack", "grouped_gemm", "quant_matmul", "quantize_rows")
_reset_at: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    totals = tracing.totals()
    return {k: totals.get("launch." + k, 0) - _reset_at.get(k, 0) for k in KERNELS}


def reset_launch_counts() -> None:
    totals = tracing.totals()
    _reset_at.update({k: totals.get("launch." + k, 0) for k in KERNELS})
