"""Tensor ops of the port: plain PyTorch versions and the Hopper kernels."""

from __future__ import annotations


def _launchers() -> dict:
    from . import attention, moe, norms, quant, rope

    return {"flash_attention_flat": attention.flash_flat_launch,
            "flash_attention": attention.flash_attention_launch,
            "layer_norm": norms.layer_norm_launch,
            "rms_norm": norms.rms_norm_launch,
            "rope_pack": rope.rope_pack_launch,
            "grouped_gemm": moe.grouped_gemm_launch,
            "quant_matmul": quant.quant_matmul_launch,
            "quantize_rows": quant.quantize_rows_launch}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _launchers().items()}


def reset_launch_counts() -> None:
    for fn in _launchers().values():
        fn.launches = 0
