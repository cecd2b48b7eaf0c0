"""Tensor ops of the port: plain PyTorch versions and the Hopper kernels."""

from __future__ import annotations


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    from . import attention, norms, rope

    return {"flash_attention_flat": attention.flash_flat_launch.launches,
            "layer_norm": norms.layer_norm_launch.launches,
            "rms_norm": norms.rms_norm_launch.launches,
            "rope_pack": rope.rope_pack_launch.launches}


def reset_launch_counts() -> None:
    from . import attention, norms, rope

    attention.flash_flat_launch.launches = 0
    norms.layer_norm_launch.launches = 0
    norms.rms_norm_launch.launches = 0
    rope.rope_pack_launch.launches = 0
