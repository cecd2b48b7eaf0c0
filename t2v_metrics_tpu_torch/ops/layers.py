"""Shared layer primitives (port of t2v_metrics_tpu/ops/layers.py).

Norm statistics and softmax run in fp32 regardless of activation dtype. The
norms dispatch through the wrappers in ``ops/norms.py``: a CUDA tensor runs
the Triton kernel, a CPU tensor the plain PyTorch version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import norms


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    return norms.layer_norm_fused(x, scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0, cast_weight_dtype: bool = True) -> torch.Tensor:
    """T5/Llama-style RMSNorm, fp32 accumulate.

    ``offset=1.0`` gives the Gemma convention ``x * (1 + scale)``.
    ``cast_weight_dtype``: HF T5 rounds the normalized fp32 value to the
    weight dtype before the scale multiply; keep True for parity.
    """
    return norms.rms_norm_fused(x, scale, eps, offset, cast_weight_dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_new' / tanh-approximate GELU (FlanT5 gated MLP)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


ACT_FNS = {
    "quick_gelu": quick_gelu,
    "gelu_new": gelu_new,
    "gelu": gelu_exact,
    "gelu_pytorch_tanh": gelu_new,
    "relu": F.relu,
    "silu": F.silu,
}


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b). Weights stored (in, out)."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def softmax_fp32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax computed in fp32, returned in fp32."""
    return torch.softmax(logits.float(), dim=dim)


def log_softmax_fp32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=dim)
