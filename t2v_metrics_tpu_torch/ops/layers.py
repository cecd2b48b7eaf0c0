"""Shared layer primitives (port of t2v_metrics_tpu/ops/layers.py).

Norm statistics and softmax run in fp32 regardless of activation dtype. The
norms dispatch through the wrappers in ``ops/norms.py``: a CUDA tensor runs
the kernel (LayerNorm and RMSNorm in CUDA, each with an entry that folds the
residual add in), a CPU tensor the plain PyTorch version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import norms


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    return norms.layer_norm_fused(x, scale, bias, eps)


def add_layer_norm(x: torch.Tensor, r: torch.Tensor | None, scale: torch.Tensor,
                   bias: torch.Tensor | None,
                   eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the LayerNorm that reads its sum: (s, LayerNorm(s))
    for s = x + r, rounded once to x's dtype as the eager add (one kernel
    pass on CUDA; on CPU the add, then the plain LayerNorm). ``r=None``:
    no add, (x, LayerNorm(x))."""
    if r is None:
        return x, layer_norm(x, scale, bias, eps)
    return norms.add_layer_norm_fused(x, r, scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0, cast_weight_dtype: bool = True) -> torch.Tensor:
    """T5/Llama-style RMSNorm, fp32 accumulate.

    ``offset=1.0`` gives the Gemma convention ``x * (1 + scale)``.
    ``cast_weight_dtype``: HF T5 rounds the normalized fp32 value to the
    weight dtype before the scale multiply; keep True for parity.
    """
    return norms.rms_norm_fused(x, scale, eps, offset, cast_weight_dtype)


def add_rms_norm(x: torch.Tensor, r: torch.Tensor | None, scale: torch.Tensor,
                 eps: float = 1e-6, offset: float = 0.0,
                 cast_weight_dtype: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm that reads its sum: (s, RMSNorm(s))
    for s = x + r, rounded once to x's dtype as the eager add (one kernel
    pass on CUDA; on CPU the add, then the plain RMSNorm). ``r=None``: no
    add, (x, RMSNorm(x))."""
    if r is None:
        return x, rms_norm(x, scale, eps, offset, cast_weight_dtype)
    return norms.add_rms_norm_fused(x, r, scale, eps, offset, cast_weight_dtype)


def rms_norm_heads(packed: torch.Tensor, q_scale: torch.Tensor,
                   k_scale: torch.Tensor, n_q: int, n_k: int, d: int,
                   eps: float = 1e-6, offset: float = 0.0,
                   cast_weight_dtype: bool = True) -> torch.Tensor:
    """qk-norm: ``rms_norm`` over each head of the q|k lanes of a packed
    qkv row, ``q_scale`` on the q heads and ``k_scale`` on the k heads; a
    new tensor. The CPU route only: on CUDA the qk-norm runs inside the
    rotary embedding's kernel (``ops/rope.py:rms_norm_rope_pack``)."""
    return norms.rms_norm_heads_fused(packed, q_scale, k_scale, n_q, n_k, d,
                                      eps, offset, cast_weight_dtype)


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
