"""Linear layers through weight leaves (port of the bf16 branches of
t2v_metrics_tpu/ops/quant.py:86-125).

A leaf is a ``Linear`` module holding ``w`` (in, out) and an optional bias
``b``. The JAX package also has int8 leaves (``w_q`` + ``scale``) for its
W8A8 mode; that mode is not ported yet, so a leaf carrying ``w_q`` raises.
"""

from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    """Weight leaf: ``w`` (in, out), optional ``b`` (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, device, dtype):
        w = torch.empty((d_in, d_out), device=device, dtype=dtype)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, b)


def _require_dense(p) -> None:
    if getattr(p, "w_q", None) is not None:
        raise NotImplementedError("int8 (W8A8) weight leaves are not ported yet")


def pack(ps: list[Linear]) -> Linear:
    """One leaf whose columns are the leaves' columns side by side, in order
    (q | k | v for a qkv projection). Biases pack all-or-none."""
    for p in ps:
        _require_dense(p)
    w = torch.cat([p.w for p in ps], dim=1)
    bs = [p.b for p in ps]
    if any(b is None for b in bs) and not all(b is None for b in bs):
        raise ValueError("pack: biases must be all present or all absent")
    return Linear(w, None if bs[0] is None else torch.cat(bs))


def mm(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """x @ w through a leaf."""
    _require_dense(p)
    return x @ p.w


def mm_packed(x: torch.Tensor, ps: list[Linear]) -> torch.Tensor:
    """One wide matmul over horizontally packed leaves [p_q, p_k, p_v].

    This concatenates the weights on every call; the models pack once at
    load (``pack``) and call ``mm`` on the packed leaf instead."""
    return mm(x, pack(ps))


def linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """Linear with optional bias through a leaf."""
    y = mm(x, p)
    return y if p.b is None else y + p.b


def linear_packed(x: torch.Tensor, ps: list[Linear]) -> torch.Tensor:
    """mm_packed with the packed bias (all-or-none across the pack)."""
    return linear(x, pack(ps))
