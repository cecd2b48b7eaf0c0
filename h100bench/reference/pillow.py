"""Pillow's 8-bit resize and LLaVA's pad to square, plain PyTorch in
float64 (written from Pillow's ``Resample.c``: ``precompute_coeffs``, the
8-bit fixed-point coefficients of ``normalize_coeffs_8bpc`` with 22
fractional bits, the horizontal pass and then the vertical one, each summed
from half a unit, shifted down and clipped to 0..255).
"""

from __future__ import annotations

import functools
import math

import torch

_PRECISION_BITS = 22


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


@functools.lru_cache(maxsize=16)
def fixed_coeffs(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) float64 matrix of Pillow's integer coefficients
    for the bicubic filter (support 2)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    unit = float(1 << _PRECISION_BITS)
    out = torch.zeros((out_size, in_size), dtype=torch.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = [_bicubic((float(x) - center + 0.5) * ss) for x in range(xmin, xmax)]
        total = sum(k)
        for j, w in enumerate(k):
            w = w / total if total != 0.0 else w
            out[xx, xmin + j] = math.trunc(w * unit + (0.5 if w >= 0 else -0.5))
    return out


def _pass(x: torch.Tensor, coeffs: torch.Tensor, axis: int) -> torch.Tensor:
    half = float(1 << (_PRECISION_BITS - 1))
    y = torch.tensordot(x, coeffs.to(x.device), dims=([axis], [1])).movedim(-1, axis)
    return torch.clamp(torch.floor((y + half) / float(1 << _PRECISION_BITS)), 0.0, 255.0)


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 levels -> (out_h, out_w, 3) float64 levels, as
    Pillow's ``Image.resize((out_w, out_h), BICUBIC)`` of an RGB image."""
    x = img.to(torch.float64)
    h, w = x.shape[0], x.shape[1]
    if out_w != w:
        x = _pass(x, fixed_coeffs(w, out_w), 1)
    if out_h != h:
        x = _pass(x, fixed_coeffs(h, out_h), 0)
    return x


def expand_to_square(img: torch.Tensor, fill) -> torch.Tensor:
    """LLaVA's ``expand2square``: the image pasted centred on a square of
    ``fill`` levels."""
    h, w = img.shape[0], img.shape[1]
    if h == w:
        return img
    side = max(h, w)
    out = torch.empty((side, side, 3), dtype=img.dtype, device=img.device)
    out[:] = torch.tensor(fill, dtype=img.dtype, device=img.device)
    if w > h:
        top = (w - h) // 2
        out[top:top + h] = img
    else:
        left = (h - w) // 2
        out[:, left:left + w] = img
    return out
