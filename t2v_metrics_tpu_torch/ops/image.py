"""Image preprocessing: Pillow-parity separable resize, pad, crop, normalize,
patchify, and the Qwen-VL ``smart_resize`` geometry (port of
t2v_metrics_tpu/ops/image.py).

Resize is two dense interpolation-weight matmuls, ``W_h @ img @ W_w.T``,
whose coefficients reproduce Pillow's resampling; the coefficient matrices
are built in numpy and cached. Device images use the channel-flattened
(..., H, W*C) layout of the JAX package, where the W pass is one matmul with
kron(W_w, I_C). ``resize_uint8_pillow_flat`` is Pillow's 8-bit resize bit for
bit: its fixed-point coefficients, summed exactly in float64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import tracing


# ---------------------------------------------------------------------------
# Pillow-compatible filter weights (numpy)
# ---------------------------------------------------------------------------

def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Catmull-Rom cubic kernel, identical to Pillow's BICUBIC filter."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x < 1.0
    m2 = (x >= 1.0) & (x < 2.0)
    out[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    out[m2] = (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0) * a
    return out


def _bilinear_kernel(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


def _lanczos_kernel(x: np.ndarray, a: int = 3) -> np.ndarray:
    y = np.sinc(x) * np.sinc(x / a)
    y[np.abs(x) >= a] = 0.0
    return y


_FILTERS = {
    "bicubic": (_bicubic_kernel, 2.0),
    "bilinear": (_bilinear_kernel, 1.0),
    "lanczos": (_lanczos_kernel, 3.0),
}


@functools.lru_cache(maxsize=512)
def resize_weights(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic interpolation matrix.

    Reproduces Pillow's ``precompute_coeffs``: output pixel centers at
    ``(i + 0.5) * scale``, filter support scaled by ``max(scale, 1)``
    (antialiasing on downscale), window clipped to the image before
    normalization.
    """
    scale = in_size / out_size
    if filter == "nearest":
        w = np.zeros((out_size, in_size), dtype=np.float32)
        idx = np.minimum((np.arange(out_size) * scale).astype(np.int64), in_size - 1)
        w[np.arange(out_size), idx] = 1.0
        return w
    kernel_fn, support = _FILTERS[filter]
    filterscale = max(scale, 1.0)
    support = support * filterscale
    weights = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = np.arange(lo, hi, dtype=np.float64)
        w = kernel_fn((taps + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        weights[i, lo:hi] = w
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=512)
def kron_resize_weights(in_size: int, out_size: int, channels: int,
                        filter: str = "bicubic") -> np.ndarray:
    """(out_size*C, in_size*C) block matrix kron(W, I_C): resizes the W axis
    of a channel-interleaved (..., H, W*C) image in one matmul."""
    w = resize_weights(in_size, out_size, filter)
    return np.kron(w, np.eye(channels, dtype=np.float32))


def resize_shortest_side(img_hw: tuple[int, int], target: int) -> tuple[int, int]:
    """Output (H, W) after resizing so the shortest side equals ``target``
    (torchvision ``Resize(target)`` on a PIL image)."""
    h, w = img_hw
    if h <= w:
        return target, max(1, int(round(w * target / h)))
    return max(1, int(round(h * target / w))), target


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Qwen-VL smart_resize geometry: snap H/W to multiples of ``factor``
    while keeping the pixel count within [min_pixels, max_pixels] and the
    aspect ratio (qwen_vl_utils semantics, as the JAX package's)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


# ---------------------------------------------------------------------------
# Channel-flattened (..., H, W*C) tensor ops
# ---------------------------------------------------------------------------

def resize_flat(img: torch.Tensor, out_h: int, out_w: int, channels: int,
                filter: str = "bicubic") -> torch.Tensor:
    """Resize a channel-flattened (..., H, W*C) image -> (..., out_h, out_w*C)
    as two matmuls: the H pass, then the W pass with kron(W_w, I_C)."""
    h, wc = img.shape[-2], img.shape[-1]
    wh = tracing.to_device(resize_weights(h, out_h, filter), img.device, img.dtype)
    kw = tracing.to_device(kron_resize_weights(wc // channels, out_w, channels, filter),
                           img.device, img.dtype)
    return torch.matmul(torch.matmul(wh, img), kw.T)


# Pillow's 8-bit resampling: coefficients in fixed point with 22 fractional
# bits, each pass summed exactly from half a unit, shifted down and clipped
_PILLOW_PRECISION = 22


@functools.lru_cache(maxsize=64)
def pillow_fixed_weights(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """(out_size, in_size) float64 matrix of Pillow's fixed-point coefficients
    (``normalize_coeffs_8bpc``: the double coefficients of ``resize_weights``
    times 2^22, rounded half away from zero), integers held exactly."""
    scale = in_size / out_size
    kernel_fn, support = _FILTERS[filter]
    filterscale = max(scale, 1.0)
    support = support * filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        k = kernel_fn((np.arange(lo, hi, dtype=np.float64) + 0.5 - center) / filterscale)
        s = k.sum()
        w[i, lo:hi] = k / s if s != 0 else k
    unit = float(1 << _PILLOW_PRECISION)
    return np.where(w < 0, np.trunc(w * unit - 0.5), np.trunc(w * unit + 0.5))


def resize_uint8_pillow_flat(img: torch.Tensor, out_h: int, out_w: int, channels: int,
                             filter: str = "bicubic") -> torch.Tensor:
    """Resize (..., H, W*C) uint8 levels (any dtype) exactly as Pillow resizes
    a uint8 image: the W pass, then the H pass, each only where the size
    changes, each an exact float64 sum of pixels times the fixed-point
    coefficients from half a unit, floored and clipped to [0, 255]. Equal to
    Pillow bit for bit, upsampling included, on any device (every partial
    sum is an integer below 2^53, so the order of the float64 sums does not
    matter). Returns fp32."""
    *lead, h, wc = img.shape
    w = wc // channels
    x = img.to(torch.float64).reshape(*lead, h, w, channels)
    unit, half = float(1 << _PILLOW_PRECISION), float(1 << (_PILLOW_PRECISION - 1))

    def shift(s):
        return torch.clamp(torch.floor((s + half) / unit), 0.0, 255.0)

    if out_w != w:
        kw = tracing.to_device(pillow_fixed_weights(w, out_w, filter), x.device)
        x = shift(torch.einsum("pw,...hwc->...hpc", kw, x))
    if out_h != h:
        kh = tracing.to_device(pillow_fixed_weights(h, out_h, filter), x.device)
        x = shift(torch.einsum("oh,...hpc->...opc", kh, x))
    return x.reshape(*lead, out_h, out_w * channels).float()


def pad_square_flat(img: torch.Tensor, channels: int, fill_rgb) -> torch.Tensor:
    """Pad a (..., H, W*C) image to square with a fill color, image centered."""
    h, wc = img.shape[-2], img.shape[-1]
    w = wc // channels
    if h == w:
        return img
    side = max(h, w)
    fill = tracing.to_device(np.asarray(fill_rgb), img.device, img.dtype).repeat(side)
    out = fill.expand(*img.shape[:-2], side, side * channels).clone()
    if w > h:
        top = (side - h) // 2
        out[..., top:top + h, :] = img
    else:
        left = (side - w) // 2
        out[..., :, left * channels:(left + w) * channels] = img
    return out


def center_crop_flat(img: torch.Tensor, crop_h: int, crop_w: int,
                     channels: int) -> torch.Tensor:
    """Center-crop a (..., H, W*C) image (torchvision CenterCrop)."""
    h, wc = img.shape[-2], img.shape[-1]
    top = (h - crop_h) // 2
    left = (wc // channels - crop_w) // 2
    return img[..., top:top + crop_h,
               left * channels:(left + crop_w) * channels]


def normalize_flat(img: torch.Tensor, mean, std) -> torch.Tensor:
    """Channel-normalize a (..., W*C) channel-flattened float image."""
    w = img.shape[-1] // len(mean)
    m = tracing.to_device(np.asarray(mean), img.device, img.dtype).repeat(w)
    s = tracing.to_device(np.asarray(std), img.device, img.dtype).repeat(w)
    return (img - m) / s


def patchify_flat(img: torch.Tensor, patch: int, channels: int) -> torch.Tensor:
    """(..., H, W*C) -> (..., H/p * W/p, p*p*C) patches, features ordered
    (ph, pw, c). Pair with a patch-embed weight whose rows are permuted by
    ``patch_perm(patch, channels)``."""
    *lead, h, wc = img.shape
    gh, gw = h // patch, wc // channels // patch
    x = img.reshape(*lead, gh, patch, gw, patch * channels).transpose(-3, -2)
    return x.reshape(*lead, gh * gw, patch * patch * channels)


@functools.lru_cache(maxsize=64)
def patch_perm(patch: int, channels: int) -> np.ndarray:
    """Row permutation taking a (C, ph, pw)-flattened patch-embed weight to
    the (ph, pw, c) feature order emitted by ``patchify_flat``."""
    idx = np.arange(channels * patch * patch).reshape(channels, patch, patch)
    return np.ascontiguousarray(np.transpose(idx, (1, 2, 0)).reshape(-1))
