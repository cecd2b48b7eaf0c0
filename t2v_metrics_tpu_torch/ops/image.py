"""Image preprocessing: Pillow-parity separable resize, pad, crop, normalize,
patchify, and the Qwen-VL ``smart_resize`` geometry (port of
t2v_metrics_tpu/ops/image.py).

Resize is two dense interpolation-weight matmuls, ``W_h @ img @ W_w.T``,
whose coefficients reproduce Pillow's resampling; the coefficient matrices
are built in numpy and cached. Device images use the channel-flattened
(..., H, W*C) layout of the JAX package, where the W pass is one matmul with
kron(W_w, I_C).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


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


def resize_np(img: np.ndarray, out_h: int, out_w: int, filter: str = "bicubic",
              quantize_uint8: bool = False) -> np.ndarray:
    """Resize a (..., H, W, C) numpy image with the same weights.

    ``quantize_uint8=True`` replicates Pillow's uint8 pipeline: horizontal
    pass first, round-half-up and clip to [0, 255] after each pass.
    """
    h, w = img.shape[-3], img.shape[-2]
    wh = resize_weights(h, out_h, filter)
    ww = resize_weights(w, out_w, filter)
    x = img.astype(np.float32)
    if quantize_uint8:
        x = np.einsum("pw,...hwc->...hpc", ww, x, optimize=True)
        x = np.clip(np.floor(x + 0.5), 0.0, 255.0)
        x = np.einsum("oh,...hpc->...opc", wh, x, optimize=True)
        return np.clip(np.floor(x + 0.5), 0.0, 255.0)
    out = np.einsum("oh,...hwc->...owc", wh, x, optimize=True)
    return np.einsum("pw,...owc->...opc", ww, out, optimize=True)


# ---------------------------------------------------------------------------
# Channel-flattened (..., H, W*C) tensor ops
# ---------------------------------------------------------------------------

def resize_flat(img: torch.Tensor, out_h: int, out_w: int, channels: int,
                filter: str = "bicubic") -> torch.Tensor:
    """Resize a channel-flattened (..., H, W*C) image -> (..., out_h, out_w*C)
    as two matmuls: the H pass, then the W pass with kron(W_w, I_C)."""
    h, wc = img.shape[-2], img.shape[-1]
    wh = torch.from_numpy(resize_weights(h, out_h, filter)).to(img)
    kw = torch.from_numpy(
        kron_resize_weights(wc // channels, out_w, channels, filter)).to(img)
    return torch.matmul(torch.matmul(wh, img), kw.T)


def resize_uint8_levels_flat(img: torch.Tensor, out_h: int, out_w: int,
                             channels: int, filter: str = "bicubic") -> torch.Tensor:
    """Resize a (..., H, W*C) float image holding uint8 levels the way
    Pillow resizes a uint8 image: the W pass first, each pass rounded half
    up and clipped to [0, 255] (Pillow clips the cubic overshoot of its
    first pass into a uint8 image). Within one level of Pillow, whose
    coefficients are fixed-point; an image already at the output size
    passes through exactly. Returns uint8 levels as floats."""
    h, wc = img.shape[-2], img.shape[-1]
    if (h, wc) == (out_h, out_w * channels):
        return img
    kw = torch.from_numpy(
        kron_resize_weights(wc // channels, out_w, channels, filter)).to(img)
    x = torch.clamp(torch.floor(torch.matmul(img, kw.T) + 0.5), 0.0, 255.0)
    wh = torch.from_numpy(resize_weights(h, out_h, filter)).to(img)
    return torch.clamp(torch.floor(torch.matmul(wh, x) + 0.5), 0.0, 255.0)


def pad_square_flat(img: torch.Tensor, channels: int, fill_rgb) -> torch.Tensor:
    """Pad a (..., H, W*C) image to square with a fill color, image centered."""
    h, wc = img.shape[-2], img.shape[-1]
    w = wc // channels
    if h == w:
        return img
    side = max(h, w)
    fill = torch.tensor(fill_rgb, dtype=img.dtype, device=img.device).repeat(side)
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
    m = torch.tensor(mean, dtype=img.dtype, device=img.device).repeat(w)
    s = torch.tensor(std, dtype=img.dtype, device=img.device).repeat(w)
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
