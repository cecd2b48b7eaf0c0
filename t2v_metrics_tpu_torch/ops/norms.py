"""LayerNorm and RMSNorm: Triton kernels for Hopper, with their plain versions.

Replaces the TPU kernels ``t2v_metrics_tpu/ops/norms.py:_ln_kernel``
(``layer_norm_fused``) and ``_rms_kernel`` (``rms_norm_fused``).

What bounds them on the H100: bytes. A row norm does a handful of flops per
element, far below the ~295 flop/byte at which the tensor cores, not HBM,
become the limit; the least time is one read of the bf16 input, one write of
the bf16 output and one read of the (d,) weights. The plain PyTorch version
makes several passes over an fp32 copy of the activation (convert, mean,
subtract, square, mean, scale), each a round trip through HBM.

What the design does about it: one program per row holds the whole row
(d=1024 for the CLIP ViT, 2048 for T5-xl) in registers, computes the fp32
statistics there and writes the bf16 result once, so each element crosses
HBM twice. The grid has exactly one program per row, so no row is ragged;
the column block is the next power of two above d and its tail is masked.
Triton serves this as well as CUDA would: a single-pass row reduction with an
elementwise epilogue, with no tensor-core work.

The wrappers take the plain version only for a tensor on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU route and the kernels' oracle)
# ---------------------------------------------------------------------------

def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                   offset: float = 0.0,
                   cast_weight_dtype: bool = True) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if cast_weight_dtype:
        y = y.to(scale.dtype)
    w = scale + offset if offset else scale
    return (w * y).to(dtype)


# ---------------------------------------------------------------------------
# Triton kernels (built at first launch; triton is imported only there)
# ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    from ..build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def ln_kernel(X, W, Bias, Y, x_stride, y_stride, n_cols, eps,
                  HAS_BIAS: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        cm = cols < n_cols
        x = tl.load(X + row * x_stride + cols, mask=cm, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(cm, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        y = xc * tl.rsqrt(var + eps)
        y = y * tl.load(W + cols, mask=cm, other=0.0).to(tl.float32)
        if HAS_BIAS:
            y = y + tl.load(Bias + cols, mask=cm, other=0.0).to(tl.float32)
        tl.store(Y + row * y_stride + cols, y.to(Y.dtype.element_ty), mask=cm)

    @triton.jit
    def rms_kernel(X, W, Y, x_stride, y_stride, n_cols, eps, offset,
                   HAS_OFFSET: tl.constexpr, CAST: tl.constexpr,
                   BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        cm = cols < n_cols
        x = tl.load(X + row * x_stride + cols, mask=cm, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / n_cols
        y = x * tl.rsqrt(var + eps)
        w = tl.load(W + cols, mask=cm, other=0.0)
        if HAS_OFFSET:
            # the offset is added in the weight dtype, as the plain version does
            w = (w.to(tl.float32) + offset).to(W.dtype.element_ty)
        if CAST:
            # HF T5: round the normalized value to the weight dtype, then
            # round the product again (a product of two bf16 values is exact
            # in fp32, so this is a correctly rounded bf16 multiply)
            y = y.to(W.dtype.element_ty).to(tl.float32)
            out = (w.to(tl.float32) * y).to(W.dtype.element_ty)
        else:
            out = w.to(tl.float32) * y
        tl.store(Y + row * y_stride + cols, out.to(Y.dtype.element_ty), mask=cm)

    return ln_kernel, rms_kernel


_MAX_COLS = 16384


def _rows_view(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if d > _MAX_COLS:
        raise ValueError(f"{what}: row width {d} > {_MAX_COLS}")
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return x2


def _check_weight(w: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    if w.device != x.device or w.shape != (x.shape[-1],):
        raise ValueError(f"{what}: weight must be ({x.shape[-1]},) on {x.device}")
    return w.contiguous()


def _block(d: int) -> tuple[int, int]:
    block = 1 << (d - 1).bit_length()
    return block, max(1, min(16, block // 256))


def layer_norm_launch(x, scale, bias, eps):
    """Launch the LayerNorm kernel on a CUDA tensor."""
    x2 = _rows_view(x, "layer_norm")
    scale = _check_weight(scale, x, "layer_norm")
    if bias is not None:
        bias = _check_weight(bias, x, "layer_norm")
    y = torch.empty_like(x2)
    block, warps = _block(x2.shape[1])
    ln_kernel, _ = _kernels()
    ln_kernel[(x2.shape[0],)](x2, scale, bias if bias is not None else scale,
                              y, x2.stride(0), y.stride(0), x2.shape[1], eps,
                              HAS_BIAS=bias is not None, BLOCK=block,
                              num_warps=warps)
    layer_norm_launch.launches += 1
    return y.reshape(x.shape)


layer_norm_launch.launches = 0


def rms_norm_launch(x, scale, eps, offset, cast_weight_dtype):
    """Launch the RMSNorm kernel on a CUDA tensor."""
    x2 = _rows_view(x, "rms_norm")
    scale = _check_weight(scale, x, "rms_norm")
    y = torch.empty_like(x2)
    block, warps = _block(x2.shape[1])
    _, rms_kernel = _kernels()
    rms_kernel[(x2.shape[0],)](x2, scale, y, x2.stride(0), y.stride(0),
                               x2.shape[1], eps, float(offset),
                               HAS_OFFSET=bool(offset),
                               CAST=cast_weight_dtype, BLOCK=block,
                               num_warps=warps)
    rms_norm_launch.launches += 1
    return y.reshape(x.shape)


rms_norm_launch.launches = 0


def layer_norm_fused(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: the Triton kernel on CUDA, the plain
    version on CPU."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return layer_norm_launch(x, scale, bias, eps)


def rms_norm_fused(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                   offset: float = 0.0,
                   cast_weight_dtype: bool = True) -> torch.Tensor:
    """RMSNorm over the last axis: the Triton kernel on CUDA, the plain
    version on CPU."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps, offset, cast_weight_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    return rms_norm_launch(x, scale, eps, offset, cast_weight_dtype)
