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

qk-norm (Qwen3) normalises each head of the q|k lanes of the packed qkv
projection, whose heads are not one strided 2-D view. The same RMSNorm
kernel, compiled with ``HEADS``, runs one program per token at the token's
row stride, loads its q|k heads (a head stride of d) as one (heads, d)
block with a statistic per head, picks the q or the k weight by head, and
writes in place (``rms_norm_heads_launch``): one launch per layer, no copy
of the q|k region, the v lanes untouched. Without ``HEADS`` the kernel is
the row kernel above.

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


def rms_norm_heads_plain(packed: torch.Tensor, q_scale: torch.Tensor,
                         k_scale: torch.Tensor, n_q: int, n_k: int, d: int,
                         eps: float = 1e-6, offset: float = 0.0,
                         cast_weight_dtype: bool = True) -> torch.Tensor:
    """qk-norm: RMSNorm over each head of d lanes of the q|k region of a
    packed (..., L) row, ``q_scale`` on the n_q q heads and ``k_scale`` on
    the n_k k heads; the v lanes pass through. Returns a new tensor."""
    lead = packed.shape[:-1]
    q = packed[..., :n_q * d].reshape(*lead, n_q, d)
    k = packed[..., n_q * d:(n_q + n_k) * d].reshape(*lead, n_k, d)
    return torch.cat([
        rms_norm_plain(q, q_scale, eps, offset, cast_weight_dtype).reshape(*lead, -1),
        rms_norm_plain(k, k_scale, eps, offset, cast_weight_dtype).reshape(*lead, -1),
        packed[..., (n_q + n_k) * d:]], dim=-1)


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
    def rms_kernel(X, W, W2, Y, x_stride, y_stride, n_cols, eps, offset,
                   n_heads, n_first, HAS_OFFSET: tl.constexpr,
                   CAST: tl.constexpr, HEADS: tl.constexpr,
                   HEADS_P2: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        cm = cols < n_cols
        if HEADS:
            # the row's n_heads heads of n_cols lanes, side by side, as one
            # (heads, cols) block with a statistic per head; the heads from
            # n_first on take the weight W2
            hs = tl.arange(0, HEADS_P2)
            m = (hs < n_heads)[:, None] & cm[None, :]
            offs = hs[:, None] * n_cols + cols[None, :]
            x = tl.load(X + row * x_stride + offs, mask=m, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1)[:, None] / n_cols
            w = tl.where((hs < n_first)[:, None],
                         tl.load(W + cols, mask=cm, other=0.0)[None, :],
                         tl.load(W2 + cols, mask=cm, other=0.0)[None, :])
        else:
            m = cm
            offs = cols
            x = tl.load(X + row * x_stride + offs, mask=m, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / n_cols
            w = tl.load(W + cols, mask=cm, other=0.0)
        y = x * tl.rsqrt(var + eps)
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
        tl.store(Y + row * y_stride + offs, out.to(Y.dtype.element_ty), mask=m)

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
    rms_kernel[(x2.shape[0],)](x2, scale, scale, y, x2.stride(0), y.stride(0),
                               x2.shape[1], eps, float(offset), 1, 1,
                               HAS_OFFSET=bool(offset),
                               CAST=cast_weight_dtype, HEADS=False,
                               HEADS_P2=1, BLOCK=block, num_warps=warps)
    rms_norm_launch.launches += 1
    return y.reshape(x.shape)


rms_norm_launch.launches = 0


def rms_norm_heads_launch(packed, q_scale, k_scale, n_q, n_k, d, eps, offset,
                          cast_weight_dtype):
    """Launch the RMSNorm kernel over the q|k heads of a packed CUDA row, in
    place: one program per token, its q|k heads (d apart) as one block; the
    q heads take ``q_scale``, the k heads ``k_scale``, the v lanes are not
    touched. Returns ``packed``."""
    if packed.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rms_norm_heads: unsupported dtype {packed.dtype}")
    lanes = packed.shape[-1]
    if (n_q + n_k) * d > lanes or d > _MAX_COLS:
        raise ValueError(f"rms_norm_heads: {n_q}+{n_k} heads of {d} in {lanes} lanes")
    if not packed.is_contiguous():
        raise ValueError("rms_norm_heads: packed must be contiguous (it is "
                         "updated in place)")
    q_scale = _check_weight(q_scale, packed[..., :d], "rms_norm_heads")
    k_scale = _check_weight(k_scale, packed[..., :d], "rms_norm_heads")
    rows = packed.numel() // lanes
    block = 1 << (d - 1).bit_length()
    heads_p2 = 1 << (n_q + n_k - 1).bit_length()
    _, rms_kernel = _kernels()
    rms_kernel[(rows,)](
        packed, q_scale, k_scale, packed, lanes, lanes, d, eps, float(offset),
        n_q + n_k, n_q, HAS_OFFSET=bool(offset), CAST=cast_weight_dtype,
        HEADS=True, HEADS_P2=heads_p2, BLOCK=block,
        num_warps=max(1, min(8, heads_p2 * block // 1024)))
    rms_norm_launch.launches += 1
    return packed


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


def rms_norm_heads_fused(packed: torch.Tensor, q_scale: torch.Tensor,
                         k_scale: torch.Tensor, n_q: int, n_k: int, d: int,
                         eps: float = 1e-6, offset: float = 0.0,
                         cast_weight_dtype: bool = True) -> torch.Tensor:
    """qk-norm over the q|k heads of a packed row: the Triton kernel (in
    place) on CUDA, the plain version (a new tensor) on CPU."""
    if packed.device.type == "cpu":
        return rms_norm_heads_plain(packed, q_scale, k_scale, n_q, n_k, d, eps,
                                    offset, cast_weight_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"rms_norm_heads: no kernel for device {packed.device}")
    return rms_norm_heads_launch(packed, q_scale, k_scale, n_q, n_k, d, eps,
                                 offset, cast_weight_dtype)
