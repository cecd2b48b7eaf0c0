"""Rotary embedding on the q|k lanes of a packed qkv row: a Triton kernel for
Hopper, with its plain version.

Replaces the TPU kernel ``t2v_metrics_tpu/ops/rope.py:_kernel``
(``rope_pack``). Semantics, on the first ``rot_heads * d`` lanes of a packed
(B, S, L) row read as ``rot_heads`` heads of width d with halves x1 | x2:

    out = x * cos + rotate_half(x) * sin,   rotate_half(x) = -x2 | x1

with x in its own dtype times **f32** cos/sin (B, S, d), the products and
the sum in f32 and one rounding at the end (``models/decoder.py:
apply_rope_bshd`` of the JAX package); the v lanes pass through unchanged.

What bounds it on the H100: bytes. A handful of flops per element, one read
and one write of the q|k lanes (at the Qwen2.5-VL-7B decoder shape, 16 x 1280
rows x 4096 bf16 lanes: 168 MB each way). The plain version slices, upcasts,
rotates by concatenation, multiplies, adds, downcasts and concatenates with
v: some six passes over an fp32 copy of the activation.

What the design does about it: one program per block of rows loads the
row's cos/sin halves once (f32) and walks the ``rot_heads`` heads, loading
the two halves of each head, rotating in registers and storing them back in
place. The q|k lanes are written **in place** and the v lanes are never
touched, so each element crosses HBM twice and v not at all; the wrapper
returns the input tensor, where the plain version returns a new one. A half
width that is not a power of two (d=80 in the Qwen ViT) is masked up to the
next one. Triton serves this as well as CUDA would: a fused elementwise pass
with no tensor-core work. The knobs of the TPU module (``T2V_ROPE_KERNEL``,
``T2V_ROPE_COMPUTE``, ``_MAX_LANES``) are Mosaic and XLA devices and are not
carried over.
"""

from __future__ import annotations

import functools

import torch


def rope_pack_plain(packed: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    rot_heads: int, d: int) -> torch.Tensor:
    """Plain PyTorch version (CPU route and the kernel's oracle): a new
    (B, S, L) tensor with the first ``rot_heads`` heads rotated."""
    b, s, _ = packed.shape
    qk = packed[..., :rot_heads * d].reshape(b, s, rot_heads, d)
    c = cos[:, :, None].float()
    sn = sin[:, :, None].float()
    x1, x2 = qk.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    out = (qk * c + rot * sn).to(packed.dtype)     # x * f32 -> f32 products
    return torch.cat([out.reshape(b, s, -1), packed[..., rot_heads * d:]], dim=-1)


@functools.cache
def _kernel():
    from ..build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def rope_kernel(X, Cos, Sin, n_rows, x_stride, cs_stride, rot_heads,
                    D: tl.constexpr, HALF: tl.constexpr, HALF_P2: tl.constexpr,
                    BLOCK_R: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, HALF_P2)
        m = (rows < n_rows)[:, None] & (cols < HALF)[None, :]
        rows = rows.to(tl.int64)
        cs = rows[:, None] * cs_stride + cols[None, :]
        c1 = tl.load(Cos + cs, mask=m, other=0.0)
        c2 = tl.load(Cos + cs + HALF, mask=m, other=0.0)
        s1 = tl.load(Sin + cs, mask=m, other=0.0)
        s2 = tl.load(Sin + cs + HALF, mask=m, other=0.0)
        xp = X + rows[:, None] * x_stride + cols[None, :]
        for h in range(rot_heads):
            p1 = xp + h * D
            x1 = tl.load(p1, mask=m, other=0.0).to(tl.float32)
            x2 = tl.load(p1 + HALF, mask=m, other=0.0).to(tl.float32)
            tl.store(p1, (x1 * c1 - x2 * s1).to(X.dtype.element_ty), mask=m)
            tl.store(p1 + HALF, (x2 * c2 + x1 * s2).to(X.dtype.element_ty),
                     mask=m)

    return rope_kernel


_BLOCK_R = 32


def rope_pack_launch(packed, cos, sin, rot_heads, d):
    """Launch the Triton kernel on a CUDA tensor: rotates the q|k lanes of
    ``packed`` in place and returns it."""
    b, s, lanes = packed.shape
    if packed.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rope_pack: unsupported dtype {packed.dtype}")
    if d % 2 or rot_heads * d > lanes:
        raise ValueError(f"rope_pack: {rot_heads} heads of {d} in {lanes} lanes")
    if not packed.is_contiguous():
        raise ValueError("rope_pack: packed must be contiguous (it is updated in place)")
    for t in (cos, sin):
        if t.shape != (b, s, d) or t.device != packed.device:
            raise ValueError(f"rope_pack: cos/sin must be ({b}, {s}, {d}) on "
                             f"{packed.device}")
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    half = d // 2
    rows = b * s
    _kernel()[(-(-rows // _BLOCK_R),)](
        packed, cos, sin, rows, lanes, d, rot_heads, D=d, HALF=half,
        HALF_P2=1 << (half - 1).bit_length(), BLOCK_R=_BLOCK_R, num_warps=4)
    rope_pack_launch.launches += 1
    return packed


rope_pack_launch.launches = 0


def rope_pack(packed: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              rot_heads: int, d: int) -> torch.Tensor:
    """Rotate the q|k lanes of a packed (B, S, L) row: the Triton kernel (in
    place) for CUDA tensors, the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return rope_pack_plain(packed, cos, sin, rot_heads, d)
    if packed.device.type != "cuda":
        raise ValueError(f"rope_pack: no kernel for device {packed.device}")
    return rope_pack_launch(packed, cos, sin, rot_heads, d)
