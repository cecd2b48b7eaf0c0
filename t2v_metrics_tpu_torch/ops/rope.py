"""Rotary embedding on the q|k lanes of a packed qkv row, with the decoders'
qk-norm folded in: a Triton kernel for Hopper, with its plain versions.

Replaces the TPU kernel ``t2v_metrics_tpu/ops/rope.py:_kernel``
(``rope_pack``), and takes in the qk-norm mode of the RMSNorm kernel
(``t2v_metrics_tpu/ops/norms.py:_rms_kernel``, which the port ran as a
second pass over the same lanes). Semantics, on the first ``rot_heads * d``
lanes of a packed (B, S, L) row read as ``rot_heads`` heads of width d with
halves x1 | x2:

    out = x * cos + rotate_half(x) * sin,   rotate_half(x) = -x2 | x1

with x in its own dtype times **f32** cos/sin (B, S, d), the products and
the sum in f32 and one rounding at the end (``models/decoder.py:
apply_rope_bshd`` of the JAX package); the v lanes pass through unchanged.
``rms_norm_rope_pack`` first normalizes each head as the JAX decoder's
prefill branch does (``L.rms_norm`` over the head's d lanes with the q
scale on the first ``n_q`` heads and the k scale after them, the Gemma
``offset`` and T5's ``cast_weight_dtype`` as in ``ops/norms.py:
rms_norm_plain``), rounds the normalized head to the activation dtype, as
the JAX ``rms_norm`` returns it, and rotates that.

What bounds it on the H100: bytes. A handful of flops per element, one read
and one write of the q|k lanes (at the internvl3.5-8b prefill, 16 x 2688
rows x 40 heads of 128 bf16 lanes: 440 MB each way). The plain versions
slice, upcast, normalize, rotate by concatenation, multiply, add, downcast
and concatenate with v: some ten passes over an fp32 copy of the
activation; the port's earlier qk-norm kernel and rope kernel took two
passes over the lanes.

What the design does about it: the grid is (head groups, row blocks). A
program takes a block of rows and a group of heads, loads its rows'
cos/sin halves once (f32) and, for each head of its group, loads the two
halves, takes the head's fp32 sum of squares and normalizes it (``NORM``),
rotates in registers and stores both halves back in place. The q|k lanes
are written **in place** and the v lanes are never touched, so each
element crosses HBM twice and v not at all; the wrapper returns the input
tensor, where the plain versions return a new one. The plan
(``rope_plan``) splits the heads into groups until the grid has a few
programs an SM, so a decode step's 4 rows run as one program a head over
32 SMs where one program once walked all of the heads; the head groups of
one row block are neighbours in the launch order, so the cos/sin rows they
share are read once from HBM. A half width that is not a power of two
(d=80 in the Qwen ViT) is masked up to the next one. Triton serves this as
well as CUDA would: a fused elementwise pass with a per-head reduction of
at most 256 lanes, no tensor-core work and no reuse that asynchronous
copies could hide. The knobs of the TPU module (``T2V_ROPE_KERNEL``,
``T2V_ROPE_COMPUTE``, ``_MAX_LANES``) are Mosaic and XLA devices and are not
carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import tracing
from .norms import rms_norm_heads_plain


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


def rms_norm_rope_pack_plain(packed: torch.Tensor, q_scale: torch.Tensor,
                             k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                             n_q: int, n_k: int, d: int, eps: float = 1e-6,
                             offset: float = 0.0,
                             cast_weight_dtype: bool = True) -> torch.Tensor:
    """Plain version of the fused qk-norm and rotation: the qk-norm of the
    q|k heads, then ``rope_pack_plain`` over them. A new tensor."""
    normed = rms_norm_heads_plain(packed, q_scale, k_scale, n_q, n_k, d, eps, offset,
                                  cast_weight_dtype)
    return rope_pack_plain(normed, cos, sin, n_q + n_k, d)


@functools.cache
def _kernel():
    from ..build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    # The row and head counts only bound loops and masks: left unspecialized,
    # so that a run compiles one variant a head layout and row block, not one
    # for each count that is 1 or a multiple of 16.
    @triton.jit(do_not_specialize=["n_rows", "rot_heads", "n_q", "heads_per_prog"])
    def rope_kernel(X, Cos, Sin, Wq, Wk, n_rows, x_stride, rot_heads, n_q, heads_per_prog,
                    eps, offset, D: tl.constexpr, HALF: tl.constexpr, HALF_P2: tl.constexpr,
                    BLOCK_R: tl.constexpr, NORM: tl.constexpr, HAS_OFFSET: tl.constexpr,
                    CAST: tl.constexpr):
        rows = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, HALF_P2)
        cm = cols < HALF
        m = (rows < n_rows)[:, None] & cm[None, :]
        rows = rows.to(tl.int64)
        cs = rows[:, None] * D + cols[None, :]
        c1 = tl.load(Cos + cs, mask=m, other=0.0)
        c2 = tl.load(Cos + cs + HALF, mask=m, other=0.0)
        s1 = tl.load(Sin + cs, mask=m, other=0.0)
        s2 = tl.load(Sin + cs + HALF, mask=m, other=0.0)
        if NORM:
            wq1 = tl.load(Wq + cols, mask=cm, other=0.0).to(tl.float32)
            wq2 = tl.load(Wq + cols + HALF, mask=cm, other=0.0).to(tl.float32)
            wk1 = tl.load(Wk + cols, mask=cm, other=0.0).to(tl.float32)
            wk2 = tl.load(Wk + cols + HALF, mask=cm, other=0.0).to(tl.float32)
            if HAS_OFFSET:
                # the offset is added in the weight dtype, as the plain version does
                wq1 = (wq1 + offset).to(Wq.dtype.element_ty).to(tl.float32)
                wq2 = (wq2 + offset).to(Wq.dtype.element_ty).to(tl.float32)
                wk1 = (wk1 + offset).to(Wk.dtype.element_ty).to(tl.float32)
                wk2 = (wk2 + offset).to(Wk.dtype.element_ty).to(tl.float32)
        xp = X + rows[:, None] * x_stride + cols[None, :]
        h0 = tl.program_id(0) * heads_per_prog
        for j in range(heads_per_prog):
            h = h0 + j
            hm = m & (h < rot_heads)
            p1 = xp + h * D
            x1 = tl.load(p1, mask=hm, other=0.0).to(tl.float32)
            x2 = tl.load(p1 + HALF, mask=hm, other=0.0).to(tl.float32)
            if NORM:
                ss = tl.sum(x1 * x1, axis=1) + tl.sum(x2 * x2, axis=1)
                rstd = tl.rsqrt(ss / D + eps)[:, None]
                y1 = x1 * rstd
                y2 = x2 * rstd
                q = h < n_q
                w1 = tl.where(q, wq1, wk1)[None, :]
                w2 = tl.where(q, wq2, wk2)[None, :]
                if CAST:
                    # HF T5: the normalized value rounded to the weight dtype,
                    # then a correctly rounded product
                    y1 = y1.to(Wq.dtype.element_ty).to(tl.float32)
                    y2 = y2.to(Wq.dtype.element_ty).to(tl.float32)
                    n1 = (w1 * y1).to(Wq.dtype.element_ty)
                    n2 = (w2 * y2).to(Wq.dtype.element_ty)
                else:
                    n1 = w1 * y1
                    n2 = w2 * y2
                # the normalized head in the activation dtype, as JAX's
                # rms_norm returns it, is what the rotation reads
                x1 = n1.to(X.dtype.element_ty).to(tl.float32)
                x2 = n2.to(X.dtype.element_ty).to(tl.float32)
            tl.store(p1, (x1 * c1 - x2 * s1).to(X.dtype.element_ty), mask=hm)
            tl.store(p1 + HALF, (x2 * c2 + x1 * s2).to(X.dtype.element_ty), mask=hm)

    return rope_kernel


# The plan's knobs: rows a program (at most), heads a program (at most), and
# the programs an SM the head groups are split towards.
ROPE_BLOCK_R = 16
ROPE_MAX_HEADS = 8
ROPE_PROGRAMS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class RopePlan:
    """The launch of ``rot_heads`` heads over ``rows`` rows: programs of
    ``block_r`` rows and ``heads_per_prog`` heads, on a grid of (head
    groups, row blocks); ``num_warps`` a program."""
    block_r: int
    heads_per_prog: int
    grid: tuple[int, int]
    num_warps: int


@functools.lru_cache(maxsize=1024)
def rope_plan(rows: int, rot_heads: int, d: int, sms: int) -> RopePlan:
    """Row blocks of up to ``ROPE_BLOCK_R`` rows (the next power of two of a
    smaller row count, at least 2); the heads split into the fewest groups
    that give ``ROPE_PROGRAMS_PER_SM`` programs an SM, with at most
    ``ROPE_MAX_HEADS`` heads a program."""
    if rows < 1 or rot_heads < 1 or d < 2 or d % 2:
        raise ValueError(f"rope: {rows} rows of {rot_heads} heads of {d}")
    block_r = min(ROPE_BLOCK_R, max(2, 1 << (rows - 1).bit_length()))
    row_blocks = -(-rows // block_r)
    groups = min(rot_heads, -(-ROPE_PROGRAMS_PER_SM * sms // row_blocks))
    per = min(ROPE_MAX_HEADS, -(-rot_heads // groups))
    half_p2 = 1 << (d // 2 - 1).bit_length()
    return RopePlan(block_r, per, (-(-rot_heads // per), row_blocks),
                    max(1, min(4, block_r * half_p2 // 256)))


def _launch(packed, cos, sin, rot_heads, d, norm=None):
    """Launch the Triton kernel on a CUDA tensor, in place on ``packed``'s
    q|k lanes; ``norm`` (q_scale, k_scale, n_q, eps, offset,
    cast_weight_dtype) normalizes each head first."""
    from .gemm import sm_count

    what = "rope_pack" if norm is None else "rms_norm_rope_pack"
    b, s, lanes = packed.shape
    if packed.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what}: unsupported dtype {packed.dtype}")
    if d % 2 or rot_heads * d > lanes:
        raise ValueError(f"{what}: {rot_heads} heads of {d} in {lanes} lanes")
    if not packed.is_contiguous():
        raise ValueError(f"{what}: packed must be contiguous (it is updated in place)")
    for t in (cos, sin):
        if t.shape != (b, s, d) or t.device != packed.device:
            raise ValueError(f"{what}: cos/sin must be ({b}, {s}, {d}) on "
                             f"{packed.device}")
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    if norm is None:
        wq = wk = cos                       # not read
        n_q, eps, offset, cast = rot_heads, 0.0, 0.0, False
    else:
        wq, wk, n_q, eps, offset, cast = norm
        for w in (wq, wk):
            if w.shape != (d,) or w.device != packed.device or w.dtype != packed.dtype:
                raise ValueError(f"{what}: q/k scales must be ({d},) {packed.dtype} on "
                                 f"{packed.device}")
        wq, wk = wq.contiguous(), wk.contiguous()
    rows = b * s
    if rows:
        plan = rope_plan(rows, rot_heads, d, sm_count(packed.device))
        half = d // 2
        _kernel()[plan.grid](
            packed, cos, sin, wq, wk, rows, lanes, rot_heads, n_q, plan.heads_per_prog,
            float(eps), float(offset), D=d, HALF=half, HALF_P2=1 << (half - 1).bit_length(),
            BLOCK_R=plan.block_r, NORM=norm is not None, HAS_OFFSET=bool(offset),
            CAST=bool(cast), num_warps=plan.num_warps)
        tracing.count("launch.rope_pack")
    return packed


def rope_pack_launch(packed, cos, sin, rot_heads, d):
    """Launch the kernel on a CUDA tensor: rotates the q|k lanes of
    ``packed`` in place and returns it. The counter ``launch.rope_pack``
    counts the launches of both entries, this and
    ``rms_norm_rope_pack_launch``."""
    return _launch(packed, cos, sin, rot_heads, d)


def rms_norm_rope_pack_launch(packed, q_scale, k_scale, cos, sin, n_q, n_k, d, eps,
                              offset, cast_weight_dtype):
    """Launch the kernel with the qk-norm on a CUDA tensor: normalizes and
    rotates the q|k lanes of ``packed`` in place and returns it."""
    return _launch(packed, cos, sin, n_q + n_k, d,
                   (q_scale, k_scale, n_q, eps, offset, cast_weight_dtype))


def rope_pack(packed: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              rot_heads: int, d: int) -> torch.Tensor:
    """Rotate the q|k lanes of a packed (B, S, L) row: the Triton kernel (in
    place) for CUDA tensors, the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return rope_pack_plain(packed, cos, sin, rot_heads, d)
    if packed.device.type != "cuda":
        raise ValueError(f"rope_pack: no kernel for device {packed.device}")
    return rope_pack_launch(packed, cos, sin, rot_heads, d)


def rms_norm_rope_pack(packed: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, n_q: int, n_k: int, d: int,
                       eps: float = 1e-6, offset: float = 0.0,
                       cast_weight_dtype: bool = True) -> torch.Tensor:
    """The decoders' qk-norm and rotation of the q|k lanes of a packed (B, S,
    L) row, in one pass: the Triton kernel (in place) for CUDA tensors, the
    plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return rms_norm_rope_pack_plain(packed, q_scale, k_scale, cos, sin, n_q, n_k, d,
                                        eps, offset, cast_weight_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"rms_norm_rope_pack: no kernel for device {packed.device}")
    return rms_norm_rope_pack_launch(packed, q_scale, k_scale, cos, sin, n_q, n_k, d, eps,
                                     offset, cast_weight_dtype)
