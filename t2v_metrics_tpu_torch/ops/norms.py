"""LayerNorm and RMSNorm: Hopper kernels (LayerNorm in CUDA, RMSNorm in
Triton), with their plain versions.

Replaces the TPU kernels ``t2v_metrics_tpu/ops/norms.py:_ln_kernel``
(``layer_norm_fused``) and ``_rms_kernel`` (``rms_norm_fused``).

What bounds them on the H100: bytes. A row norm does a handful of flops per
element, far below the ~295 flop/byte at which the tensor cores, not HBM,
become the limit; the least time is one read of the bf16 input, one write of
the bf16 output and one read of the (d,) weights. The plain PyTorch version
makes several passes over an fp32 copy of the activation (convert, mean,
subtract, square, mean, scale), each a round trip through HBM.

LayerNorm (``csrc/layer_norm.cu``): a warp owns a row up to d = 1280 (the
ViT widths 1024 and 1152), a few warps a wider one (4 at d = 4608); each
lane loads its whole share of the row, in the widest vectors that lay the
row evenly over the lanes (16 bytes at d = 1024, 8 at d = 1152, so no column
is padded), before it uses the first; both fp32 statistics come from
registers and warp shuffles; a block loads the weights once, into shared
memory, for all of its rows; the grid is one wave of resident blocks with a
row loop inside. The launch plan (``layer_norm_plan``) is computed here and
tested on the CPU. ``add_layer_norm_fused`` folds the ViT blocks' residual
add into the same pass: it reads x and r once and writes s = x + r (rounded
once, bitwise the eager add) and the LayerNorm of s: 4 element-passes
instead of the 5 of an add and a norm, and one launch fewer.

RMSNorm (Triton): one program per row holds the whole row (d=2048 for
T5-xl) in registers, computes the fp32 statistic there and writes the bf16
result once; the column block is the next power of two above d and its tail
is masked. qk-norm (Qwen3) normalises each head of the q|k lanes of the
packed qkv projection, whose heads are not one strided 2-D view. The same
RMSNorm kernel, compiled with ``HEADS``, runs one program per token at the
token's row stride, loads its q|k heads (a head stride of d) as one
(heads, d) block with a statistic per head, picks the q or the k weight by
head, and writes in place (``rms_norm_heads_launch``): one launch per layer,
no copy of the q|k region, the v lanes untouched. Without ``HEADS`` the
kernel is the row kernel above.

The wrappers take the plain version only for a tensor on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
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


def add_layer_norm_plain(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor | None,
                         eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, LayerNorm(s)) for s = x + r, the eager add rounded to x's dtype."""
    s = x + r
    return s, layer_norm_plain(s, scale, bias, eps)


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
# The RMSNorm Triton kernel (built at first launch; triton is imported only there)
# ---------------------------------------------------------------------------

@functools.cache
def _rms_kernel():
    from ..build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

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

    return rms_kernel


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


# ---------------------------------------------------------------------------
# The CUDA LayerNorm (csrc/layer_norm.cu): launch plan and wrappers
# ---------------------------------------------------------------------------

# The instantiations of csrc/layer_norm.cu, by the row's element size and
# the vector's width in elements: the vectors a lane holds (NV). A lane
# holds at most LN_MAX_PER_LANE values of a row; the plan takes the least NV
# that holds its share.
LN_NV = {2: {8: (1, 2, 4, 5), 4: (1, 2, 4, 5, 9, 10), 2: (1, 5, 10, 20), 1: (1, 10, 20, 40)},
         4: {4: (1, 2, 4, 5, 9, 10), 2: (1, 5, 10, 20), 1: (1, 10, 20, 40)}}
LN_MAX_PER_LANE = 40
LN_BLOCK_WARPS = 8
LN_WARPS_PER_ROW = (1, 2, 4, 8, 16)
_LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    """How ``csrc/layer_norm.cu`` lays rows of d values over a launch.

    A row is d / ``vec`` vectors of ``vec`` elements, in strips of 32: warp
    w of the row's ``warps_per_row`` takes the ``nv`` strips from w * nv,
    lane l vector l of each (q = (w * nv + i) * 32 + l, i < nv, q < d /
    vec); the instantiation has room for ``nv_cap >= nv`` vectors a lane. A
    block of ``block_warps`` warps takes ``rows_per_block`` rows at a time,
    and the ``grid`` blocks (one wave at most) loop over the rows."""
    warps_per_row: int
    vec: int
    nv: int
    nv_cap: int
    block_warps: int
    rows_per_block: int
    grid: int


def layer_norm_plan(rows: int, d: int, itemsize: int, sms: int, blocks_per_sm,
                    max_vec_bytes: int = 16) -> LayerNormPlan:
    """The launch plan for ``rows`` rows of ``d`` values of ``itemsize``
    bytes on ``sms`` SMs. ``blocks_per_sm(vec, nv_cap, block_warps)`` is the
    resident blocks an SM of that instantiation (the card's occupancy);
    ``max_vec_bytes``, a power of two, bounds the vector by the alignment of
    the operands' addresses and row strides.

    The fewest warps a row that keep each lane at ``LN_MAX_PER_LANE``
    values at most; for each warp count the widest vector that lays the row
    evenly over the lanes, else the widest that divides d (the vectors past
    the row predicated off)."""
    if not 1 <= d <= _MAX_COLS:
        raise ValueError(f"layer_norm: row width {d} outside 1..{_MAX_COLS}")
    if itemsize not in LN_NV:
        raise ValueError(f"layer_norm: no kernel for {itemsize}-byte elements")
    vecs = [v for v in sorted(LN_NV[itemsize], reverse=True)
            if v * itemsize <= max_vec_bytes and d % v == 0]
    if not vecs:
        raise ValueError(f"layer_norm: operands not aligned to their {itemsize}-byte elements")
    for wpr in LN_WARPS_PER_ROW:
        lanes = 32 * wpr
        even = [v for v in vecs if d % (lanes * v) == 0]
        vec = (even or vecs)[0]
        nv = -(-d // (vec * lanes))
        if nv * vec <= LN_MAX_PER_LANE:
            break
    nv_cap = min(c for c in LN_NV[itemsize][vec] if c >= nv)
    block_warps = max(LN_BLOCK_WARPS, wpr)
    rows_per_block = block_warps // wpr
    wave = sms * blocks_per_sm(vec, nv_cap, block_warps)
    if wave < 1:
        raise RuntimeError(f"layer_norm: no block of {block_warps} warps fits an SM")
    return LayerNormPlan(wpr, vec, nv, nv_cap, block_warps, rows_per_block,
                         min(-(-rows // rows_per_block), wave))


def _vec_bytes(*spans) -> int:
    """The widest vector (bytes, a power of two up to 16) that keeps every
    (address, row stride in bytes) aligned."""
    v = 16
    for addr, stride in spans:
        while (addr | stride) % v:
            v //= 2
    return v


@functools.cache
def _ln_blocks_per_sm(device: int, dtype: int, add: bool, d: int, has_bias: bool,
                      vec: int, nv_cap: int, block_warps: int) -> int:
    """Resident blocks an SM of the instantiation (the card's occupancy,
    with the weights' shared memory)."""
    import ctypes

    from ..build import layer_norm_lib

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = layer_norm_lib().layer_norm_blocks_per_sm(
            dtype, vec, nv_cap, int(add), d, int(has_bias), block_warps, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"layer_norm_blocks_per_sm failed: CUDA error {rc}")
    return blocks.value


def _ln_launch(x, r, scale, bias, eps):
    """Launch csrc/layer_norm.cu on CUDA rows: y = LayerNorm(x), or with r,
    s = x + r and y = LayerNorm(s). Returns (s or None, y)."""
    from ..build import layer_norm_lib
    from .gemm import sm_count

    what = "layer_norm" if r is None else "add_layer_norm"
    x2 = _rows_view(x, what)
    r2 = None
    if r is not None:
        if r.shape != x.shape or r.dtype != x.dtype or r.device != x.device:
            raise ValueError(f"{what}: r {tuple(r.shape)} {r.dtype} must match x "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        r2 = _rows_view(r, what)
    scale = _check_weight(scale, x, what)
    if bias is not None:
        bias = _check_weight(bias, x, what)
    for w in (scale, bias):
        if w is not None and w.dtype != x.dtype:
            raise TypeError(f"{what}: weights must be {x.dtype}, got {w.dtype}")
    rows, d = x2.shape
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    s = None if r is None else torch.empty_like(y)
    if rows:
        size = x2.element_size()
        spans = [(t.data_ptr(), t.stride(0) * size) for t in (x2, r2, y, s) if t is not None]
        spans += [(w.data_ptr(), 0) for w in (scale, bias) if w is not None]
        dt = _LN_DTYPES[x.dtype]
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        occupancy = functools.partial(_ln_blocks_per_sm, dev, dt, r is not None, d,
                                      bias is not None)
        plan = layer_norm_plan(rows, d, size, sm_count(x.device), occupancy,
                               _vec_bytes(*spans))
        rc = layer_norm_lib().layer_norm_forward(
            x2.data_ptr(), None if r2 is None else r2.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), None if s is None else s.data_ptr(),
            y.data_ptr(), x2.stride(0), 0 if r2 is None else r2.stride(0), rows, d, dt,
            plan.vec, plan.nv_cap, plan.nv, plan.warps_per_row, plan.block_warps, plan.grid,
            eps, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"layer_norm_forward launch failed: CUDA error {rc}")
        layer_norm_launch.launches += 1
    return (None if s is None else s.reshape(x.shape)), y.reshape(x.shape)


def layer_norm_launch(x, scale, bias, eps):
    """Launch the LayerNorm kernel on a CUDA tensor. ``launches`` counts the
    launches of both entries, this and ``add_layer_norm_launch``."""
    return _ln_launch(x, None, scale, bias, eps)[1]


layer_norm_launch.launches = 0


def add_layer_norm_launch(x, r, scale, bias, eps):
    """Launch the LayerNorm kernel with the residual add folded in, on CUDA
    tensors: (s, y) for s = x + r, y = LayerNorm(s)."""
    return _ln_launch(x, r, scale, bias, eps)


def rms_norm_launch(x, scale, eps, offset, cast_weight_dtype):
    """Launch the RMSNorm kernel on a CUDA tensor."""
    x2 = _rows_view(x, "rms_norm")
    scale = _check_weight(scale, x, "rms_norm")
    y = torch.empty_like(x2)
    block, warps = _block(x2.shape[1])
    rms_kernel = _rms_kernel()
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
    rms_kernel = _rms_kernel()
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
    """LayerNorm over the last axis: the CUDA kernel on CUDA, the plain
    version on CPU."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return layer_norm_launch(x, scale, bias, eps)


def add_layer_norm_fused(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor | None,
                         eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, LayerNorm(s)) for the residual sum s = x + r (rounded once to x's
    dtype, as the eager add): the CUDA kernel in one pass on CUDA, the add
    and the plain version on CPU."""
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, r, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm: no kernel for device {x.device}")
    return add_layer_norm_launch(x, r, scale, bias, eps)


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
