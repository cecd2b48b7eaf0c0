"""LayerNorm and RMSNorm: Hopper kernels in CUDA, with their plain versions.

Replaces the TPU kernels ``t2v_metrics_tpu/ops/norms.py:_ln_kernel``
(``layer_norm_fused``) and ``_rms_kernel`` (``rms_norm_fused``).

What bounds them on the H100: bytes. A row norm does a handful of flops per
element, far below the ~295 flop/byte at which the tensor cores, not HBM,
become the limit; the least time is one read of the bf16 input, one write of
the bf16 output and one read of the (d,) weights. The plain PyTorch version
makes several passes over an fp32 copy of the activation (convert, mean,
subtract, square, mean, scale), each a round trip through HBM.

Both norms are instantiations of one CUDA body (``csrc/row_norm.cuh``;
``csrc/layer_norm.cu``, ``csrc/rms_norm.cu``) with one launch plan: a warp
owns a row up to d = 1280 (the ViT widths 1024 and 1152, the talker's
1024), a few warps a wider one (4 at d = 4608, 8 at 3584); each lane loads
its whole share of the row, in the widest vectors that lay the row evenly
over the lanes (16 bytes at d = 1024, 8 at d = 1152, so no column is
padded), before it uses the first; the fp32 statistics come from registers
and warp shuffles; a block loads the weights once, into shared memory, for
all of its rows; the grid is one wave of resident blocks with a row loop
inside. The launch plan (``layer_norm_plan``) is computed here and tested on
the CPU. ``add_layer_norm_fused`` and ``add_rms_norm_fused`` fold a residual
add into the same pass: they read x and r once and write s = x + r (rounded
once, bitwise the eager add) and the norm of s: 4 element-passes instead of
the 5 of an add and a norm, and one launch fewer.

RMSNorm keeps the JAX semantics: the fp32 statistic mean(x^2), ``eps``, the
Gemma ``offset`` added to the weight in the weight's dtype, and T5's
``cast_weight_dtype`` (the normalized value rounded to the weight dtype
before a correctly rounded product). The qk-norm of the decoders (RMSNorm
over each q|k head of the packed qkv row) runs inside the rotary embedding's
kernel (``ops/rope.py:rms_norm_rope_pack``); ``rms_norm_heads_plain`` is its
plain first half.

The wrappers take the plain version only for a tensor on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import tracing


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


def add_rms_norm_plain(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6, offset: float = 0.0,
                       cast_weight_dtype: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, RMSNorm(s)) for s = x + r, the eager add rounded to x's dtype."""
    s = x + r
    return s, rms_norm_plain(s, scale, eps, offset, cast_weight_dtype)


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


# ---------------------------------------------------------------------------
# The CUDA norms (csrc/row_norm.cuh): launch plan and wrappers
# ---------------------------------------------------------------------------

# The instantiations of csrc/row_norm.cuh (each norm's), by the row's element size and
# the vector's width in elements: the vectors a lane holds (NV). A lane
# holds at most LN_MAX_PER_LANE values of a row; the plan takes the least NV
# that holds its share.
LN_NV = {2: {8: (1, 2, 4, 5), 4: (1, 2, 4, 5, 9, 10), 2: (1, 5, 10, 20), 1: (1, 10, 20, 40)},
         4: {4: (1, 2, 4, 5, 9, 10), 2: (1, 5, 10, 20), 1: (1, 10, 20, 40)}}
LN_MAX_PER_LANE = 40
LN_MIN_EVEN_BYTES = 4
LN_BLOCK_WARPS = 8
LN_WARPS_PER_ROW = (1, 2, 4, 8, 16)
_LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    """How ``csrc/row_norm.cuh`` (LayerNorm and RMSNorm) lays rows of d
    values over a launch.

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
    values at most; for each warp count the widest vector of at least
    ``LN_MIN_EVEN_BYTES`` that lays the row evenly over the lanes, else the
    widest that divides d (the vectors past the row predicated off): a
    16-byte vector with some lanes idle (d = 3200, 5376, 12800) rather than
    one 2-byte value a load."""
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
        even = [v for v in vecs
                if d % (lanes * v) == 0 and v * itemsize >= LN_MIN_EVEN_BYTES]
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


def _lib(rms: bool):
    """The library of the norm: csrc/rms_norm.cu or csrc/layer_norm.cu, each
    with the C entries ``row_norm_forward`` and ``row_norm_blocks_per_sm``."""
    from ..build import layer_norm_lib, rms_norm_lib

    return rms_norm_lib() if rms else layer_norm_lib()


@functools.cache
def _blocks_per_sm(device: int, rms: bool, dtype: int, add: bool, d: int, has_bias: bool,
                   vec: int, nv_cap: int, block_warps: int) -> int:
    """Resident blocks an SM of the instantiation (the card's occupancy,
    with the weights' shared memory)."""
    import ctypes

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib(rms).row_norm_blocks_per_sm(dtype, vec, nv_cap, int(add), d, int(has_bias),
                                              block_warps, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{'rms' if rms else 'layer'}_norm_blocks_per_sm failed: "
                           f"CUDA error {rc}")
    return blocks.value


@functools.lru_cache(maxsize=4096)
def _plan(device: int, rms: bool, dtype: int, add: bool, rows: int, d: int, itemsize: int,
          has_bias: bool, vec_bytes: int) -> LayerNormPlan:
    """``layer_norm_plan`` for one launch on CUDA device ``device``, kept: a
    decode step asks for the same few plans at every layer, and the host's
    time a launch is what bounds a decode step."""
    from .gemm import sm_count

    occupancy = functools.partial(_blocks_per_sm, device, rms, dtype, add, d, has_bias)
    return layer_norm_plan(rows, d, itemsize, sm_count(torch.device("cuda", device)),
                           occupancy, vec_bytes)


def _rows(t: torch.Tensor, what: str) -> tuple[torch.Tensor, int]:
    """``t`` as rows of its last dimension, and their stride: ``t`` itself
    where it is contiguous (the decode step's case, with no view made),
    else ``_rows_view``'s 2-D view."""
    if t.is_contiguous():
        if t.dtype not in _LN_DTYPES:
            raise TypeError(f"{what}: unsupported dtype {t.dtype}")
        if t.shape[-1] > _MAX_COLS:
            raise ValueError(f"{what}: row width {t.shape[-1]} > {_MAX_COLS}")
        return t, t.shape[-1]
    t2 = _rows_view(t, what)
    return t2, t2.stride(0)


def _norm_launch(what, x, r, scale, bias, eps, rms=None, grid=None):
    """Launch a norm of csrc/row_norm.cuh on CUDA rows: y = norm(x), or with
    r, s = x + r and y = norm(s). ``rms`` (offset, cast_weight_dtype) picks
    RMSNorm, else LayerNorm; ``grid`` overrides the plan's blocks (a check
    that the rows do not depend on it). Returns (s or None, y). A decode
    step is bound by the host's time a launch, so this does the least it can
    there: no view of contiguous rows, a kept plan, the raw stream."""
    x2, x_stride = _rows(x, what)
    r2, r_stride = None, 0
    if r is not None:
        if r.shape != x.shape or r.dtype != x.dtype or r.device != x.device:
            raise ValueError(f"{what}: r {tuple(r.shape)} {r.dtype} must match x "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        r2, r_stride = _rows(r, what)
    scale = _check_weight(scale, x, what)
    if bias is not None:
        bias = _check_weight(bias, x, what)
    for w in (scale, bias):
        if w is not None and w.dtype != x.dtype:
            raise TypeError(f"{what}: weights must be {x.dtype}, got {w.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x, memory_format=torch.contiguous_format)   # dense rows of d
    s = None if r is None else torch.empty_like(y)
    if rows:
        size = x.element_size()
        xp, wp, yp = x2.data_ptr(), scale.data_ptr(), y.data_ptr()
        rp = sp = bp = None
        aligned = xp | wp | yp | x_stride * size | d * size
        if r is not None:
            rp, sp = r2.data_ptr(), s.data_ptr()
            aligned |= rp | sp | r_stride * size
        if bias is not None:
            bp = bias.data_ptr()
            aligned |= bp
        dt = _LN_DTYPES[x.dtype]
        dev = x.get_device()
        plan = _plan(dev, rms is not None, dt, r is not None, rows, d, size, bias is not None,
                     _vec_bytes((aligned, 0)))
        if grid:
            plan = dataclasses.replace(plan, grid=grid)
        geo = (x_stride, r_stride, rows, d, dt, plan.vec, plan.nv_cap, plan.nv,
               plan.warps_per_row, plan.block_warps, plan.grid)
        # the current stream's handle without a torch.cuda.Stream object
        stream = torch._C._cuda_getCurrentRawStream(dev)
        offset, cast = rms or (0.0, False)
        rc = _lib(rms is not None).row_norm_forward(xp, rp, wp, bp, sp, yp, *geo, eps,
                                                    float(offset), int(cast), stream)
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
        tracing.count("launch.layer_norm" if rms is None else "launch.rms_norm")
    return s, y


def layer_norm_launch(x, scale, bias, eps):
    """Launch the LayerNorm kernel on a CUDA tensor. The counter
    ``launch.layer_norm`` counts the launches of both entries, this and ``add_layer_norm_launch``."""
    return _norm_launch("layer_norm", x, None, scale, bias, eps)[1]


def add_layer_norm_launch(x, r, scale, bias, eps):
    """Launch the LayerNorm kernel with the residual add folded in, on CUDA
    tensors: (s, y) for s = x + r, y = LayerNorm(s)."""
    return _norm_launch("add_layer_norm", x, r, scale, bias, eps)


def rms_norm_launch(x, scale, eps, offset, cast_weight_dtype):
    """Launch the RMSNorm kernel on a CUDA tensor. The counter
    ``launch.rms_norm`` counts the launches of both entries, this and ``add_rms_norm_launch``."""
    return _norm_launch("rms_norm", x, None, scale, None, eps,
                        (offset, cast_weight_dtype))[1]


def add_rms_norm_launch(x, r, scale, eps, offset, cast_weight_dtype):
    """Launch the RMSNorm kernel with the residual add folded in, on CUDA
    tensors: (s, y) for s = x + r, y = RMSNorm(s)."""
    return _norm_launch("add_rms_norm", x, r, scale, None, eps, (offset, cast_weight_dtype))


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
    """RMSNorm over the last axis: the CUDA kernel on CUDA, the plain
    version on CPU."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps, offset, cast_weight_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    return rms_norm_launch(x, scale, eps, offset, cast_weight_dtype)


def add_rms_norm_fused(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6, offset: float = 0.0,
                       cast_weight_dtype: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, RMSNorm(s)) for the residual sum s = x + r (rounded once to x's
    dtype, as the eager add): the CUDA kernel in one pass on CUDA, the add
    and the plain version on CPU."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, r, scale, eps, offset, cast_weight_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: no kernel for device {x.device}")
    return add_rms_norm_launch(x, r, scale, eps, offset, cast_weight_dtype)


def rms_norm_heads_fused(packed: torch.Tensor, q_scale: torch.Tensor,
                         k_scale: torch.Tensor, n_q: int, n_k: int, d: int,
                         eps: float = 1e-6, offset: float = 0.0,
                         cast_weight_dtype: bool = True) -> torch.Tensor:
    """qk-norm over the q|k heads of a packed row, alone: the plain version
    (a new tensor) on CPU. On CUDA the qk-norm runs only inside the rotary
    embedding's kernel, ``ops/rope.py:rms_norm_rope_pack``, and this raises."""
    if packed.device.type == "cpu":
        return rms_norm_heads_plain(packed, q_scale, k_scale, n_q, n_k, d, eps,
                                    offset, cast_weight_dtype)
    raise ValueError(f"rms_norm_heads: no kernel of its own for device {packed.device}; "
                     "the qk-norm runs fused with rope in "
                     "ops/rope.py:rms_norm_rope_pack")
