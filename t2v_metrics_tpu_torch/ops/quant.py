"""Linear layers through weight leaves, and the W8A8 mode (port of
t2v_metrics_tpu/ops/quant.py).

A leaf is a ``Linear`` module holding either a dense ``w`` (in, out) or an
int8 weight with its per-output-channel f32 ``scale``, and an optional bias
``b``. Scheme, as in the JAX package:
  * weights: symmetric per-output-channel int8, scale = absmax/127 (floor
    1e-12), quantized once at load (``quantize_t5_``,
    ``quantize_clip_vision_``), in place, one leaf at a time, the dense leaf
    freed as it goes;
  * activations: symmetric per-row int8, quantized in front of every int8
    product (``quantize_rows``);
  * an exact int32 accumulation, then ``(f32(acc) * x_scale[m]) *
    w_scale[n]`` rounded once to the activation dtype (``quant_matmul``).
Embeddings, the lm_head, norms, rel-pos tables, the patch embedding and the
projector stay in the working dtype.

The int8 weight is stored transposed, ``w_qt`` (out, in) contiguous, and
read as ``w_q = w_qt.t()``, a (in, out) view: the JAX (K, N) layout at every
function's signature, and, for the kernel, each output column's K values
contiguous, the K-major B operand of the int8 ``wgmma`` (8-bit wgmma has no
transpose). It costs no extra memory.

The two kernels of the mode, each with its plain PyTorch version (the CPU
route and the oracle on the card) and a launch counter:

``quantize_rows`` (Triton) replaces ``_quantize_rows``
(t2v_metrics_tpu/ops/quant.py:52), a jnp chain with no Pallas kernel that
the JAX notes name as the W8A8 mode's main overhead
(t2v_metrics_tpu/ops/quant_matmul.py:19-26). Bound by bytes: one read of the
bf16 row and one int8 write, a few operations an element. The plain chain
makes five passes over an f32 copy (convert, abs, max, divide, round). One
program per row holds the whole row (K <= 16384) in registers: absmax,
``xs = max(absmax, 1e-12) / 127``, ``rint(x / xs)`` to int8 (round half to
even, a correctly rounded division, as ``torch.round(x / xs)``), the f32
scale. One read, one write.

``quant_matmul`` (CUDA C++, ``csrc/quant_matmul.cu``; its note there says
what bounds it and its design) replaces the TPU kernel
t2v_metrics_tpu/ops/quant_matmul.py:_kernel: s8 x s8 -> s32 over the whole
K, the dequant epilogue fused, the int32 accumulator never in device memory
except where few tiles make the wrapper split K (``ops/gemm.py split_k``:
the T5 decoder's rows), whose exact partial sums a second pass adds.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from .. import tracing
from ..parallel import comm
from . import gemm as G


class Linear(nn.Module):
    """Weight leaf: a dense ``w`` (in, out), or ``w_q`` (in, out) int8 with
    ``scale`` (out,) f32; optional ``b`` (out,)."""

    def __init__(self, w: torch.Tensor | None = None, b: torch.Tensor | None = None,
                 *, w_q: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if (w is None) == (w_q is None) or (w_q is None) != (scale is None):
            raise ValueError("Linear: give w, or w_q and scale")
        if w_q is not None and (w_q.dtype != torch.int8 or scale.dtype != torch.float32
                                or scale.shape != (w_q.shape[1],)):
            raise TypeError("Linear: w_q must be int8 (in, out) and scale f32 (out,)")
        self.w = None if w is None else nn.Parameter(w, requires_grad=False)
        self.w_qt = (None if w_q is None else
                     nn.Parameter(w_q.t().contiguous(), requires_grad=False))
        self.scale = (None if scale is None else
                      nn.Parameter(scale.contiguous(), requires_grad=False))
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)
        # packed leaves: ((label, units, unit width), ...) of the parts side by
        # side in the output, which tensor parallelism cuts each on its own
        self.parts = None
        # a row-parallel leaf (parallel/mesh.py:shard_params): the tp group its
        # product is all-reduced over, before the bias
        self.reduce_group = None

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, device, dtype):
        w = torch.empty((d_in, d_out), device=device, dtype=dtype)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, b)

    @property
    def d_out(self) -> int:
        """The output width (this rank's under tensor parallelism)."""
        return self.w.shape[1] if self.w is not None else self.w_qt.shape[0]

    @property
    def quantized(self) -> bool:
        return self.w_qt is not None

    @property
    def w_q(self) -> torch.Tensor:
        """The int8 weight as an (in, out) view of ``w_qt``."""
        return self.w_qt.t()

    @torch.no_grad()
    def quantize_(self) -> "Linear":
        """Quantize the dense weight in place and free it (a no-op on an
        int8 leaf)."""
        if not self.quantized:
            w_q, scale = quantize_weight(self.w, self.reduce_group)
            self.w = None
            self.w_qt = nn.Parameter(w_q.t().contiguous(), requires_grad=False)
            self.scale = nn.Parameter(scale, requires_grad=False)
        return self


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU route and the kernels' oracle)
# ---------------------------------------------------------------------------

def _absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-12) / 127 with a correctly rounded division. The 127
    is a tensor on absmax's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently."""
    return torch.clamp_min(absmax, 1e-12) / absmax.new_full((), 127.0)


def quantize_weight(w: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (K, N) weight: (w_q int8 (K, N),
    scale f32 (N,)). ``group``: the tp group of a row-parallel K-shard, over
    which each column's absmax is taken, as over the whole K."""
    wf = w.float()
    scale = _absmax_scale(comm.all_reduce(wf.abs().amax(dim=0), group, "max"))
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: (..., K) -> int8 (..., K), f32 scale
    (..., 1)."""
    xs = _absmax_scale(row_absmax_plain(x))
    return quantize_rows_scaled_plain(x, xs), xs


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row's max |x| in f32, (..., 1): the row quant's first step."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_rows_scaled_plain(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``rint(x / xs)`` to int8 with a given f32 scale (..., 1): the row
    quant's second step."""
    return torch.round(x.float() / xs).to(torch.int8)


def quant_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                       x_scale: torch.Tensor, w_scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8, then ``(f32(acc) * x_scale) *
    w_scale`` in f32, rounded once to ``out_dtype``.

    The product runs in float64, which is exact here: |acc| <= 127^2 * K
    < 2^53, and the conversion to f32 rounds as int32 -> f32 does.
    """
    acc = torch.matmul(x_q.double(), w_q.double()).float()
    return (acc * x_scale.reshape(-1, 1) * w_scale).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernels: the Triton row quant, the CUDA GEMM
# ---------------------------------------------------------------------------

_MAX_COLS = 16384


@functools.cache
def _quant_rows_kernel():
    from ..build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:  # older layouts keep libdevice in tl.math
        libdevice = tl.math

    @triton.jit
    def quant_rows_kernel(X, Q, S, x_stride, n_cols, BLOCK: tl.constexpr,
                          MODE: tl.constexpr):
        # MODE 0: absmax, scale and quantize; 1: the absmax only, into S;
        # 2: quantize with the scale S holds
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        cm = cols < n_cols
        x = tl.load(X + row * x_stride + cols, mask=cm, other=0.0).to(tl.float32)
        if MODE == 1:
            tl.store(S + row, tl.max(tl.abs(x), axis=0))
        else:
            if MODE == 2:
                xs = tl.load(S + row)
            else:
                # correctly rounded divisions, as torch's
                xs = libdevice.div_rn(tl.maximum(tl.max(tl.abs(x), axis=0), 1e-12), 127.0)
            # rint rounds half to even
            q = libdevice.rint(libdevice.div_rn(x, xs))
            tl.store(Q + row * n_cols + cols, q.to(tl.int8), mask=cm)
            if MODE == 0:
                tl.store(S + row, xs)

    return quant_rows_kernel


def _quant_rows_run(x: torch.Tensor, mode: int, xs: torch.Tensor | None = None):
    """Launch the row-quant kernel in ``mode`` on a CUDA tensor: (x_q int8 or
    None, the (..., 1) f32 scale or absmax)."""
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"quantize_rows: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    if not 0 < k <= _MAX_COLS:
        raise ValueError(f"quantize_rows: row width {k} not in 1..{_MAX_COLS}")
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    x_q = (None if mode == 1 else
           torch.empty((rows, k), dtype=torch.int8, device=x.device))
    if xs is None:
        s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    else:
        s = xs.reshape(rows, 1)
        if s.dtype != torch.float32 or s.device != x.device or not s.is_contiguous():
            raise ValueError("quantize_rows: the scale must be a contiguous f32 (rows, 1) "
                             "on x's device")
    if rows:
        block = 1 << (k - 1).bit_length()
        _quant_rows_kernel()[(rows,)](x2, s if x_q is None else x_q, s, x2.stride(0), k,
                                      BLOCK=block, MODE=mode,
                                      num_warps=max(1, min(16, block // 256)))
        tracing.count("launch.quantize_rows")
    return (None if x_q is None else x_q.reshape(x.shape)), s.reshape(*x.shape[:-1], 1)


def quantize_rows_launch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the row-quant kernel on a CUDA tensor."""
    return _quant_rows_run(x, 0)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8: the Triton kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: no kernel for device {x.device}")
    return quantize_rows_launch(x)


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """The row quant's first step, each row's max |x| (..., 1) in f32: the
    kernel (one launch) on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_absmax: no kernel for device {x.device}")
    return _quant_rows_run(x, 1)[1]


def quantize_rows_scaled(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The row quant's second step, ``rint(x / xs)`` to int8 with the given
    (..., 1) f32 scale: the kernel (one launch) on CUDA, the plain version
    on CPU."""
    if x.device.type == "cpu":
        return quantize_rows_scaled_plain(x, xs)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_scaled: no kernel for device {x.device}")
    return _quant_rows_run(x, 2, xs.contiguous())[0]


def _quant_matmul_run(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale):
    """Launch the CUDA GEMM: the bf16 product, or with no scales the exact
    int32 partial sums of each split of K, (splits, M, N)."""
    from ..build import quant_matmul_lib

    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: x_q {tuple(x_q.shape)} does not fit w_q {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 32 or n % 8:
        raise ValueError(f"quant_matmul: needs K % 32 == 0 and N % 8 == 0, got K {k}, N {n}")
    partials = x_scale is None
    if not partials and (x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32
                         or x_scale.numel() != m or w_scale.shape != (n,)):
        raise ValueError(f"quant_matmul: scales must be f32 ({m}, 1) and ({n},)")
    w_qt = w_q.t()
    operands = ((x_q, "x_q"), (w_qt, "w_q.t()"))
    if not partials:
        operands += ((x_scale, "x_scale"), (w_scale, "w_scale"))
    _check_aligned("quant_matmul", x_q.device, operands)
    sms = G.sm_count(x_q.device)
    splits = G.split_k(m, n, k, sms)
    # split K: the exact int32 partial sums of each split, summed by the
    # kernel's second pass (allocated here; the kernel allocates nothing)
    part = (torch.empty((splits, m, n), dtype=torch.int32, device=x_q.device)
            if splits > 1 or partials else None)
    out = None if partials else torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    if m == 0:
        return part if partials else out
    geo = G.geo_array(((x_q, G.kmajor_map(x_q, G.BM, "quant_matmul", "x_q")),
                       (w_qt, G.kmajor_map(w_qt, G.BN, "quant_matmul", "w_q.t()"))))
    units = -(-m // G.BM) * -(-n // G.BN) * splits
    rc = quant_matmul_lib()(geo, None if partials else x_scale.data_ptr(),
                            None if partials else w_scale.data_ptr(),
                            None if partials else out.data_ptr(),
                            None if part is None else part.data_ptr(), m, n, k, splits,
                            min(units, sms), torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul_forward launch failed: CUDA error {rc}")
    tracing.count("launch.quant_matmul")
    return part if partials else out


def _check_aligned(name: str, device, operands) -> None:
    for t, what in operands:
        if t.device != device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")


def quant_matmul_launch(x_q: torch.Tensor, w_q: torch.Tensor,
                        x_scale: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x_q (M, K) int8 contiguous, w_q (K, N) int8
    with ``w_q.t()`` contiguous (the leaf's ``w_q``), x_scale (M, 1) and
    w_scale (N,) f32 -> (M, N) bf16. K must be a multiple of 32, N of 8."""
    return _quant_matmul_run(x_q, w_q, x_scale, w_scale)


def quant_matmul_partials_launch(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel for its exact int32 partial sums only:
    (splits, M, N), the splits of K it picks (``ops/gemm.py split_k``)."""
    return _quant_matmul_run(x_q, w_q, None, None)


def quant_matmul_dequant_launch(part: torch.Tensor, x_scale: torch.Tensor,
                                w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel's second pass on int32 partials (S, M, N): their
    sum dequantized with x_scale (M, 1) and w_scale (N,) f32 -> (M, N) bf16."""
    from ..build import quant_matmul_dequant_lib

    if part.dtype != torch.int32 or part.dim() != 3:
        raise TypeError(f"quant_matmul_dequant: part must be int32 (S, M, N), got "
                        f"{part.dtype} {tuple(part.shape)}")
    s, m, n = part.shape
    if n % 8 or x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32 \
            or x_scale.numel() != m or w_scale.shape != (n,):
        raise ValueError(f"quant_matmul_dequant: needs N % 8 == 0 and f32 scales ({m}, 1) "
                         f"and ({n},), got N {n}")
    _check_aligned("quant_matmul_dequant", part.device,
                   ((part, "part"), (x_scale, "x_scale"), (w_scale, "w_scale")))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=part.device)
    if m == 0:
        return out
    rc = quant_matmul_dequant_lib()(part.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                                    out.data_ptr(), m, n, s,
                                    torch.cuda.current_stream(part.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul_dequant launch failed: CUDA error {rc}")
    tracing.count("launch.quant_matmul")
    return out


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W8A8 GEMM with the fused dequant epilogue: the CUDA kernel for CUDA
    tensors (bf16 out only), the plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return quant_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x_q.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul: the kernel writes bf16, not {out_dtype}")
    return quant_matmul_launch(x_q, w_q, x_scale, w_scale)


def quant_matmul_partials_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums x_q (M, K) @ w_q (K, N) as one split, (1, M, N)."""
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)[None]


def quant_matmul_dequant_plain(part: torch.Tensor, x_scale: torch.Tensor,
                               w_scale: torch.Tensor,
                               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The sum of int32 partials (S, M, N), then ``(f32(acc) * x_scale) *
    w_scale`` rounded once to ``out_dtype``, as ``quant_matmul_plain``."""
    acc = part.sum(0).float()
    return (acc * x_scale.reshape(-1, 1) * w_scale).to(out_dtype)


def quant_matmul_partials(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 partial sums of an int8 product, (splits, M, N): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return quant_matmul_partials_plain(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_matmul_partials: no kernel for device {x_q.device}")
    return quant_matmul_partials_launch(x_q, w_q)


def quant_matmul_sums(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of an int8 product as one split, (1, M, N): the
    kernel's partials with its splits of K (up to ``G.MAX_SPLITS`` for few
    rows) summed here, so a collective over them moves M x N int32 whatever
    the split. Exact: each sum is at most 127^2 K, inside int32 for the
    port's K."""
    part = quant_matmul_partials(x_q, w_q)
    return part if part.shape[0] == 1 else part.sum(0, keepdim=True, dtype=torch.int32)


def quant_matmul_dequant(part: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Partials (S, M, N) summed and dequantized: the kernel's second pass
    for CUDA tensors (bf16 out), the plain version for CPU tensors."""
    if part.device.type == "cpu":
        return quant_matmul_dequant_plain(part, x_scale, w_scale, out_dtype)
    if part.device.type != "cuda":
        raise ValueError(f"quant_matmul_dequant: no kernel for device {part.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul_dequant: the kernel writes bf16, not {out_dtype}")
    return quant_matmul_dequant_launch(part, x_scale.contiguous(), w_scale)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                group=None) -> torch.Tensor:
    """x (..., K) @ int8 w_q (K, N) with f32 per-channel scale (N,), in the
    dtype of x.

    ``group``: the tp group of a row-parallel product, whose x and w_q are
    this rank's K-shards. It computes the JAX function as GSPMD partitions
    it: each row's absmax is all-reduced (max) before the shard is quantized,
    so the scale is the whole row's; the int32 sums, their splits of K
    summed locally first, are all-reduced (exact) and only then
    dequantized. So the product is bitwise the unsharded one."""
    k, n = w_q.shape
    if group is None:
        x_q, xs = quantize_rows(x)
        out = quant_matmul(x_q.reshape(-1, k), w_q, xs.reshape(-1, 1), scale, x.dtype)
    else:
        xs = _absmax_scale(comm.all_reduce(row_absmax(x), group, "max"))
        part = quant_matmul_sums(quantize_rows_scaled(x, xs).reshape(-1, k), w_q)
        out = quant_matmul_dequant(comm.all_reduce(part, group), xs.reshape(-1, 1), scale,
                                   x.dtype)
    return out.reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# Products through leaves
# ---------------------------------------------------------------------------

def pack(ps: list[Linear]) -> Linear:
    """One leaf whose columns are the leaves' columns side by side, in order
    (q | k | v for a qkv projection). int8 leaves pack their weights and
    scales (the per-row activation quant is shared, so the packed product
    equals the separate ones); a pack of int8 and dense leaves raises.
    Biases pack all-or-none."""
    kinds = {p.quantized for p in ps}
    if len(kinds) != 1:
        raise ValueError("pack: leaves must be all int8 or all dense")
    bs = [p.b for p in ps]
    if any(b is None for b in bs) and not all(b is None for b in bs):
        raise ValueError("pack: biases must be all present or all absent")
    b = None if bs[0] is None else torch.cat(bs)
    if kinds.pop():
        out = Linear(b=b, w_q=torch.cat([p.w_qt for p in ps]).t(),
                     scale=torch.cat([p.scale for p in ps]))
    else:
        out = Linear(torch.cat([p.w for p in ps], dim=1), b)
    out.parts = tuple((f"columns of part {i}", p.d_out, 1) for i, p in enumerate(ps))
    return out


def mm(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """x @ w through a leaf, dense or int8. A row-parallel leaf's partial
    products are all-reduced over its tp group: int8 the exact int32 sums;
    dense the fp32 partials (the GEMM's own accumulator type), rounded once
    to x's dtype after the sum, as one GEMM over the whole K rounds."""
    if p.quantized:
        return int8_matmul(x, p.w_q, p.scale, p.reduce_group)
    if p.reduce_group is None:
        return x @ p.w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        part = torch.mm(x2, p.w, out_dtype=torch.float32)
    else:
        part = x2.float() @ p.w.float()
    y = comm.all_reduce(part, p.reduce_group).to(x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def mm_packed(x: torch.Tensor, ps: list[Linear]) -> torch.Tensor:
    """One wide product over horizontally packed leaves [p_q, p_k, p_v].

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


# ---------------------------------------------------------------------------
# Quantizing a model in place
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_t5_(t5: nn.Module) -> nn.Module:
    """Quantize a T5 model's linears in place (the leaves of
    ``quantize_t5_params``): self-attention q|k|v (packed) and o,
    cross-attention q, k, v and o, and the MLP. A gated MLP's wi_0 and wi_1
    become one packed int8 leaf ``wi_01`` (the product that
    t2v_metrics_tpu/models/t5.py:161-168 runs under int8). Embeddings,
    lm_head, norms and rel-pos tables stay as they are. Leaves already int8
    are kept."""
    for stack in (t5.encoder, t5.decoder):
        for blk in stack.blocks:
            leaves = [blk.attn.qkv, blk.attn.o, blk.mlp.wo]
            if hasattr(blk, "cross"):
                leaves += [blk.cross.q, blk.cross.k, blk.cross.v, blk.cross.o]
            for name in ("wi", "wi_0", "wi_1"):
                if hasattr(blk.mlp, name):
                    leaves.append(getattr(blk.mlp, name))
            for leaf in leaves:
                leaf.quantize_()
            pack_gated_mlp_(blk.mlp)
    return t5


def pack_gated_mlp_(mlp: nn.Module) -> None:
    """Replace int8 ``wi_0`` and ``wi_1`` leaves by their pack ``wi_01``."""
    if hasattr(mlp, "wi_0") and mlp.wi_0.quantized and mlp.wi_1.quantized:
        mlp.wi_01 = pack([mlp.wi_0, mlp.wi_1])
        del mlp.wi_0, mlp.wi_1


@torch.no_grad()
def quantize_clip_vision_(vision: nn.Module) -> nn.Module:
    """Quantize a CLIP vision tower's attention and MLP linears in place
    (q|k|v packed, o, fc1, fc2; biases kept). The patch and position
    embeddings, norms and output projection stay as they are."""
    for blk in vision.blocks:
        for leaf in (blk.qkv, blk.o, blk.fc1, blk.fc2):
            leaf.quantize_()
    return vision
