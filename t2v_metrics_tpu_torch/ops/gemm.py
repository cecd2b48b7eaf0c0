"""Host side of the Hopper GEMM mainloop (``csrc/gemm_sm90.cuh``) that the
grouped GEMM (``ops/moe.py``) and the W8A8 GEMM (``ops/quant.py``) share:
the TMA tensor maps of their operands, the persistent tile walk, and the
split of K for shapes with too few tiles to fill the card.

The CUDA entries only encode the maps computed here and walk the units as
``walk_unit`` does; the CPU tests hold both against the tensors and the
kernel's order (``tests/test_torch_gemm_geometry.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

# csrc/gemm_sm90.cuh: 128 x 256 output tiles, k-blocks of one 128-byte
# swizzle span (64 bf16 or 128 int8), 4 stages of A and B
BM, BN, BK_BYTES, SWIZZLE = 128, 256, 128, 128
B_PANEL = 64            # columns of a B box in the MN-major (grouped) layout
GEO = 12                # int64 a map (gemm_sm90.cuh GEO)
STAGE_BYTES = (BM + BN) * BK_BYTES
HBM_BYTES_S = 3.35e12   # H100 SXM, NVIDIA's data sheet: split_k's cost model
MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """One operand's TMA tensor map: ``dims`` the extents, innermost first;
    ``strides`` the byte strides of dims 1..; ``box`` the elements of one
    copy; ``elem`` the element size in bytes. Element (c0, c1, c2) of the
    map is element ``c0 + c1 * strides[0] / elem + c2 * strides[1] / elem``
    from the tensor's ``data_ptr()``; the TMA fills boxes past the extents
    with zeros."""

    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]
    elem: int

    def packed(self, x: torch.Tensor) -> list[int]:
        """The GEO int64 the C entries read."""
        rank = len(self.dims)
        pad = 3 - rank
        return [x.data_ptr(), rank, *self.dims, *(1,) * pad, *self.strides,
                *(0,) * (2 - len(self.strides)), *self.box, *(1,) * pad, SWIZZLE, self.elem]


def _aligned(x: torch.Tensor, byte_strides, what: str, name: str) -> None:
    """What the TMA refuses, refused here: a base address off 16 bytes, a
    byte stride that is not a multiple of 16."""
    if x.data_ptr() % 16 or any(s % 16 for s in byte_strides):
        raise ValueError(f"{what}: {name} is not 16-byte aligned")


def kmajor_map(x: torch.Tensor, box_rows: int, what: str, name: str) -> TensorMap:
    """The 2-D map of a row-major (rows, K) tensor read K-major: boxes of
    128 bytes of k over ``box_rows`` rows (x_q, w_qt, xg)."""
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{what}: {name} must be a row-major matrix")
    rows, k = x.shape
    e = x.element_size()
    stride = x.stride(0) * e
    _aligned(x, (stride,), what, name)
    return TensorMap((k, rows), (stride,), (BK_BYTES // e, box_rows), e)


def expert_map(w: torch.Tensor, what: str = "grouped_gemm") -> TensorMap:
    """The 3-D map of the experts' weights w (E, K, N) in their JAX layout,
    read as the MN-major B operand: boxes of 64 columns x 64 k of one
    expert (four of them make a 256-column tile)."""
    if w.dim() != 3 or w.stride(2) != 1:
        raise ValueError(f"{what}: w must be (E, K, N) with unit column stride")
    e_, k, n = w.shape
    e = w.element_size()
    strides = (w.stride(1) * e, w.stride(0) * e)
    _aligned(w, strides, what, "w")
    return TensorMap((n, k, e_), strides, (B_PANEL, BK_BYTES // e, 1), e)


def geo_array(pairs) -> ctypes.Array:
    """The C entries' ``geo``: GEO int64 per (tensor, map) pair."""
    vals = [v for x, m in pairs for v in m.packed(x)]
    return (ctypes.c_longlong * len(vals))(*vals)


# ---------------------------------------------------------------------------
# The persistent tile walk (gemm_sm90.cuh Walk)
# ---------------------------------------------------------------------------

def walk_unit(u: int, n_mt: int, n_nt: int, group: int, splits: int,
              kb: int) -> tuple[int, int, int, int, int]:
    """(row tile, column tile, first k-block, end k-block, split) of unit u:
    split u % splits of tile u // splits, tiles rastered in groups of
    ``group`` row tiles with the row tile fastest."""
    t, split = divmod(u, splits)
    per_group = group * n_nt
    first = (t // per_group) * group
    gsize = min(n_mt - first, group)
    local = t % per_group
    return (first + local % gsize, local // gsize, split * kb // splits,
            (split + 1) * kb // splits, split)


def k_blocks(k: int, elem: int) -> int:
    return -(-k * elem // BK_BYTES)


def split_k(m: int, n: int, k: int, sms: int) -> int:
    """Splits of K for an int8 (M, K) x (K, N) product on ``sms`` SMs.

    Few tiles (the T5 decoder's M = pairs x 4 rows) would leave most SMs
    idle on a product bound by the weight bytes. The least modelled time
    wins: the waves of units each SM runs, each unit's k-blocks streamed at
    an SM's share of HBM, plus the int32 partials written and read again by
    the second pass. Ties go to fewer splits; one split needs no workspace.
    """
    tiles = -(-m // BM) * -(-n // BN)
    kb = k_blocks(k, 1)
    best, best_t = 1, math.inf
    for s in range(1, min(kb, MAX_SPLITS) + 1):
        waves = -(-tiles * s // sms)
        t = waves * -(-kb // s) * STAGE_BYTES * sms / HBM_BYTES_S
        if s > 1:
            t += 2 * s * tiles * BM * BN * 4 / HBM_BYTES_S
        if t < best_t * (1 - 1e-9):
            best, best_t = s, t
    return best


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
