"""The CUDA norms' launch plan, on the CPU.

``ops/norms.py:layer_norm_plan`` decides how ``csrc/row_norm.cuh`` (the body
of both the LayerNorm and the RMSNorm kernel) lays
rows over warps, lanes and vectors, and the kernel only follows it. Here
each plan is held to the kernel's index arithmetic, simulated in numpy: lane
l of warp w of a row's warps holds the vectors q = (w * nv + i) * 32 + l of
vec elements (slots i < nv_cap, held while i < nv and q < d / vec), and
block b of the grid takes the rows b * rows_per_block + k * grid *
rows_per_block + slot. Every column of
a row and every row must be covered exactly once, no lane may hold more
values than the plan's limit, and the grid never exceeds one wave.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu_torch import build  # noqa: E402
from t2v_metrics_tpu_torch.ops import norms as N  # noqa: E402

SMS = 132
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
WIDTHS = [16, 64, 512, 768, 1000, 1001, 1024, 1152, 1408, 4608, 16384]


def _occupancy(vec, nv_cap, block_warps):
    """A stand-in for the card's occupancy: fewer blocks for wider ones."""
    return 16 // block_warps + (nv_cap * vec <= 20)


def _plan(rows, d, dtype, max_vec_bytes=16):
    size = torch.empty((), dtype=dtype).element_size()
    return N.layer_norm_plan(rows, d, size, SMS, _occupancy, max_vec_bytes), size


def _columns(plan, d):
    """(warps_per_row * 32 lanes, nv_cap * vec) column held by each slot of
    each lane of a row, -1 where the slot is predicated off."""
    w = np.arange(plan.warps_per_row)[:, None, None, None]
    lane = np.arange(32)[None, :, None, None]
    i = np.arange(plan.nv_cap)[None, None, :, None]
    k = np.arange(plan.vec)[None, None, None, :]
    q = (w * plan.nv + i) * 32 + lane
    cols = np.where((i < plan.nv) & (q < d // plan.vec), q * plan.vec + k, -1)
    return cols.reshape(32 * plan.warps_per_row, -1)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", WIDTHS)
def test_every_column_once_and_no_lane_over_its_limit(d, dtype):
    plan, size = _plan(2560, d, dtype)
    assert d % plan.vec == 0 and plan.vec * size <= 16
    cols = _columns(plan, d)
    held = cols[cols >= 0]
    np.testing.assert_array_equal(np.bincount(held, minlength=d), np.ones(d, int))
    per_lane = (cols >= 0).sum(1)
    assert per_lane.max() == plan.nv * plan.vec <= N.LN_MAX_PER_LANE
    assert plan.nv <= plan.nv_cap and plan.nv_cap * plan.vec <= N.LN_MAX_PER_LANE
    assert plan.nv_cap in N.LN_NV[size][plan.vec]
    # the fewest warps a row: at half of them a lane would hold too many values
    if plan.warps_per_row > 1:
        fewer = -(-d // (16 * plan.warps_per_row))        # values a lane at half the warps
        assert fewer > N.LN_MAX_PER_LANE


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 2560, 16384])
def test_every_row_once_in_one_wave(rows, d, dtype):
    plan, _ = _plan(rows, d, dtype)
    assert plan.block_warps % plan.warps_per_row == 0 and plan.block_warps <= 16
    assert plan.rows_per_block == plan.block_warps // plan.warps_per_row
    wave = SMS * _occupancy(plan.vec, plan.nv_cap, plan.block_warps)
    assert 1 <= plan.grid <= wave
    step = plan.grid * plan.rows_per_block
    block = np.arange(plan.grid)[:, None, None]
    it = np.arange(-(-rows // step))[None, :, None]
    slot = np.arange(plan.rows_per_block)[None, None, :]
    covered = (block * plan.rows_per_block + it * step + slot).ravel()
    covered = covered[covered < rows]
    np.testing.assert_array_equal(np.bincount(covered, minlength=rows), np.ones(rows, int))


@pytest.mark.parametrize("d,dtype,wpr,vec,nv", [
    (1024, torch.bfloat16, 1, 8, 4),     # CLIP ViT-L: 16-byte vectors, 4 a lane
    (1152, torch.bfloat16, 1, 4, 9),     # SigLIP / Qwen3 ViT: 8-byte, 9 a lane, no padding
    (4608, torch.bfloat16, 4, 4, 9),     # Qwen3 deepstack merger: 4 warps a row
    (1000, torch.bfloat16, 1, 8, 4),     # 125 vectors over 32 lanes: 3 predicated off
    (1001, torch.bfloat16, 1, 1, 32),    # odd: single values, 32 a lane
    (16384, torch.bfloat16, 16, 8, 4),   # the widest row: 16 warps, one a block
    (1152, torch.float32, 1, 4, 9),
    (1408, torch.bfloat16, 2, 2, 11),    # BLIP-2 EVA ViT-g: past one warp's 40 values
    (768, torch.bfloat16, 1, 8, 3),      # Q-Former, CLIP ViT-B / L-14 text
    (512, torch.bfloat16, 1, 8, 2),      # CLIP ViT-B text
])
def test_the_main_path_shapes(d, dtype, wpr, vec, nv):
    plan, _ = _plan(2560, d, dtype)
    assert (plan.warps_per_row, plan.vec, plan.nv) == (wpr, vec, nv)
    assert plan.block_warps == max(8, wpr)


def test_the_vit_l_site_is_one_wave_of_all_its_rows():
    """(2560, 1024) in 8-warp blocks of a row a warp: 320 blocks, all of
    them resident at once where 3 fit an SM."""
    plan = N.layer_norm_plan(2560, 1024, 2, SMS, lambda *_: 3)
    assert (plan.rows_per_block, plan.grid) == (8, 320)
    assert N.layer_norm_plan(2560, 1024, 2, SMS, lambda *_: 2).grid == 264


@pytest.mark.parametrize("max_vec_bytes,vec", [(16, 8), (8, 4), (4, 2), (2, 1)])
def test_alignment_narrows_the_vector(max_vec_bytes, vec):
    plan, _ = _plan(64, 1024, torch.bfloat16, max_vec_bytes)
    assert plan.vec == vec
    cols = _columns(plan, 1024)
    np.testing.assert_array_equal(np.bincount(cols[cols >= 0], minlength=1024),
                                  np.ones(1024, int))


def test_vec_bytes_takes_the_least_aligned_operand():
    assert N._vec_bytes((4096, 2048), (256, 0)) == 16
    assert N._vec_bytes((4096, 2048), (4104, 0)) == 8       # a weight 8 bytes off
    assert N._vec_bytes((4096, 2002), (256, 0)) == 2        # a row stride of 1001 bf16


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_too_wide_rows_raise(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    with pytest.raises(ValueError, match="16385"):
        N.layer_norm_plan(8, 16385, size, SMS, _occupancy)
    with pytest.raises(ValueError, match="16385"):
        N._rows_view(torch.zeros(2, 16385, dtype=dtype), "layer_norm")


def test_the_plan_lists_the_kernels_instantiations():
    """LN_NV is the (element size, vector, NV) list of the row-norm body's
    ``pick`` (csrc/row_norm.cuh, which csrc/layer_norm.cu and
    csrc/rms_norm.cu instantiate): the plan never asks for a kernel either
    library lacks."""
    for cu in ("layer_norm.cu", "rms_norm.cu"):
        assert '#include "row_norm.cuh"' in (build.CSRC_DIR / cu).read_text()
    src = (build.CSRC_DIR / "row_norm.cuh").read_text()
    body = src[src.index("Kernel pick(int vec, int nv)"):src.index("Kernel kernel_for(")]
    found = {int(v): tuple(int(n) for n in nvs.split(","))
             for v, nvs in re.findall(r"pick_nv<T, (\d+), ADD, ([\d, ]+)>", body)}
    assert found == N.LN_NV[2]
    assert {v: found[v] for v in N.LN_NV[4]} == N.LN_NV[4]
    assert "if constexpr (sizeof(T) == 2) return pick_nv<T, 8," in body
