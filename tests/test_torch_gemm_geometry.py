"""The GEMM kernels' host side, on the CPU (``ops/gemm.py``, the Python
side of ``csrc/gemm_sm90.cuh``).

* Tensor maps: the storage index every map coordinate reads, computed from
  the map alone, must be the index of that element of the tensor (held
  against ``torch.as_strided``), for xg (P, K) and x_q / w_qt (rows, K)
  K-major, and the experts' w (E, K, N) as the 3-D MN-major map; the boxes
  must be what the kernels load; what the TMA refuses is refused first.
* The persistent tile walk (``walk_unit``, the mirror of the kernel's
  ``Walk``): the blocks of a grid visit every (row tile, column tile) and
  split exactly once, the splits' k ranges partition K, and ``split_k``
  fills the 132 SMs of an H100 at the T5 decoder's shapes.
* ``num_blocks``: the plain grouped GEMM with it equals the JAX reference on
  the used rows and gives zeros past them; ``moe_mlp_dispatch``, which now
  passes it, equals the JAX dispatch at qwen3-vl-moe-test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.ops import moe as jmoe  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.ops import gemm as G  # noqa: E402
from t2v_metrics_tpu_torch.ops import moe as tmoe  # noqa: E402

H100_SMS = 132


def _storage_index(x):
    """Storage element index of every element of x (torch.as_strided)."""
    n = x.untyped_storage().nbytes() // x.element_size()
    return torch.arange(n).as_strided(x.size(), x.stride(), x.storage_offset())


def _read_by_map(x, m):
    """Storage index the map reads at every coordinate inside its extents,
    indexed [c_{rank-1}, ..., c1, c0] (the tensor's own axis order)."""
    assert (x.data_ptr() - x.untyped_storage().data_ptr()) % m.elem == 0
    idx = torch.tensor(x.storage_offset())
    for dim, (ext, stride) in enumerate(zip(m.dims, (m.elem,) + m.strides)):
        assert stride % m.elem == 0
        shape = [1] * len(m.dims)
        shape[len(m.dims) - 1 - dim] = ext
        idx = idx + (torch.arange(ext) * (stride // m.elem)).reshape(shape)
    return idx


@pytest.mark.parametrize("rows,k,dtype,box_rows", [
    (147456 // 64, 2048, torch.bfloat16, 128),    # xg, gate_up K
    (384, 768, torch.bfloat16, 128),              # xg, down K
    (100, 4096, torch.int8, 128),                 # x_q, 25 pairs of the decoder
    (4096, 10240, torch.int8, 256),               # w_qt (N, K) of T5 wo
    (8, 32, torch.int8, 256),                     # one k32 step, N = 8
])
def test_kmajor_maps(rows, k, dtype, box_rows):
    x = torch.zeros((rows, k), dtype=dtype)
    m = G.kmajor_map(x, box_rows, "t", "x")
    assert torch.equal(_read_by_map(x, m), _storage_index(x))
    assert m.box == (G.BK_BYTES // x.element_size(), box_rows)
    assert m.box[0] * m.elem == 128 == G.SWIZZLE          # one swizzle span
    packed = m.packed(x)
    assert len(packed) == G.GEO and packed[0] == x.data_ptr() and packed[1] == 2
    assert packed[2:5] == [k, rows, 1] and packed[7:10] == [m.box[0], box_rows, 1]
    assert packed[10:] == [128, x.element_size()]


def test_kmajor_map_of_a_row_slice_and_the_leaf_weight():
    """A view into a wider buffer reads its own rows, and the int8 leaf's
    w_q.t() (the packed q|k|v weight) is read (N, K) as stored."""
    from t2v_metrics_tpu_torch.ops import quant as Q

    big = torch.zeros((40, 96), dtype=torch.int8)
    view = big[8:24]
    m = G.kmajor_map(view, 128, "t", "x")
    assert torch.equal(_read_by_map(view, m), _storage_index(view))
    leaf = Q.Linear(torch.randn(64, 48)).quantize_()
    m = G.kmajor_map(leaf.w_q.t(), 256, "t", "w")
    assert m.dims == (64, 48)
    assert torch.equal(_read_by_map(leaf.w_qt, m), _storage_index(leaf.w_qt))


@pytest.mark.parametrize("e,k,n", [(128, 2048, 1536), (128, 768, 2048), (3, 96, 128)])
def test_expert_map_is_mn_major(e, k, n):
    w = torch.zeros((e, k, n), dtype=torch.bfloat16)
    m = G.expert_map(w)
    assert m.dims == (n, k, e) and m.box == (G.B_PANEL, 64, 1)
    assert torch.equal(_read_by_map(w, m), _storage_index(w))
    assert G.BN % m.box[0] == 0 and m.box[0] * m.elem == G.SWIZZLE  # 4 panels a tile
    packed = m.packed(w)
    assert packed[1] == 3 and packed[5:7] == [n * 2, k * n * 2]


def test_map_refusals():
    """What the TMA refuses, the wrappers refuse before any launch."""
    x = torch.zeros((16, 96 + 8), dtype=torch.int8)[:, :96]   # row stride 104 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.kmajor_map(x, 128, "quant_matmul", "x_q")
    y = torch.zeros((16, 72), dtype=torch.bfloat16)[:, 8:]     # base 16 bytes in, stride 144
    assert G.kmajor_map(y, 128, "t", "x").strides == (144,)
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.kmajor_map(torch.zeros((16, 72), dtype=torch.bfloat16)[:, 4:], 128, "t", "x")
    with pytest.raises(ValueError):                             # not row-major
        G.kmajor_map(torch.zeros((64, 32), dtype=torch.int8).t(), 128, "t", "x")
    with pytest.raises(ValueError, match="16-byte aligned"):   # N * 2 bytes = 120
        G.expert_map(torch.zeros((2, 64, 60), dtype=torch.bfloat16))


def _walk(n_mt, n_nt, group, splits, kb, grid):
    """Every unit each block of the grid visits, as the kernel walks them."""
    units = n_mt * n_nt * splits
    seen = []
    for b in range(grid):        # block b walks units b, b + grid, ...
        seen += [G.walk_unit(u, n_mt, n_nt, group, splits, kb)
                 for u in range(b, units, grid)]
    return seen


@pytest.mark.parametrize("n_mt,n_nt,group,splits,kb,grid", [
    (1024, 6, 16, 1, 32, 132),   # gate_up, top-8: the used row blocks x 1536 / 256
    (1027, 8, 16, 1, 12, 132),   # down, a ragged last raster group
    (160, 48, 8, 1, 32, 132),    # xxl encoder q|k|v
    (1, 16, 8, 8, 80, 128),      # decoder wo, split K
    (1, 48, 8, 2, 32, 96),       # decoder q|k|v, split K
    (3, 5, 8, 3, 7, 11),         # uneven splits of a short K
])
def test_tile_walk_visits_each_unit_once(n_mt, n_nt, group, splits, kb, grid):
    seen = _walk(n_mt, n_nt, group, splits, kb, grid)
    keys = [(mt, nt, s) for mt, nt, _, _, s in seen]
    assert len(keys) == len(set(keys)) == n_mt * n_nt * splits
    assert {(mt, nt) for mt, nt, _ in keys} == {(i, j) for i in range(n_mt) for j in range(n_nt)}
    ranges = {}
    for mt, nt, k0, k1, s in seen:
        ranges.setdefault((mt, nt), []).append((k0, k1))
    for rs in ranges.values():
        rs.sort()
        assert rs[0][0] == 0 and rs[-1][1] == kb
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(rs, rs[1:] + [(kb, kb + 1)]))


def test_tile_walk_raster_keeps_row_tiles_together():
    """Consecutive units of the raster run row tiles of one group against
    one column tile: at gate_up a wave of 132 units touches 16-32 row
    blocks and at most 9 column tiles."""
    wave = [G.walk_unit(u, 1024, 6, 16, 1, 32) for u in range(132)]
    assert [w[0] for w in wave[:16]] == list(range(16)) and {w[1] for w in wave[:16]} == {0}
    assert len({w[0] for w in wave}) <= 32 and len({(w[0] // 16, w[1]) for w in wave}) <= 9


@pytest.mark.parametrize("m,k,n,lo", [
    (128, 10240, 4096, 120),     # T5 decoder wo, 32 pairs: 16 tiles
    (128, 4096, 4096, 120),      # decoder o / cross q: 16 tiles
    (100, 4096, 4096, 120),      # 25 pairs
    (1, 10240, 4096, 120),
    (128, 4096, 12288, 96),      # decoder q|k|v: 48 tiles, two splits
])
def test_split_k_fills_the_card_at_the_decoder_shapes(m, k, n, lo):
    s = G.split_k(m, n, k, H100_SMS)
    units = -(-m // G.BM) * -(-n // G.BN) * s
    assert s > 1 and lo <= units <= H100_SMS          # one wave, most SMs busy
    assert s <= G.k_blocks(k, 1)


@pytest.mark.parametrize("m,k,n", [(20480, 4096, 12288), (20480, 10240, 4096),
                                   (20480, 4096, 20480), (2560, 1024, 3072)])
def test_split_k_leaves_full_grids_whole(m, k, n):
    """Shapes with a tile an SM or more need no second pass."""
    assert G.split_k(m, n, k, H100_SMS) == 1


@pytest.mark.parametrize("e,k,n,tk", [(7, 64, 48, 300), (4, 48, 64, 9)])
def test_grouped_matmul_num_blocks_matches_jax_on_used_rows(e, k, n, tk):
    rng = np.random.default_rng(e)
    ids = rng.integers(0, e, (tk,))
    bm = 8
    *plan, used, counts = tmoe._plan(torch.from_numpy(ids), e, bm)
    _, _, be, p = plan
    np.testing.assert_array_equal(counts.numpy(), np.bincount(ids, minlength=e))
    want_used = int(sum(-(-c // bm) for c in np.bincount(ids, minlength=e)))
    assert used.dtype == torch.int32 and used.shape == (1,) and int(used) == want_used
    assert int(used) * bm < p                        # the E pad blocks follow
    xg = rng.standard_normal((p, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    got = tmoe.grouped_matmul(torch.from_numpy(xg), torch.from_numpy(w), be, bm, used).numpy()
    ref = np.asarray(jmoe.grouped_matmul_reference(jnp.asarray(xg), jnp.asarray(w),
                                                   jnp.asarray(be.numpy()), bm))
    rows = int(used) * bm
    np.testing.assert_allclose(got[:rows], ref[:rows], rtol=1e-5, atol=1e-5)
    assert not got[rows:].any()
    full = tmoe.grouped_matmul(torch.from_numpy(xg), torch.from_numpy(w), be, bm).numpy()
    np.testing.assert_allclose(full, ref, rtol=1e-5, atol=1e-5)   # without: every block


def test_moe_dispatch_with_num_blocks_matches_jax_at_qwen3_vl_moe_test():
    jcfg = jq3.resolve_config("qwen3-vl-moe-test").text
    tcfg = tq3.resolve_config("qwen3-vl-moe-test").text
    assert tcfg == tdec.DecoderConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(9)
    e, d, i = jcfg.num_experts, jcfg.d_model, jcfg.moe_d_ff
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    gate_up = (rng.standard_normal((e, d, 2 * i)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((e, i, d)) * 0.1).astype(np.float32)
    tp = tdec.MoE(tcfg, "cpu", torch.float32)
    with torch.no_grad():
        tp.router.w.copy_(torch.from_numpy(router))
        tp.gate_up.copy_(torch.from_numpy(gate_up))
        tp.down.copy_(torch.from_numpy(down))
    jp = {"router": {"w": jnp.asarray(router)}, "gate_up": jnp.asarray(gate_up),
          "down": jnp.asarray(down)}
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    calls = []
    real = tmoe.grouped_matmul

    def spy(xg, w, be, block_m, num_blocks=None):
        out = real(xg, w, be, block_m, num_blocks)
        calls.append((num_blocks, out))
        return out

    tmoe.grouped_matmul = spy
    try:
        got = tmoe.moe_mlp_dispatch(tp, tcfg, torch.from_numpy(x), block_m=8).numpy()
    finally:
        tmoe.grouped_matmul = real
    want = jmoe.moe_mlp_dispatch(jp, jcfg, jnp.asarray(x), block_m=8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    assert len(calls) == 2
    for num_blocks, out in calls:                     # gate_up, down: pad rows zero
        assert num_blocks is not None and not out[int(num_blocks) * 8:].any()
