"""The attention kernels' TMA tensor-map geometry, on the CPU.

``ops/attention.py`` computes each operand's map (base offset, extents, byte
strides, box, swizzle, zero-filled pad columns) and the CUDA entries only
encode it. Here each geometry is held against the tensor it describes: the
storage index every (batch, head, row, column) of the map reads, computed
from the geometry alone, must be the index of that element of head h in the
tensor, for every layout the models pass. The alignment checks must refuse
what the TMA refuses (a base address off 16 bytes, a byte stride that is not
a multiple of 16).
"""

import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu_torch.ops import attention as A  # noqa: E402


def _storage_index(x):
    """Storage element index of every element of x."""
    n = x.untyped_storage().nbytes() // x.element_size()
    return torch.arange(n).as_strided(x.size(), x.stride(), x.storage_offset())


def _read_by_map(x, geo):
    """(batch, head, row, col) -> storage index the map reads, for col < D."""
    d, *ext = geo.dims
    size = x.element_size()
    st = [s // size for s in geo.strides]
    heads, rows, batch = (ext[a - 1] for a in geo.axes)
    hs, rs, bs = (st[a - 1] for a in geo.axes)
    bi = torch.arange(batch)[:, None, None, None]
    hi = torch.arange(heads)[None, :, None, None]
    ri = torch.arange(rows)[None, None, :, None]
    ci = torch.arange(d)[None, None, None, :]
    return x.storage_offset() + geo.offset + ci + hi * hs + ri * rs + bi * bs


def _flat_heads(x, off, heads, rows, d):
    """Storage index of head h's columns of a flat (B, S, cols) tensor,
    as (B, heads, rows, d)."""
    idx = _storage_index(x)[:, :rows, off:off + heads * d]
    return idx.reshape(x.shape[0], rows, heads, d).transpose(1, 2)


def _check_box(geo, d, tile_rows):
    dp = A.padded_dim(d)
    assert geo.box[0] == A.panel_width(d)
    assert dp % geo.box[0] == 0
    assert geo.dims[0] == d and geo.pad == dp - d
    assert geo.box[geo.axes[1]] == tile_rows                 # the row axis
    assert geo.box[geo.axes[0]] == geo.box[geo.axes[2]] == 1
    assert geo.swizzle == (128 if geo.box[0] == 64 else 32)
    assert all(s % 16 == 0 for s in geo.strides)


@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 300, 4, 2, 128),     # Qwen decoder: packed, GQA
    (2, 150, 8, 4, 256),     # Gemma decoder: packed, GQA 8/4, d=256
    (3, 70, 16, 16, 72),     # Qwen3 ViT: d=72, ragged tiles
    (2, 200, 16, 16, 80),    # Qwen2.5 ViT: d=80
    (3, 257, 16, 16, 88),    # BLIP-2 EVA ViT-g: d=88, 257 rows, ragged tiles
    (4, 9, 4, 4, 64),        # T5 decoder self: sq < one tile
])
def test_packed_flat_geometry(b, s, h, kvh, d):
    qkv = torch.zeros((b, s, (h + 2 * kvh) * d), dtype=torch.bfloat16)
    bq, bk = A.tile_rows(d, s)
    for off, n, tile in ((0, h, bq), (h * d, kvh, bk), ((h + kvh) * d, kvh, bk)):
        geo = A.flat_geometry(qkv, off, n, s, d, tile)
        _check_box(geo, d, tile)
        assert torch.equal(_read_by_map(qkv, geo), _flat_heads(qkv, off, n, s, d))
        assert geo.packed(qkv)[0] == qkv.data_ptr() + 2 * off


def test_tile_rows_of_each_variant():
    """64-row q tiles over 64-key tiles (one consumer warpgroup) for Sq <= 64
    and for the per-head T5 bias beside the other terms at d=256; else two
    warpgroups' 128 rows over 128 keys (64 at d=256)."""
    assert A.tile_rows(64, 4) == (64, 64)
    assert A.tile_rows(256, 700, single=True) == (64, 64)
    assert A.tile_rows(256, 700) == (128, 64)
    assert A.tile_rows(72, 4096) == (128, 128)


def test_separate_flat_geometry_t5_cross():
    """T5 cross-attention: q (B, 4, H*D) and k/v (B, 130, H*D) apart, Sk
    not a multiple of the 128-key tile: the map's row extent is Sk, and the
    last tile's rows past it are the TMA's zero fill."""
    q = torch.zeros((3, 4, 4 * 64), dtype=torch.bfloat16)
    k = torch.zeros((3, 130, 4 * 64), dtype=torch.bfloat16)
    bq, bk = A.tile_rows(64, 4)
    assert (bq, bk) == (64, 64)       # sq <= 64: one warpgroup, 64-key tiles
    gq = A.flat_geometry(q, 0, 4, 4, 64, bq)
    gk = A.flat_geometry(k, 0, 4, 130, 64, bk)
    assert torch.equal(_read_by_map(q, gq), _flat_heads(q, 0, 4, 4, 64))
    assert torch.equal(_read_by_map(k, gk), _flat_heads(k, 0, 4, 130, 64))
    rows = gk.dims[gk.axes[1]]
    assert rows == 130 and gk.box[gk.axes[1]] == 64 and -(-rows // 64) * 64 == 192


@pytest.mark.parametrize("b,s,h,d", [(2, 300, 4, 72), (1, 130, 3, 64), (2, 70, 2, 256)])
def test_per_head_views_of_the_packed_projection(b, s, h, d):
    """SigLIP passes q, k, v as permuted views of its (B, S, 3*H*D)
    projection: the maps address exactly those views' elements."""
    pk = torch.zeros((b, s, 3 * h * d), dtype=torch.bfloat16)
    for x in A.packed_heads(pk, h):
        for tile in A.tile_rows(d, s):
            geo = A.head_geometry(x, tile)
            _check_box(geo, d, tile)
            assert torch.equal(_read_by_map(x, geo), _storage_index(x))


def test_contiguous_per_head_and_broadcast_axes():
    """A contiguous (B, H, S, D) tensor has its head stride above its row
    stride: the map orders its axes by stride and says where each went. An
    axis of extent 1 may carry any stride (here a sliced batch)."""
    x = torch.zeros((3, 4, 9, 64), dtype=torch.bfloat16)
    geo = A.head_geometry(x, 128)
    assert geo.axes == (2, 1, 3)
    assert torch.equal(_read_by_map(x, geo), _storage_index(x))
    one = torch.zeros((5, 4, 9, 64), dtype=torch.bfloat16)[2:3]
    geo = A.head_geometry(one, 128)
    assert geo.axes[2] == 3 and geo.strides[2] % 16 == 0
    assert torch.equal(_read_by_map(one, geo), _storage_index(one))


def test_head_dim_72_pads_outside_the_extent():
    """d=72: five 16-column panels (80 columns) over an extent of 72, so
    columns 72..79, the next head's lanes in a packed row, are zero-filled;
    the map's column extent never reaches them."""
    qkv = torch.zeros((2, 40, 3 * 8 * 72), dtype=torch.bfloat16)
    geo = A.flat_geometry(qkv, 8 * 72, 8, 40, 72, A.tile_rows(72, 40)[1])
    assert geo.dims[0] == 72 and geo.box[0] == 16 and geo.pad == 8
    assert A.padded_dim(72) // geo.box[0] * geo.box[0] == geo.dims[0] + geo.pad
    idx = _read_by_map(qkv, geo)
    assert idx.shape[-1] == 72
    assert torch.equal(idx, _flat_heads(qkv, 8 * 72, 8, 40, 72))
    assert geo.strides[geo.axes[0] - 1] == 72 * 2     # heads 144 bytes apart


def test_alignment_refusals():
    """What the TMA refuses, the wrappers refuse before any launch."""
    qkv = torch.zeros((2, 16, 3 * 4 * 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):     # column offset 4
        A.flat_geometry(qkv, 4, 4, 16, 64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):     # base off 8 bytes
        A.flat_geometry(qkv[..., 4:], 0, 4, 16, 64, 128)
    odd = torch.zeros((2, 16, 4 * 64 + 4), dtype=torch.bfloat16)  # row stride 520 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.flat_geometry(odd, 0, 4, 16, 64, 128)
    one = torch.zeros((1, 1, 4 * 64 + 4), dtype=torch.bfloat16)   # extent-1 axes
    assert A.flat_geometry(one, 0, 4, 1, 64, 128).strides[2] % 16 == 0
    with pytest.raises(NotImplementedError):
        A.flat_geometry(qkv, 0, 4, 16, 48, 128)
    # the launchers run these checks first (no kernel is built for a refusal)
    q = torch.zeros((2, 16, 4 * 64 + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.flash_flat_launch(q, q, q, 0, 0, 0, 4, 4, 64, 16, 16, None, None,
                            False, 1.0)
    v = torch.zeros((2, 4, 16, 64), dtype=torch.bfloat16)
    shifted = v.as_strided((2, 4, 15, 64), v.stride(), 4)       # 8 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.flash_attention_launch(shifted, v[:, :, :15], v[:, :, :15], None, None,
                                 False, 1.0, None, None, None, None, None)


def test_head_dim_88_pads_to_96_outside_the_extent():
    """d=88 (BLIP-2's EVA ViT-g, 16 heads over width 1408): six 16-column
    panels (96 columns, 32-byte swizzle) over an extent of 88, so columns
    88..95, the next head's lanes in the packed (B, S, 3*1408) row, are
    zero-filled; every head's offset in the packed row is 16-byte aligned
    (176 bytes a head), so each q, k and v map's base is too."""
    assert A.padded_dim(88) == 96 and A.panel_width(88) == 16
    assert 88 in A.HEAD_DIMS["flash_attention_flat"]
    assert 88 not in A.HEAD_DIMS["flash_attention"]       # the per-head kernel lacks it
    qkv = torch.zeros((2, 257, 3 * 1408), dtype=torch.bfloat16)
    bq, bk = A.tile_rows(88, 257)
    assert (bq, bk) == (128, 128)
    for off, tile in ((0, bq), (1408, bk), (2816, bk)):
        geo = A.flat_geometry(qkv, off, 16, 257, 88, tile)
        _check_box(geo, 88, tile)
        assert geo.dims[0] == 88 and geo.box[0] == 16 and geo.pad == 8 and geo.swizzle == 32
        assert geo.dims[0] + geo.pad == 6 * geo.box[0]
        assert geo.strides[geo.axes[0] - 1] == 88 * 2       # heads 176 bytes apart
        assert geo.dims[geo.axes[1]] == 257                  # the last key tile is ragged
        assert torch.equal(_read_by_map(qkv, geo), _flat_heads(qkv, off, 16, 257, 88))
        for h in range(16):
            assert (geo.packed(qkv)[0] + 2 * 88 * h) % 16 == 0
    with pytest.raises(NotImplementedError):
        A.head_geometry(qkv.view(2, 257, 3, 16, 88)[:, :, 0].transpose(1, 2), 128)


def test_qformer_cross_attention_geometry():
    """The Q-Former's cross-attention: 32 query rows (the one-warpgroup
    variant: 64-row q tiles, 64-key tiles) over the 257 image rows of a
    packed k|v projection (B, 257, 2*768), k and v read as column views of
    it at offsets 0 and 768."""
    q = torch.zeros((4, 32, 768), dtype=torch.bfloat16)
    kv = torch.zeros((4, 257, 2 * 768), dtype=torch.bfloat16)
    bq, bk = A.tile_rows(64, 32)
    assert (bq, bk) == (64, 64)
    gq = A.flat_geometry(q, 0, 12, 32, 64, bq)
    assert torch.equal(_read_by_map(q, gq), _flat_heads(q, 0, 12, 32, 64))
    for name, view in (("k", kv[..., :768]), ("v", kv[..., 768:])):
        geo = A.flat_geometry(view, 0, 12, 257, 64, bk, name)
        _check_box(geo, 64, bk)
        assert geo.dims[geo.axes[1]] == 257 and -(-257 // bk) == 5
        assert torch.equal(_read_by_map(view, geo), _flat_heads(view, 0, 12, 257, 64))
        assert geo.packed(view)[0] == kv.data_ptr() + (0 if name == "k" else 2 * 768)
