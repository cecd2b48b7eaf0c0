"""Hopper kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (there is no
interpret mode for a CUDA or Triton kernel). This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances as in chip_smoke.py: norms within 1 bf16 ulp (rtol 8e-3; 1.6e-2
for T5's twice-rounded RMSNorm) plus atol 1e-5 near zero; attention per
element within 5% of the reference's rms plus rtol 2^-7 (one bf16 rounding
flip; P is rounded to bf16 against per-tile running maxima), and the error's
rms within 1% of the reference's, so the limit scales with the outputs
compared (~0.03 rms at SigLIP's 4096 keys, O(1) at scale 1.0); the rotary
embedding within 1 bf16 ulp (rtol 8e-3; the kernel may fuse a multiply-add
that the plain version rounds twice in fp32) plus atol 1e-5 near zero; the
grouped GEMM within 1 bf16 ulp (rtol 2^-7: both sum in fp32 and round once,
in other orders) plus atol 1e-4 for sums that cancel to near zero; the
int8 GEMM and the row quant bitwise (an exact int32 sum and the same f32
operations, correctly rounded, in both).
"""

import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu_torch.ops import attention as A  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts, norms as N  # noqa: E402
from t2v_metrics_tpu_torch.ops import moe as M  # noqa: E402
from t2v_metrics_tpu_torch.ops import quant as TQ  # noqa: E402
from t2v_metrics_tpu_torch.ops import rope as R  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) with nvcc and triton")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, dtype=torch.bfloat16, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def _close(out, ref, atol, rtol):
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _close_qk_rope(out, ref, normed, pk, rot, d):
    """The qk-norm + rope within chip_smoke.py's tolerance (QK_ROPE_PAIR_RTOL
    there): each element within 1e-5 + 8e-3 |ref| + 2.5e-2 times the length
    of its normalized pair (``normed``: the plain qk-norm); the v lanes
    bitwise the input's."""
    o = out[..., :rot * d].float().reshape(-1, rot, 2, d // 2)
    r = ref[..., :rot * d].float().reshape(-1, rot, 2, d // 2)
    n = normed[..., :rot * d].float().reshape(-1, rot, 2, d // 2)
    pair = torch.hypot(n[:, :, :1], n[:, :, 1:])
    assert bool(((o - r).abs() <= 1e-5 + 8e-3 * r.abs() + 2.5e-2 * pair).all())
    assert torch.equal(out[..., rot * d:], pk[..., rot * d:])


def _close_attn(out, ref):
    """Attention within chip_smoke.py's tolerance (ATTN_* there)."""
    out, ref = out.float(), ref.float()
    rms = float(ref.square().mean().sqrt())
    torch.testing.assert_close(out, ref, atol=0.05 * rms, rtol=2 ** -7)
    assert float((out - ref).square().mean().sqrt()) <= 1e-2 * rms


@pytest.mark.parametrize("shape", [(7, 1024), (3, 5, 1000), (16, 64), (5, 4608),
                                   (3, 257, 1408), (9, 512), (9, 768)])
def test_layer_norm_kernel(dev, shape):
    x = _randn(dev, *shape, std=3.0)
    w, b = _randn(dev, shape[-1], seed=1), _randn(dev, shape[-1], seed=2)
    before = launch_counts()["layer_norm"]
    _close(N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b), 1e-5, 8e-3)
    _close(N.layer_norm_fused(x, w, None), N.layer_norm_plain(x, w, None), 1e-5, 8e-3)
    assert launch_counts()["layer_norm"] == before + 2


@pytest.mark.parametrize("shape", [(7, 1024), (3, 5, 1000), (16, 64), (5, 4608),
                                   (2560, 1024), (16384, 1152), (16 * 257, 1408),
                                   (16 * 41, 768)])
def test_add_layer_norm_kernel(dev, shape):
    """The residual add folded in: s bitwise the eager x + r, y the plain
    LayerNorm of it; one launch a call."""
    x, r = _randn(dev, *shape, std=3.0), _randn(dev, *shape, seed=3, std=3.0)
    w, b = _randn(dev, shape[-1], seed=1), _randn(dev, shape[-1], seed=2)
    for bias in (b, None):
        before = launch_counts()["layer_norm"]
        s, y = N.add_layer_norm_fused(x, r, w, bias)
        assert launch_counts()["layer_norm"] == before + 1
        assert s.shape == y.shape == x.shape and torch.equal(s, x + r)
        _close(y, N.layer_norm_plain(x + r, w, bias), 1e-5, 8e-3)


@pytest.mark.parametrize("d", [1024, 1152, 4608])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=str)
def test_layer_norm_kernel_dtypes(dev, d, dtype):
    x, r = _randn(dev, 33, d, std=3.0, dtype=dtype), _randn(dev, 33, d, seed=3, dtype=dtype)
    w, b = _randn(dev, d, seed=1, dtype=dtype), _randn(dev, d, seed=2, dtype=dtype)
    rtol = 8e-3 if dtype == torch.float16 else 2e-5
    _close(N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b), 1e-5, rtol)
    s, y = N.add_layer_norm_fused(x, r, w, b)
    assert torch.equal(s, x + r)
    _close(y, N.layer_norm_plain(x + r, w, b), 1e-5, rtol)


@pytest.mark.parametrize("d,off", [(1024, 8), (1024, 2), (1152, 4), (1001, 1), (4608, 6)])
def test_layer_norm_kernel_row_stride(dev, d, off):
    """Rows of a wider tensor: a row stride that is not d, the first column
    ``off`` elements in (16-, 8-, 4- or 2-byte aligned vectors)."""
    x = _randn(dev, 9, d + 24, std=3.0)[:, off:off + d]
    r = _randn(dev, 9, d + 40, seed=3, std=3.0)[:, :d]
    w, b = _randn(dev, d, seed=1), _randn(dev, d, seed=2)
    assert x.stride(0) != d and r.stride(0) != d
    _close(N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b), 1e-5, 8e-3)
    s, y = N.add_layer_norm_fused(x, r, w, b)
    assert torch.equal(s, x + r)
    _close(y, N.layer_norm_plain(x + r, w, b), 1e-5, 8e-3)


def test_layer_norm_refuses_what_it_lacks(dev):
    x, w = _randn(dev, 4, 1024), _randn(dev, 1024)
    with pytest.raises(ValueError):
        N.add_layer_norm_fused(x, _randn(dev, 4, 512), w, None)        # r's shape
    with pytest.raises(TypeError):
        N.layer_norm_fused(x, w.float(), None)                          # weight dtype
    with pytest.raises(ValueError):
        N.layer_norm_fused(_randn(dev, 2, 16385), _randn(dev, 16385), None)


@pytest.mark.parametrize("cast_wd,offset", [(True, 0.0), (False, 0.0), (True, 1.0)])
def test_rms_norm_kernel(dev, cast_wd, offset):
    x = _randn(dev, 9, 2048, std=3.0)
    w = _randn(dev, 2048, seed=1)
    _close(N.rms_norm_fused(x, w, 1e-6, offset, cast_wd),
           N.rms_norm_plain(x, w, 1e-6, offset, cast_wd), 1e-5, 1.6e-2)


def test_rms_norm_kernel_fp32(dev):
    x = _randn(dev, 5, 512, dtype=torch.float32)
    w = _randn(dev, 512, seed=1, dtype=torch.float32)
    _close(N.rms_norm_fused(x, w), N.rms_norm_plain(x, w), 1e-5, 1e-5)


@pytest.mark.parametrize("cast_wd,offset", [(True, 0.0), (False, 0.0), (False, 1.0),
                                            (True, 1.0)])
@pytest.mark.parametrize("shape", [(7, 1024), (3, 5, 1000), (4, 3584), (33, 2048), (9, 4096),
                                   (17, 3200), (5, 5376), (3, 3840), (2, 1001), (6, 16384)])
def test_add_rms_norm_kernel(dev, shape, cast_wd, offset):
    """RMSNorm alone and with the residual add folded in (s bitwise the
    eager x + r, y the plain RMSNorm of it); one launch a call, counted
    under rms_norm."""
    x, r = _randn(dev, *shape, std=3.0), _randn(dev, *shape, seed=3, std=3.0)
    w = _randn(dev, shape[-1], seed=1)
    kw = dict(eps=1e-6, offset=offset, cast_weight_dtype=cast_wd)
    before = launch_counts()["rms_norm"]
    _close(N.rms_norm_fused(x, w, **kw), N.rms_norm_plain(x, w, **kw), 1e-5, 1.6e-2)
    s, y = N.add_rms_norm_fused(x, r, w, **kw)
    assert launch_counts()["rms_norm"] == before + 2
    assert s.shape == y.shape == x.shape and torch.equal(s, x + r)
    _close(y, N.rms_norm_plain(x + r, w, **kw), 1e-5, 1.6e-2)


@pytest.mark.parametrize("d", [1024, 3584, 4096])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=str)
def test_rms_norm_kernel_dtypes(dev, d, dtype):
    x, r = _randn(dev, 33, d, std=3.0, dtype=dtype), _randn(dev, 33, d, seed=3, dtype=dtype)
    w = _randn(dev, d, seed=1, dtype=dtype)
    rtol = 1.6e-2 if dtype == torch.float16 else 2e-5
    _close(N.rms_norm_fused(x, w), N.rms_norm_plain(x, w), 1e-5, rtol)
    s, y = N.add_rms_norm_fused(x, r, w)
    assert torch.equal(s, x + r)
    _close(y, N.rms_norm_plain(x + r, w), 1e-5, rtol)


@pytest.mark.parametrize("d,off", [(2048, 8), (2048, 2), (3584, 4), (1001, 1)])
def test_rms_norm_kernel_row_stride(dev, d, off):
    """Rows of a wider tensor: a row stride that is not d, the first column
    ``off`` elements in (16-, 8-, 4- or 2-byte aligned vectors)."""
    x = _randn(dev, 9, d + 24, std=3.0)[:, off:off + d]
    r = _randn(dev, 9, d + 40, seed=3, std=3.0)[:, :d]
    w = _randn(dev, d, seed=1)
    _close(N.rms_norm_fused(x, w), N.rms_norm_plain(x, w), 1e-5, 1.6e-2)
    s, y = N.add_rms_norm_fused(x, r, w)
    assert torch.equal(s, x + r)
    _close(y, N.rms_norm_plain(x + r, w), 1e-5, 1.6e-2)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("d", [3584, 4096])
def test_rms_norm_kernel_any_grid(dev, d, add):
    """Many rows a block: the row loop takes the shared buffers of the warps'
    partial sums by turns from row to row, so the rows come out bitwise the
    same on the plan's grid, on one block an SM and on one block."""
    from t2v_metrics_tpu_torch.ops.gemm import sm_count

    x, w = _randn(dev, 20480, d, std=3.0), _randn(dev, d, seed=1)
    r = _randn(dev, 20480, d, seed=3, std=3.0) if add else None
    runs = [N._norm_launch("rms_norm", x, r, w, None, 1e-6, (0.0, True), grid=g)
            for g in (None, sm_count(x.device), 1)]
    for s, y in runs[1:]:
        assert torch.equal(y, runs[0][1])
        assert (s is None) if r is None else torch.equal(s, runs[0][0])


def test_rms_norm_refuses_what_it_lacks(dev):
    x, w = _randn(dev, 4, 2048), _randn(dev, 2048)
    with pytest.raises(ValueError):
        N.add_rms_norm_fused(x, _randn(dev, 4, 1024), w)               # r's shape
    with pytest.raises(TypeError):
        N.rms_norm_fused(x, w.float())                                  # weight dtype
    with pytest.raises(ValueError):
        N.rms_norm_fused(_randn(dev, 2, 16385), _randn(dev, 16385))


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal,bias,mask", [
    (2, 70, 70, 4, 4, False, True, True),     # ragged q and k tiles
    (3, 4, 4, 4, 4, True, True, False),       # T5 decoder self
    (2, 4, 130, 4, 4, False, False, True),    # T5 cross
    (2, 9, 200, 8, 2, True, False, True),     # GQA, end-aligned causal
    (3, 100, 300, 4, 4, False, True, True),   # 64 < sq < 128: second warpgroup partly used
    (2, 40, 333, 4, 2, True, True, False),    # sq < 64: one warpgroup, ragged keys
])
def test_attention_kernel(dev, b, sq, sk, h, kvh, causal, bias, mask):
    q = _randn(dev, b, sq, h * 64)
    k = _randn(dev, b, sk, kvh * 64, seed=1)
    v = _randn(dev, b, sk, kvh * 64, seed=2)
    kw = dict(kv_heads=kvh, causal=causal, scale=1.0)
    if bias:
        kw["bias"] = _randn(dev, 1, h, sq, sk, seed=3, dtype=torch.float32)
    if mask:
        m = torch.rand((b, sk), generator=torch.Generator(device=dev).manual_seed(4),
                       device=dev) > 0.3
        m[:, -1] = True
        kw["kv_mask"] = m
    before = launch_counts()["flash_attention_flat"]
    out = A.flash_attention_flat(q, k, v, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


def test_attention_kernel_packed_and_masked_rows(dev):
    qkv = _randn(dev, 2, 100, 3 * 4 * 64)
    m = torch.ones((2, 100), dtype=torch.bool, device=dev)
    m[1] = False
    out = A.flash_attention_flat_packed(qkv, 4, kv_mask=m)
    q, k, v, _ = A._split_packed(qkv, 4, None)
    _close_attn(out, A.attention_flat_reference(q, k, v, 4, kv_mask=m))
    assert torch.count_nonzero(out[1]) == 0


@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 100, 16, 16, 80),     # Qwen ViT: MHA, d=80, ragged rows
    (2, 64, 28, 4, 128),      # Qwen decoder prefill: GQA 28/4, d=128
    (1, 40, 4, 4, 64),
])
def test_rope_kernel(dev, b, s, h, kvh, d):
    lanes = (h + 2 * kvh) * d
    pk = _randn(dev, b, s, lanes)
    pos = torch.randint(0, 5000, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    ang = pos[..., None].float() * _randn(dev, d, seed=2, dtype=torch.float32).abs()
    cos, sin = torch.cos(ang), torch.sin(ang)
    ref = R.rope_pack_plain(pk, cos, sin, h + kvh, d)
    before = launch_counts()["rope_pack"]
    out = R.rope_pack(pk.clone(), cos, sin, h + kvh, d)
    assert launch_counts()["rope_pack"] == before + 1
    _close(out, ref, 1e-5, 8e-3)
    assert torch.equal(out[..., (h + kvh) * d:], pk[..., (h + kvh) * d:])


@pytest.mark.parametrize("b,s,h,kvh,d,causal,windows", [
    (3, 200, 4, 4, 80, False, True),     # ViT windows (segment ids), d=80
    (24, 128, 16, 16, 80, False, True),  # ViT window tiles
    (2, 150, 8, 2, 128, True, False),    # decoder prefill: GQA, causal, d=128
    (2, 130, 4, 4, 64, True, True),      # segment ids with causal, d=64
])
def test_attention_kernel_segments_and_head_dims(dev, b, s, h, kvh, d, causal,
                                                 windows):
    qkv = _randn(dev, b, s, (h + 2 * kvh) * d)
    gen = torch.Generator(device=dev).manual_seed(5)
    kw = dict(kv_heads=kvh, causal=causal)
    if windows:  # windows of 1..64 rows in order, the tail padded with -1
        sizes = torch.randint(1, 65, (s,), generator=gen, device=dev)
        seg = torch.repeat_interleave(torch.arange(s, device=dev), sizes)[:s]
        seg = seg.expand(b, s).clone()
        seg[:, s - 9:] = -1
        kw["segment_ids"] = seg.int()
    else:
        lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
        kw["kv_mask"] = torch.arange(s, device=dev)[None] < lens[:, None]
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, kvh)
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


def test_attention_kernel_refuses_what_it_lacks(dev):
    q = _randn(dev, 1, 8, 4 * 32)
    with pytest.raises(NotImplementedError):
        A.flash_attention_flat(q, q, q, 4)                      # head dim 32
    with pytest.raises(NotImplementedError):
        A.attention(*(q.view(1, 8, 4, 32).transpose(1, 2),) * 3)
    q88 = _randn(dev, 1, 8, 4 * 88)
    with pytest.raises(NotImplementedError):                    # d=88: flat kernel only
        A.attention(*(q88.view(1, 8, 4, 88).transpose(1, 2),) * 3)
    q = _randn(dev, 1, 8, 4 * 64)
    with pytest.raises(ValueError):                             # not square
        A.attention_flat(q[:, :4], q, q, 4, causal=True,
                         bidir_ids=torch.zeros((1, 8), device=dev))
    with pytest.raises(ValueError):                             # not square
        A.attention_flat(q[:, :4], q, q, 4,
                         segment_ids=torch.zeros((1, 8), device=dev))
    with pytest.raises(TypeError):
        A.flash_attention_flat(q.float(), q.float(), q.float(), 4)
    with pytest.raises(ValueError):                             # bias and rel_bias
        h = q.view(1, 8, 4, 64).transpose(1, 2)
        A.attention(h, h, h, bias=torch.zeros((1, 4, 8, 8), device=dev),
                    rel_bias=torch.zeros((4, 32), device=dev),
                    rel_cfg=(True, 32, 128, 0))


def _bidir(dev, b, s, blocks):
    """(B, S) int32 group ids: -1 on text, on block i = (start, len[, id])
    its id, else i."""
    ids = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for i, (start, n, *bid) in enumerate(blocks):
        ids[:, start:start + n] = bid[0] if bid else i
    return ids


@pytest.mark.parametrize("b,s,h,kvh,d,window,blocks,mask", [
    (2, 150, 4, 2, 256, None, ((20, 70),), True),    # Gemma decoder: d=256, bidir
    (2, 300, 4, 2, 256, 64, ((30, 90),), True),      # window bites, the overlay reopens
    (1, 330, 4, 4, 64, 40, ((5, 20), (200, 70)), False),  # two blocks, window 40
    (2, 200, 8, 2, 128, 50, (), True),               # window alone
    (2, 130, 4, 4, 80, None, ((64, 64),), False),    # a block on tile edges
    (2, 200, 8, 4, 256, 100, ((30, 50),), True),     # GQA 8/4 at d=256
    # one id on rows 0..19 and 800..809: a block's tile list is the band's
    # tiles and tile 0, with a gap between them
    (1, 900, 4, 4, 64, 64, ((0, 20, 0), (800, 10, 0)), False),
    (1, 700, 4, 2, 256, 32, ((0, 30, 0), (600, 20, 0)), True),  # the same at d=256
])
def test_attention_kernel_window_and_bidir(dev, b, s, h, kvh, d, window, blocks,
                                           mask):
    """The causal/window band OR the bidir overlay; key tiles outside the
    band but reopened by an image block are visited."""
    qkv = _randn(dev, b, s, (h + 2 * kvh) * d, seed=11)
    kw = dict(kv_heads=kvh, causal=True, local_window=window)
    if blocks:
        kw["bidir_ids"] = _bidir(dev, b, s, blocks)
    if mask:
        kw["kv_mask"] = torch.arange(s, device=dev)[None] < torch.tensor(
            [[s - 7 * i] for i in range(b)], device=dev)
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, kvh)
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


@pytest.mark.parametrize("b,h,sq,sk,d,kw", [
    (2, 4, 300, 300, 72, {}),                                 # SigLIP: no masks
    (2, 3, 200, 200, 64, dict(kv_mask=True, bias="batch")),   # per-batch bias
    (3, 4, 9, 130, 64, dict(causal=True, kv_mask=True)),      # end-aligned, sq < sk
    (2, 4, 140, 140, 80, dict(segment_ids=True)),
    (2, 4, 200, 200, 128, dict(local_window=37, bidir=((50, 60),))),
    (2, 4, 150, 150, 256, dict(causal=True, bias="head")),
    (2, 5, 140, 140, 64, dict(rel=True, kv_mask=True)),       # T5 encoder
    (3, 5, 4, 4, 64, dict(rel=False, causal=True)),           # T5 decoder
    (2, 4, 300, 300, 64, dict(rel=True)),                     # REL alone, 3 q tiles
    (3, 4, 100, 100, 64, dict(bias="head", kv_mask="none")),  # batch stride 0, zero rows
    (2, 4, 93, 200, 80, dict(kv_mask=True)),                  # d=80, ragged, sq < sk
    (2, 4, 60, 333, 72, dict(causal=True)),                   # d=72, sq < 64, ragged
    # the T5 bias beside the other terms at d=256: the one-warpgroup variant
    (2, 4, 150, 150, 256, dict(rel=False, local_window=40, bidir=((20, 50),))),
    (2, 3, 100, 100, 256, dict(rel=True, segment_ids=True, kv_mask=True)),
])
def test_per_head_attention_kernel(dev, b, h, sq, sk, d, kw):
    gen = torch.Generator(device=dev).manual_seed(12)
    # strided views of a packed (B, S, 3*H*D) projection, as the SigLIP tower
    # passes them (sq == sk), else separate tensors
    if sq == sk:
        pk = _randn(dev, b, sq, 3 * h * d, seed=13)
        q, k, v = pk.view(b, sq, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q = _randn(dev, b, h, sq, d, seed=13)
        k, v = _randn(dev, b, h, sk, d, seed=14), _randn(dev, b, h, sk, d, seed=15)
    args = {}
    if kw.get("kv_mask") == "none":     # batch item 1 has no key: zero rows
        args["kv_mask"] = torch.ones((b, sk), dtype=torch.bool, device=dev)
        args["kv_mask"][1] = False
    elif kw.get("kv_mask"):
        args["kv_mask"] = torch.rand((b, sk), generator=gen, device=dev) > 0.2
        args["kv_mask"][:, -1] = True
    if kw.get("bias") == "batch":
        args["bias"] = _randn(dev, b, 1, sq, sk, seed=16, dtype=torch.float32)
    elif kw.get("bias") == "head":
        args["bias"] = _randn(dev, 1, h, sq, sk, seed=16, dtype=torch.float32)
    if kw.get("segment_ids"):
        args["segment_ids"] = (torch.arange(sq, device=dev) // 33).expand(b, sq).int()
    if "local_window" in kw:
        args["local_window"] = kw["local_window"]
        args["bidir_ids"] = _bidir(dev, b, sq, kw["bidir"])
    if "rel" in kw:
        args["rel_bias"] = _randn(dev, h, 32, seed=17, dtype=torch.float32)
        args["rel_cfg"] = (kw["rel"], 32, 128, 0)
        args["scale"] = 1.0
    args["causal"] = kw.get("causal", False)
    before = launch_counts()["flash_attention"]
    out = A.attention(q, k, v, **args)
    assert launch_counts()["flash_attention"] == before + 1
    assert out.shape == (b, h, sq, d)
    _close_attn(out, A.attention_reference(q, k, v, **args))
    if kw.get("kv_mask") == "none":
        assert torch.count_nonzero(out[1]) == 0


@pytest.mark.parametrize("b,s,h,kvh,d,causal,seg", [
    (4, 300, 16, 16, 72, False, True),   # Qwen3 ViT: real rows, then -1 pads
    (2, 130, 16, 16, 72, False, False),  # d=72 without segment ids
    (2, 70, 8, 2, 72, True, False),      # d=72, GQA, causal, ragged tiles
    (2, 93, 8, 8, 80, True, False),      # d=80, causal, Sk % 64 != 0
    (3, 333, 4, 4, 80, False, True),     # d=80, three key tiles, the last ragged
])
def test_attention_kernel_head_dim_72(dev, b, s, h, kvh, d, causal, seg):
    """72 is not a multiple of the 16-wide k-step: the kernel zero-fills Q/K
    columns 72..79 (in the packed row they are the next head's lanes) and
    stores 72 output columns."""
    qkv = _randn(dev, b, s, (h + 2 * kvh) * d, seed=6)
    kw = dict(kv_heads=kvh, causal=causal)
    if seg:
        ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for i in range(b):
            ids[i, s - 17 * (i + 1):] = -1
        kw["segment_ids"] = ids
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, kvh)
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


def _by_heads(q, k, v, heads, groups, **kw):
    """``attention_flat_reference`` over ``groups`` groups of heads in turn
    (bounds the plain version's (B, H, S, S) fp32 scores at 4,096 rows)."""
    n, d = heads // groups, q.shape[-1] // heads
    return torch.cat([A.attention_flat_reference(
        *(x[..., g * n * d:(g + 1) * n * d] for x in (q, k, v)), n, **kw)
        for g in range(groups)], dim=-1)


def test_attention_kernel_qwen3_vit_cell_layout(dev):
    """The Qwen3-VL-30B-A3B ViT's call at 992x992, B = 2: 3,844 patches of
    segment 0 and 252 pad rows of -1 in a 4,096-row bucket, 16 heads of 72.
    Key tile 31 (all pads) is skipped by q tiles 0-29 and tiles 0-29 by q
    tile 31; the real rows also equal an unpadded 3,844-row call with no
    ids, which never sees the pad keys."""
    b, s, real, h, d = 2, 4096, 3844, 16, 72
    qkv = _randn(dev, b, s, 3 * h * d, seed=21)
    seg = torch.where(torch.arange(s, device=dev) < real, 0, -1).int().expand(b, s)
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, segment_ids=seg)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, None)
    _close_attn(out, _by_heads(q, k, v, h, 4, segment_ids=seg))
    alone = A.attention_flat_packed(qkv[:, :real], h)
    _close_attn(out[:, :real], alone)
    _close_attn(out[:, :real], _by_heads(q[:, :real], k[:, :real], v[:, :real], h, 4))


def _runs(dev, s, seed, ids):
    """(1, S) int32 ids: runs of 1..96 rows, each run's id drawn from ``ids``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = torch.randint(1, 97, (s,), generator=g, device=dev)
    pick = torch.randint(0, len(ids), (s,), generator=g, device=dev)
    vals = torch.tensor(ids, device=dev)[pick]
    return torch.repeat_interleave(vals, sizes)[:s].int()[None]


@pytest.mark.parametrize("b,s,h,d,ids", [
    (2, 1280, 16, 80, "windows"),       # Qwen2.5 windows of 64: all but one tile skipped
    (2, 512, 8, 72, "apart"),           # ranges meet, no id in common
    (2, 700, 8, 80, "unsorted"),        # runs of ids -1..3 in any order, ragged
    (3, 333, 4, 64, "pads"),            # one segment, a ragged tail of -1
])
def test_attention_kernel_segment_tile_skipping(dev, b, s, h, d, ids):
    """Segment ids that skip key tiles, settle tiles as a whole, or meet the
    conservative rule: rows {0, 2} against keys {1} are visited and compared
    (their ranges meet), never skipped or kept whole."""
    qkv = _randn(dev, b, s, 3 * h * d, seed=22)
    r = torch.arange(s, device=dev)
    if ids == "windows":
        seg = (r // 64).int().expand(b, s)
    elif ids == "apart":     # rows 0..255: runs of 32 of 0 and 2; then 1
        seg = torch.where(r < 256, ((r // 32) % 2) * 2, 1).int().expand(b, s)
    elif ids == "unsorted":
        seg = torch.cat([_runs(dev, s, 30 + i, [-1, 0, 1, 2, 3]) for i in range(b)])
    else:
        seg = torch.where(r < s - 45, 0, -1).int().expand(b, s)
    out = A.attention_flat_packed(qkv, h, segment_ids=seg)
    q, k, v, _ = A._split_packed(qkv, h, None)
    _close_attn(out, A.attention_flat_reference(q, k, v, h, segment_ids=seg))


def test_per_head_one_warpgroup_segment_tile_skipping(dev):
    """The one-warpgroup variant (the per-head kernel's T5 bias beside
    segment ids at d = 256) skips through ``fill_next``: 200 rows, ids
    ``arange // 50``, REL and a key mask."""
    b, h, s, d = 2, 3, 200, 256
    pk = _randn(dev, b, s, 3 * h * d, seed=23)
    q, k, v = pk.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    gen = torch.Generator(device=dev).manual_seed(24)
    mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
    args = dict(segment_ids=(torch.arange(s, device=dev) // 50).expand(b, s).int(),
                kv_mask=mask, rel_bias=_randn(dev, h, 32, seed=25, dtype=torch.float32),
                rel_cfg=(True, 32, 128, 0), scale=1.0)
    before = launch_counts()["flash_attention"]
    out = A.attention(q, k, v, **args)
    assert launch_counts()["flash_attention"] == before + 1
    _close_attn(out, A.attention_reference(q, k, v, **args))


@pytest.mark.parametrize("h,kvh,d,offset,cast_wd", [
    (32, 4, 128, 0.0, True), (16, 16, 72, 0.0, True), (4, 2, 64, 0.0, False),
    (8, 4, 256, 1.0, False), (32, 8, 128, 0.0, True), (16, 2, 64, 0.0, True)])
@pytest.mark.parametrize("b,s", [(3, 37), (4, 1), (16, 64)])
def test_rms_norm_heads_kernel(dev, h, kvh, d, offset, cast_wd, b, s):
    """The qk-norm over the q|k heads of a packed row, folded into the
    rotation: one launch, counted under rope_pack, in place; v untouched.
    The qk-norm alone has no kernel on the card and says where it runs."""
    pk = _randn(dev, b, s, (h + 2 * kvh) * d, std=3.0)
    qs, ks = _randn(dev, d, seed=1), _randn(dev, d, seed=2)
    pos = torch.randint(0, 5000, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    ang = pos[..., None].float() * _randn(dev, d, seed=3, dtype=torch.float32).abs()
    cos, sin = torch.cos(ang), torch.sin(ang)
    args = (qs, ks, cos, sin, h, kvh, d, 1e-6, offset, cast_wd)
    ref = R.rms_norm_rope_pack_plain(pk, *args)
    buf = pk.clone()
    before = launch_counts()
    out = R.rms_norm_rope_pack(buf, *args)
    after = launch_counts()
    assert after["rope_pack"] == before["rope_pack"] + 1
    assert after["rms_norm"] == before["rms_norm"]
    assert out.data_ptr() == buf.data_ptr()          # written in place
    _close_qk_rope(out, ref, N.rms_norm_heads_plain(pk, qs, ks, h, kvh, d, 1e-6, offset, cast_wd),
                   pk, h + kvh, d)
    with pytest.raises(ValueError, match="rms_norm_rope_pack"):
        N.rms_norm_heads_fused(pk, qs, ks, h, kvh, d)


@pytest.mark.parametrize("e,k,n,routing", [
    (3, 64, 128, "random"),     # an odd expert count
    (7, 96, 256, "random"),
    (5, 64, 128, "skewed"),     # two experts take every row, three are empty
    (1, 32, 128, "random"),     # one expert
])
def test_grouped_gemm_kernel(dev, e, k, n, routing):
    gen = torch.Generator(device=dev).manual_seed(7)
    tk = 700
    if routing == "skewed":
        ids = torch.tensor([1, 3], device=dev).repeat(tk // 2)
    else:
        ids = torch.randint(0, e, (tk,), generator=gen, device=dev)
    _, _, be, p = M.plan_groups(ids, e, M.BLOCK_M)
    xg = _randn(dev, p, k, seed=8)
    w = _randn(dev, e, k, n, seed=9, std=k ** -0.5)
    before = launch_counts()["grouped_gemm"]
    out = M.grouped_matmul(xg, w, be)
    assert launch_counts()["grouped_gemm"] == before + 1
    _close(out, M.grouped_matmul_reference(xg, w, be.cpu()), 1e-4, 2 ** -7)


@pytest.mark.parametrize("e,k,n,routing", [
    (3, 64, 128, "random"),
    (4, 768, 256, "random"),    # the down projection's K
    (5, 768, 384, "skewed"),    # two experts take every row; N past one 256 tile
    (8, 2048, 512, "top-k"),    # gate_up's K, 4 of 8 experts a token
])
def test_grouped_gemm_kernel_num_blocks(dev, e, k, n, routing):
    """With num_blocks the kernel computes the blocks of the plan's experts
    and writes zeros past them, as the plain version does."""
    gen = torch.Generator(device=dev).manual_seed(11)
    tk = 1200
    if routing == "skewed":
        ids = torch.tensor([1, 3], device=dev).repeat(tk // 2)
    elif routing == "top-k":
        ids = torch.rand((tk // 4, e), generator=gen, device=dev).topk(4).indices.reshape(-1)
    else:
        ids = torch.randint(0, e, (tk,), generator=gen, device=dev)
    _, _, be, p, used, _ = M._plan(ids, e, M.BLOCK_M)
    xg = _randn(dev, p, k, seed=12)
    w = _randn(dev, e, k, n, seed=13, std=k ** -0.5)
    out = M.grouped_matmul(xg, w, be, M.BLOCK_M, used)
    ref = M.grouped_matmul_reference(xg, w, be.cpu(), M.BLOCK_M, used.cpu())
    rows = int(used) * M.BLOCK_M
    assert rows < p and torch.equal(out[rows:], torch.zeros_like(out[rows:]))
    _close(out, ref, 1e-4, 2 ** -7)
    _close(out[:rows], M.grouped_matmul(xg, w, be)[:rows], 1e-4, 2 ** -7)


def test_grouped_gemm_refuses_what_it_lacks(dev):
    be = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                             # N % 128
        M.grouped_matmul(_randn(dev, 128, 64), _randn(dev, 2, 64, 96), be)
    with pytest.raises(ValueError):                             # K % 32
        M.grouped_matmul(_randn(dev, 128, 48), _randn(dev, 2, 48, 128), be)
    with pytest.raises(TypeError):
        M.grouped_matmul(_randn(dev, 128, 64, dtype=torch.float32),
                         _randn(dev, 2, 64, 128, dtype=torch.float32), be)


def _int8(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", [
    (1, 32, 8),          # one row, one k step of 32 (half a stage)
    (100, 64, 24),       # ragged rows and columns
    (130, 96, 136),      # a K tail of 32 bytes, N past one tile
    (257, 1024, 264),
    (640, 4096, 512),    # acc past 2^24, which f32 rounds
])
def test_quant_matmul_kernel(dev, m, k, n):
    """Bitwise: an exact int32 sum, then the same two f32 products rounded
    once to bf16."""
    x_q = _int8(dev, m, k, seed=1)
    x_q[0] = 127
    w_qt = _int8(dev, n, k, seed=2)
    w_qt[0] = 127
    xs = torch.rand((m, 1), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev) * 1e-2 + 1e-3
    ws = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev) * 1e-2 + 1e-3
    before = launch_counts()["quant_matmul"]
    out = TQ.quant_matmul(x_q, w_qt.t(), xs, ws)
    assert launch_counts()["quant_matmul"] == before + 1
    ref = TQ.quant_matmul_plain(x_q, w_qt.t(), xs, ws)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


@pytest.mark.parametrize("m,n", [(1, 4096), (100, 4096), (128, 4096), (128, 1000)])
def test_quant_matmul_kernel_split_k(dev, m, n):
    """The T5 decoder's rows at K = 10240: split K, the int32 partials
    summed by the second pass, still bitwise."""
    from t2v_metrics_tpu_torch.ops import gemm as G

    k = 10240
    assert G.split_k(m, n, k, G.sm_count(dev)) > 1
    x_q = _int8(dev, m, k, seed=1)
    x_q[0] = 127
    w_qt = _int8(dev, n, k, seed=2)
    w_qt[0] = 127                # |acc| = 127^2 x 10240, past 2^24
    xs = torch.rand((m, 1), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev) * 1e-2 + 1e-3
    ws = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev) * 1e-2 + 1e-3
    before = launch_counts()["quant_matmul"]
    out = TQ.quant_matmul(x_q, w_qt.t(), xs, ws)
    assert launch_counts()["quant_matmul"] == before + 1
    assert torch.equal(out, TQ.quant_matmul_plain(x_q, w_qt.t(), xs, ws))


@pytest.mark.parametrize("shape", [(7, 96), (3, 5, 1024), (33, 4096), (2, 10240)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_kernel(dev, shape, dtype):
    """Bitwise: int8 values and f32 scales, rounding ties included."""
    x = _randn(dev, *shape, seed=5, std=3.0).to(dtype)
    ties = (torch.arange(shape[-1], device=dev) % 200 - 100).to(dtype) + 0.5
    rows = x.view(-1, shape[-1])
    rows[-1] = ties
    rows[-1, 0] = 127.0          # absmax 127, scale exactly 1: the k + 0.5 are ties
    before = launch_counts()["quantize_rows"]
    x_q, xs = TQ.quantize_rows(x)
    assert launch_counts()["quantize_rows"] == before + 1
    ref_q, ref_s = TQ.quantize_rows_plain(x)
    assert torch.equal(x_q, ref_q) and torch.equal(xs, ref_s)
    assert x_q.shape == x.shape and xs.shape == (*shape[:-1], 1)


def test_int8_leaf_on_the_card(dev):
    """An int8 leaf's product through both kernels equals the plain chain."""
    w = _randn(dev, 256, 200, seed=6, std=0.05)
    b = _randn(dev, 200, seed=7)
    leaf = TQ.Linear(w.clone(), b).quantize_()
    x = _randn(dev, 3, 50, 256, seed=8)
    x_q, xs = TQ.quantize_rows_plain(x)
    ref = TQ.quant_matmul_plain(x_q.reshape(-1, 256), leaf.w_q, xs.reshape(-1, 1),
                                leaf.scale).reshape(3, 50, 200) + b
    assert torch.equal(TQ.linear(x, leaf), ref)


def test_quant_matmul_refuses_what_it_lacks(dev):
    x_q, w_qt = _int8(dev, 64, 48), _int8(dev, 16, 48)
    xs, ws = torch.ones(64, 1, device=dev), torch.ones(16, device=dev)
    with pytest.raises(ValueError):                             # K % 32
        TQ.quant_matmul(x_q, w_qt.t(), xs, ws)
    x_q, w_q = _int8(dev, 64, 64), _int8(dev, 64, 16)
    with pytest.raises(ValueError):                             # w_q.t() not contiguous
        TQ.quant_matmul(x_q, w_q, xs, ws)
    with pytest.raises(ValueError):                             # N % 8
        TQ.quant_matmul(x_q, _int8(dev, 12, 64).t(), xs, torch.ones(12, device=dev))
    with pytest.raises(TypeError):
        TQ.quant_matmul(x_q.float(), w_q, xs, ws)
    with pytest.raises(TypeError):                              # the kernel writes bf16
        TQ.quant_matmul(x_q, _int8(dev, 16, 64).t(), xs, ws, out_dtype=torch.float32)


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpoint_loads_on_the_card_as_on_the_cpu(dev, tmp_path, src_dtype):
    """A staged checkpoint (chip_smoke.py's own key map and writer: the card
    machine has no safetensors) goes to the card leaf by leaf in its own
    dtype and is cast and transposed there: the parameters equal those the
    CPU casts, bitwise, and bf16 stays bf16."""
    import chip_smoke
    from t2v_metrics_tpu_torch import bridge
    from t2v_metrics_tpu_torch.models import checkpoint as ckpt
    from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5
    from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS

    cfg = CLIP_T5_MODELS["clip-flant5-test"]["config"]
    model = tcft5.init_clip_t5(cfg, 0, "cpu", src_dtype)
    chip_smoke.write_checkpoint(chip_smoke.hf_clip_t5_tensors(model, cfg), str(tmp_path), 2)

    def load(device):
        tree = tcft5.convert_clip_t5(ckpt.load_safetensors_dict(str(tmp_path)), cfg)
        return bridge.clip_t5_from_numpy(tree, cfg, device, torch.bfloat16).state_dict()

    on_card, on_cpu = load(dev), load("cpu")
    assert on_card.keys() == on_cpu.keys()
    for k, v in on_cpu.items():
        assert on_card[k].is_cuda and torch.equal(on_card[k].cpu(), v), k


@pytest.mark.parametrize("shape,eps", [((16 * 41, 768), 1e-12), ((4 * 257, 1408), 1e-6)])
def test_add_layer_norm_kernel_blip2_eps(dev, shape, eps):
    """The Q-Former's post-LN (eps 1e-12) and EVA's (eps 1e-6)."""
    x, r = _randn(dev, *shape, std=3.0), _randn(dev, *shape, seed=3, std=3.0)
    w, b = _randn(dev, shape[-1], seed=1), _randn(dev, shape[-1], seed=2)
    s, y = N.add_layer_norm_fused(x, r, w, b, eps)
    assert torch.equal(s, x + r)
    _close(y, N.layer_norm_plain(x + r, w, b, eps), 1e-5, 8e-3)


@pytest.mark.parametrize("b,s,h,causal,mask", [
    (2, 257, 16, False, False),   # EVA ViT-g: 257 unmasked keys, ragged last tile
    (3, 70, 4, True, False),      # causal, ragged tiles
    (2, 300, 4, False, True),     # key mask over three 128-key tiles
    (2, 40, 16, False, False),    # Sq <= 64: the one-warpgroup variant
])
def test_attention_kernel_head_dim_88(dev, b, s, h, causal, mask):
    """88 pads to 96 (six 16-column panels): the TMA zero-fills columns
    88..95 (the next head's lanes in the packed row), P.V runs with N = 96,
    and 88 output columns are stored."""
    qkv = _randn(dev, b, s, 3 * h * 88, seed=7)
    kw = dict(causal=causal)
    if mask:
        lens = torch.tensor([s, s // 2 + 3], device=dev)
        kw["kv_mask"] = torch.arange(s, device=dev)[None] < lens[:, None]
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, None)
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


def test_attention_kernel_qformer_and_clip_text_sites(dev):
    """The Q-Former's cross-attention (32 queries over 257 image rows, k and
    v column views of one packed projection) and self-attention (32 queries
    + 9 text tokens under the text's key mask), and the CLIP text tower's
    causal attention over 77 tokens."""
    q, kv = _randn(dev, 4, 32, 768, seed=8), _randn(dev, 4, 257, 2 * 768, seed=9)
    out = A.attention_flat(q, kv[..., :768], kv[..., 768:], 12)
    _close_attn(out, A.attention_flat_reference(q, kv[..., :768], kv[..., 768:], 12))
    qkv = _randn(dev, 4, 41, 3 * 768, seed=10)
    m = torch.ones((4, 41), dtype=torch.bool, device=dev)
    m[1, 36:] = m[3, 33:] = False
    out = A.attention_flat_packed(qkv, 12, kv_mask=m)
    q, k, v, _ = A._split_packed(qkv, 12, None)
    _close_attn(out, A.attention_flat_reference(q, k, v, 12, kv_mask=m))
    qkv = _randn(dev, 8, 77, 3 * 512, seed=11)
    out = A.attention_flat_packed(qkv, 8, causal=True)
    q, k, v, _ = A._split_packed(qkv, 8, None)
    _close_attn(out, A.attention_flat_reference(q, k, v, 8, causal=True))


# ---------------------------------------------------------------------------
# Decode sites: sq = 1 against a KV cache (the generation path)
# ---------------------------------------------------------------------------

def _decode_operands(dev, b, s, h, kvh, d, step, lo, seed=0):
    """q (B, 1, H*d), the q lanes of a packed q|k|v row; k, v views of (B, s
    + 32, KvH*d) caches over slots [0, s + step]; kv_mask with each
    prompt's pad slots (lengths in [lo, s]) invalid and the generated slots
    valid."""
    q = _randn(dev, b, 1, (h + 2 * kvh) * d, seed=seed)[..., :h * d]
    ck = _randn(dev, b, s + 32, kvh * d, seed=seed + 1)
    cv = _randn(dev, b, s + 32, kvh * d, seed=seed + 2)
    sk = s + step + 1
    lens = torch.randint(lo, s + 1, (b,), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 3))
    slots = torch.arange(sk, device=dev)[None]
    mask = (slots < lens[:, None]) | (slots >= s)
    return q, ck[:, :sk], cv[:, :sk], mask


@pytest.mark.parametrize("b,s,h,kvh,d,window,step", [
    (4, 1280, 28, 4, 128, None, 16),   # Qwen2.5-VL-7B: GQA 28/4
    (2, 4096, 8, 4, 256, 1024, 16),    # Gemma-3-4B past the bucket: the window bites
    (3, 200, 16, 16, 72, None, 0),     # the first step, MHA, d=72
    (2, 40, 8, 2, 64, 8, 5),           # a window of 8 over pad slots
    (4, 1024, 32, 4, 128, None, 31),   # Qwen3-VL: GQA 32/4
])
def test_attention_kernel_decode_step(dev, b, s, h, kvh, d, window, step):
    """The flat kernel at sq = 1 over a cache view (batch stride of the
    whole cache), end-aligned causal band and window, kv_mask with pad
    slots, against the plain version; one launch."""
    q, k, v, mask = _decode_operands(dev, b, s, h, kvh, d, step, max(1, s - 100))
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask, local_window=window,
              scale=d ** -0.5 if window is None else 1.0 / 16)
    before = launch_counts()["flash_attention_flat"]
    out = A.flash_attention_flat(q, k, v, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


def test_t5_decode_step_attention_kernels(dev):
    """The T5-xl decoder step: self-attention over cpos + 1 cached keys with
    the bias row offset to cpos, dense in the flat kernel and in the
    per-head kernel's table (both against the plain version of the same
    bias); cross-attention over 640 encoder rows with their kv_mask."""
    from t2v_metrics_tpu_torch.ops.position import compute_position_bias

    b, h, d, cpos = 4, 32, 64, 16
    sk = cpos + 1
    q = _randn(dev, b, 1, 3 * h * d)[..., :h * d]
    k = _randn(dev, b, 33, h * d, seed=1)[:, :sk]
    v = _randn(dev, b, 33, h * d, seed=2)[:, :sk]
    rel = _randn(dev, h, 32, seed=3, dtype=torch.float32, std=3.0)
    bias = compute_position_bias(rel.T, 1, sk, False, 32, 128, q_offset=cpos).contiguous()
    _close_attn(A.flash_attention_flat(q, k, v, h, bias=bias, scale=1.0),
                A.attention_flat_reference(q, k, v, h, bias=bias, scale=1.0))
    qh = q.view(b, 1, h, d).transpose(1, 2)
    kh, vh = (t.view(b, sk, h, d).transpose(1, 2) for t in (k, v))
    kw = dict(scale=1.0, rel_bias=rel, rel_cfg=(False, 32, 128, cpos))
    before = launch_counts()["flash_attention"]
    out = A.flash_attention(qh, kh, vh, **kw)
    assert launch_counts()["flash_attention"] == before + 1
    ref = A.attention_reference(qh, kh, vh, **kw)
    _close_attn(out, ref)
    _close_attn(ref, A.attention_reference(qh, kh, vh, bias=bias, scale=1.0))
    qc = _randn(dev, b, 1, h * d, seed=4)
    kc, vc = _randn(dev, b, 640, h * d, seed=5), _randn(dev, b, 640, h * d, seed=6)
    m = torch.arange(640, device=dev)[None] < torch.tensor([[640], [600], [591], [620]],
                                                            device=dev)
    _close_attn(A.flash_attention_flat(qc, kc, vc, h, kv_mask=m, scale=1.0),
                A.attention_flat_reference(qc, kc, vc, h, kv_mask=m, scale=1.0))


def test_one_row_norm_rope_kernels(dev):
    """RMSNorm over (4, 3584), alone and with the add, and rope over (4, 1,
    36 x 128): one row a sequence, as a decode step gives them."""
    x, w = _randn(dev, 4, 3584, std=3.0), _randn(dev, 3584, seed=1)
    _close(N.rms_norm_fused(x, w), N.rms_norm_plain(x, w), 1e-5, 1.6e-2)
    r = _randn(dev, 4, 3584, seed=4, std=3.0)
    s, y = N.add_rms_norm_fused(x, r, w)
    assert torch.equal(s, x + r)
    _close(y, N.rms_norm_plain(x + r, w), 1e-5, 1.6e-2)
    pk = _randn(dev, 4, 1, 36 * 128, seed=2)
    ang = 1290.0 * _randn(dev, 128, seed=3, dtype=torch.float32).abs().expand(4, 1, 128)
    cos, sin = torch.cos(ang), torch.sin(ang)
    ref = R.rope_pack_plain(pk, cos, sin, 32, 128)
    _close(R.rope_pack(pk.clone(), cos, sin, 32, 128), ref, 1e-5, 8e-3)


@pytest.mark.parametrize("tokens", [1, 4])
def test_grouped_gemm_kernel_decode_routing(dev, tokens):
    """One decode step of the 128-expert MoE: tokens x 8 routed rows, groups
    of one row each (one 128-row block apiece), the empty experts skipped;
    num_blocks as the dispatch calls it."""
    ids = torch.rand((tokens, 128), generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev).topk(8).indices.reshape(-1)
    _, _, be, p, used, _ = M._plan(ids, 128, M.BLOCK_M)
    assert int(used) == len(set(ids.tolist()))
    xg = _randn(dev, p, 2048, seed=6)
    w = _randn(dev, 128, 2048, 256, seed=7, std=2048 ** -0.5)
    out = M.grouped_matmul(xg, w, be, M.BLOCK_M, used)
    _close(out, M.grouped_matmul_reference(xg, w, be.cpu(), M.BLOCK_M, used.cpu()),
           1e-4, 2 ** -7)


@pytest.mark.parametrize("k,n", [(4096, 12288), (10240, 4096)])
def test_int8_kernels_at_decode_rows(dev, k, n):
    """The row quant and the int8 GEMM at M = 4 (an xxl decode step): bitwise."""
    x = _randn(dev, 4, k, std=3.0)
    (xq, xs), (rq, rs) = TQ.quantize_rows(x), TQ.quantize_rows_plain(x)
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    leaf = TQ.Linear(_randn(dev, k, n, seed=1, std=k ** -0.5)).quantize_()
    out = TQ.quant_matmul(xq, leaf.w_q, xs, leaf.scale)
    assert torch.equal(out, TQ.quant_matmul_plain(xq, leaf.w_q, xs, leaf.scale))


# ---------------------------------------------------------------------------
# Sites of PaliGemma, Gemma 4, LLaVA-1.5 and InstructBLIP
# ---------------------------------------------------------------------------

def _prefix_ids(dev, lens, s):
    """PaliGemma's overlay: group 0 on each row's valid prefix, -1 on its
    pad rows."""
    rows = torch.arange(s, device=dev)[None]
    return torch.where(rows < torch.tensor(lens, device=dev)[:, None], 0, -1).int()


@pytest.mark.parametrize("b,s,h,kvh,d,window,lens,blocks", [
    (2, 2048, 8, 1, 256, None, (1050, 1031), "prefix"),   # PaliGemma-448, MQA 8/1
    (1, 4352, 8, 1, 256, None, (4130,), "prefix"),        # PaliGemma-896, past 4096
    (1, 1536, 32, 16, 128, 1024, (1300,), ((10, 256), (600, 256))),  # Gemma 4-31b
    (2, 512, 16, 8, 256, 1024, (300, 290), ((5, 256),)),  # Gemma 4-12b
    (2, 704, 32, 32, 128, None, (700, 650), ()),          # LLaVA-7b, MHA
])
def test_attention_kernel_family_prefill_sites(dev, b, s, h, kvh, d, window, lens, blocks):
    """The decoder prefills of the new families: causal, kv_mask on each
    row's pad, and the overlay (PaliGemma's one group over the whole valid
    prompt, Gemma 4's image blocks) with the window where the layer has
    one; against the plain version, one launch."""
    qkv = _randn(dev, b, s, (h + 2 * kvh) * d, seed=21)
    mask = torch.arange(s, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask, local_window=window)
    if blocks == "prefix":
        kw["bidir_ids"] = _prefix_ids(dev, lens, s)
    elif blocks:
        kw["bidir_ids"] = _bidir(dev, b, s, blocks)
    before = launch_counts()["flash_attention_flat"]
    out = A.attention_flat_packed(qkv, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    q, k, v, _ = A._split_packed(qkv, h, kvh)
    ref = torch.cat([A.attention_flat_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1], h,
                                                **{**kw, "kv_mask": mask[i:i + 1],
                                                   **({"bidir_ids": kw["bidir_ids"][i:i + 1]}
                                                      if "bidir_ids" in kw else {})})
                     for i in range(b)])
    _close_attn(out, ref)


@pytest.mark.parametrize("b,s,h,kvh,d,window,step", [
    (2, 512, 16, 8, 256, 1024, 4),     # Gemma 4-12b's rollout: GQA 16/8
    (2, 2048, 8, 1, 256, None, 7),     # PaliGemma's generate: MQA over a kv head of 1
    (4, 704, 32, 32, 128, None, 7),    # LLaVA-7b's generate
])
def test_attention_kernel_family_decode_sites(dev, b, s, h, kvh, d, window, step):
    q, k, v, mask = _decode_operands(dev, b, s, h, kvh, d, step, max(1, s - 100), seed=23)
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask, local_window=window)
    _close_attn(A.flash_attention_flat(q, k, v, h, **kw),
                A.attention_flat_reference(q, k, v, h, **kw))


def test_attention_kernel_siglip_and_instructblip_sites(dev):
    """SigLIP-224 / 448 in the flat kernel at d 72; InstructBLIP's Q-Former
    self-attention over 32 queries + instruction tokens under kv_mask (d 64)
    and its T5-xl encoder over 32 query rows + the prompt with the dense
    bias and kv_mask (scale 1)."""
    for s in (256, 1024):
        qkv = _randn(dev, 2, s, 3 * 16 * 72, seed=s)
        q, k, v, _ = A._split_packed(qkv, 16, None)
        _close_attn(A.attention_flat_packed(qkv, 16), A.attention_flat_reference(q, k, v, 16))
    qkv = _randn(dev, 8, 32 + 20, 3 * 12 * 64, seed=31)
    m = torch.arange(52, device=dev)[None] < torch.tensor([[52], [45], [40], [52], [38], [50],
                                                           [41], [47]], device=dev)
    q, k, v, _ = A._split_packed(qkv, 12, None)
    _close_attn(A.attention_flat_packed(qkv, 12, kv_mask=m),
                A.attention_flat_reference(q, k, v, 12, kv_mask=m))
    from t2v_metrics_tpu_torch.ops.position import compute_position_bias

    s = 32 + 25
    qkv = _randn(dev, 4, s, 3 * 32 * 64, seed=32)
    rel = _randn(dev, 32, 32, seed=33, dtype=torch.float32, std=3.0)
    bias = compute_position_bias(rel.T, s, s, True, 32, 128).float().contiguous()
    m = torch.arange(s, device=dev)[None] < torch.tensor([[57], [50], [44], [57]], device=dev)
    q, k, v, _ = A._split_packed(qkv, 32, None)
    _close_attn(A.attention_flat_packed(qkv, 32, bias=bias, kv_mask=m, scale=1.0),
                A.attention_flat_reference(q, k, v, 32, bias=bias, kv_mask=m, scale=1.0))


def test_attention_kernel_internvit_sites(dev):
    """InternViT-300M: a packed (B, 1025, 3x1024) projection at d 64, no
    mask (the last 64-row q tile holds one row); InternViT-6B: separate q,
    k, v of (B, 1025, 3200), 25 heads of 128, q and k RMS-normalized over
    the whole width first."""
    qkv = _randn(dev, 2, 1025, 3 * 1024, seed=41)
    q, k, v, _ = A._split_packed(qkv, 16, None)
    _close_attn(A.attention_flat_packed(qkv, 16), A.attention_flat_reference(q, k, v, 16))
    q, k, v = (_randn(dev, 2, 1025, 3200, seed=42 + i, std=3.0) for i in range(3))
    w = _randn(dev, 3200, seed=45)
    q, k = N.rms_norm_fused(q, w), N.rms_norm_fused(k, w)
    _close_attn(A.flash_attention_flat(q, k, v, 25), A.attention_flat_reference(q, k, v, 25))


@pytest.mark.parametrize("rows,d,kind", [(2050, 3200, "rms"), (2048, 12800, "ln"),
                                         (2048, 4096, "ln"), (2050, 1024, "add_ln")])
def test_norm_kernels_internvl_widths(dev, rows, d, kind):
    """RMSNorm at the 6B tower's width 3200; LayerNorm at the projector's
    shuffled widths 12800 (6B) and 4096 (300M); add + LayerNorm at the
    300M tower's 1024, eps 1e-6."""
    x, w, b = _randn(dev, rows, d, seed=46, std=3.0), _randn(dev, d, seed=47), \
        _randn(dev, d, seed=48)
    if kind == "rms":
        _close(N.rms_norm_fused(x, w), N.rms_norm_plain(x, w), 1e-5, 1.6e-2)
    elif kind == "ln":
        _close(N.layer_norm_fused(x, w, b, 1e-5), N.layer_norm_plain(x, w, b, 1e-5), 1e-5, 8e-3)
    else:
        r = _randn(dev, rows, d, seed=49)
        s, y = N.add_layer_norm_fused(x, r, w, b, 1e-6)
        s0, y0 = N.add_layer_norm_plain(x, r, w, b, 1e-6)
        assert torch.equal(s, s0)
        _close(y, y0, 1e-5, 8e-3)


@pytest.mark.parametrize("b,s,h,kvh,d,lens", [
    (2, 2688, 32, 8, 128, (2660, 2600)),   # internvl3.5-8b prefill, a 1024 px image
    (1, 8384, 32, 8, 128, (8330,)),        # internvl3.5-8b video prefill, 32 tiles
    (2, 512, 32, 8, 80, (420, 400)),       # molmo2-4b at d 80
])
def test_attention_kernel_internvl_molmo2_prefills(dev, b, s, h, kvh, d, lens):
    qkv = _randn(dev, b, s, (h + 2 * kvh) * d, seed=51)
    mask = torch.arange(s, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask)
    out = A.attention_flat_packed(qkv, h, **kw)
    q, k, v, _ = A._split_packed(qkv, h, kvh)
    # one kv head's group at a time: the fp32 scores of all heads at once
    # would not fit
    g = h // kvh
    ref = torch.cat([A.attention_flat_reference(
        q[..., i * g * d:(i + 1) * g * d], k[..., i * d:(i + 1) * d],
        v[..., i * d:(i + 1) * d], g, **{**kw, "kv_heads": 1}) for i in range(kvh)], dim=-1)
    _close_attn(out, ref)


@pytest.mark.parametrize("b,s,h,kvh,d,step", [(2, 2688, 32, 8, 128, 5),
                                              (2, 512, 32, 8, 80, 3)])
def test_attention_kernel_internvl_molmo2_decode(dev, b, s, h, kvh, d, step):
    q, k, v, mask = _decode_operands(dev, b, s, h, kvh, d, step, s - 60, seed=52)
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask)
    _close_attn(A.flash_attention_flat(q, k, v, h, **kw),
                A.attention_flat_reference(q, k, v, h, **kw))


def test_pillow_resize_on_the_card_equals_the_cpu(dev):
    """The fixed-point resize sums exactly in float64 on the card too."""
    from t2v_metrics_tpu_torch.ops.image import resize_uint8_pillow_flat

    img = torch.randint(0, 256, (2, 300, 380 * 3), generator=torch.Generator().manual_seed(5),
                        dtype=torch.uint8)
    want = resize_uint8_pillow_flat(img, 1344, 1792, 3)
    assert torch.equal(resize_uint8_pillow_flat(img.to(dev), 1344, 1792, 3).cpu(), want)


@pytest.mark.parametrize("src,out,pad", [((1024, 1024), (992, 992), False),   # Qwen3 / Omni
                                         ((1024, 1024), (980, 980), False),   # Qwen2.5
                                         ((1024, 768), (336, 336), True),     # LLaVA, CLIP-FlanT5
                                         ((1024, 1024), (896, 896), False),   # Gemma 3
                                         ((1024, 1024), (448, 448), False),   # PaliGemma-448
                                         ((1024, 1024), (224, 224), False),   # InstructBLIP
                                         ((1024, 1024), (364, 364), False),   # ITMScore
                                         ((480, 640), (320, 448), False)])    # a video frame
def test_pillow_resize_sites_on_the_card_equal_the_cpu(dev, src, out, pad):
    """Each Pillow-resize site of the port at its shape: the card's result
    (padded to square first where the site pads) equals the CPU's, bit for
    bit (the CPU's equals Pillow's: tests/test_torch_image.py)."""
    from t2v_metrics_tpu_torch.engine.scoring import pillow_resize_batch
    from t2v_metrics_tpu_torch.ops.image import resize_uint8_pillow_flat

    rng = torch.Generator().manual_seed(src[0] + out[0])
    img = torch.randint(0, 256, (2, src[0], src[1] * 3), generator=rng, dtype=torch.uint8)
    if pad:
        imgs = [x.reshape(src[0], src[1], 3).numpy() for x in img]
        want = pillow_resize_batch(imgs, out[0], True, "cpu")
        got = pillow_resize_batch(imgs, out[0], True, dev)
    else:
        want = resize_uint8_pillow_flat(img, *out, 3)
        got = resize_uint8_pillow_flat(img.to(dev), *out, 3)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_log_mel_on_the_card_equals_the_cpu(dev):
    """The float64 log-mel of 30 s of audio on the card against the CPU."""
    import numpy as np

    from t2v_metrics_tpu_torch.models.qwen3omni_audio import log_mel_device

    audio = (np.random.default_rng(3).standard_normal(16000 * 30) * 0.1).astype(np.float32)
    torch.testing.assert_close(log_mel_device(audio, device=dev).cpu(),
                               log_mel_device(audio), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Qwen3-Omni's talker, code predictor and Code2Wav (the speech path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,kvh,d,window", [
    (1184, 16, 2, 64, None),     # the talker's prefill: GQA 16/2
    (325, 16, 16, 64, 72),       # a Code2Wav chunk: MHA, causal, window 72
    (2, 16, 8, 128, None),       # the code predictor's prefill: two rows
])
def test_attention_kernel_talker_prefill_sites(dev, s, h, kvh, d, window):
    """The flat kernel on the speech path's packed projections, causal (a
    window where Code2Wav has one), one launch each, against the plain
    version."""
    packed = _randn(dev, 1, s, (h + 2 * kvh) * d, seed=s)
    q, k, v, _ = A._split_packed(packed, h, kvh)
    kw = dict(kv_heads=kvh, causal=True, local_window=window)
    before = launch_counts()["flash_attention_flat"]
    out = A.flash_attention_flat_packed(packed, h, **kw)
    assert launch_counts()["flash_attention_flat"] == before + 1
    _close_attn(out, A.attention_flat_reference(q, k, v, h, **kw))


@pytest.mark.parametrize("sk,h,kvh,d", [(1200, 16, 2, 64), (16, 16, 8, 128), (3, 16, 8, 128)])
def test_attention_kernel_talker_decode_sites(dev, sk, h, kvh, d):
    """One decode step of the talker (over its prompt and generated slots)
    and of the code predictor (over at most 16 slots): q (1, 1, H*d) over
    (1, sk, KvH*d) cache views, every slot valid."""
    q = _randn(dev, 1, 1, (h + 2 * kvh) * d, seed=sk)[..., :h * d]
    k = _randn(dev, 1, sk + 8, kvh * d, seed=sk + 1)[:, :sk]
    v = _randn(dev, 1, sk + 8, kvh * d, seed=sk + 2)[:, :sk]
    mask = torch.ones((1, sk), dtype=torch.bool, device=dev)
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask)
    _close_attn(A.flash_attention_flat(q, k, v, h, **kw),
                A.attention_flat_reference(q, k, v, h, **kw))


@pytest.mark.parametrize("tokens", [1, 300])
def test_grouped_gemm_kernel_talker_shapes(dev, tokens):
    """The talker's experts: gate_up (rows, 1024) x (128, 1024, 768) and down
    (rows, 384) x (128, 384, 1024) over a top-8 routing of one decode token
    and of 300 prefill tokens, with num_blocks."""
    ids = torch.rand((tokens, 128), generator=torch.Generator(device=dev).manual_seed(9),
                     device=dev).topk(8).indices.reshape(-1)
    _, _, be, p, used, _ = M._plan(ids, 128, M.BLOCK_M)
    for k, n in ((1024, 768), (384, 1024)):
        xg = _randn(dev, p, k, seed=k)
        w = _randn(dev, 128, k, n, seed=n, std=k ** -0.5)
        _close(M.grouped_matmul(xg, w, be, M.BLOCK_M, used),
               M.grouped_matmul_reference(xg, w, be.cpu(), M.BLOCK_M, used.cpu()),
               1e-4, 2 ** -7)


def test_talker_norm_rope_sites(dev):
    """RMSNorm at 1024 (eps 1e-6 and Code2Wav's 1e-5), alone and with the
    add, the qk-norm + rope of 16 + 2 heads of 64 and 16 + 8 of 128 (in
    place), rope on 18 heads of 64, 24 of 128 and 32 of 64, and the ConvNeXt
    LayerNorm at 1024, eps 1e-6."""
    for rows, eps in ((1184, 1e-6), (1, 1e-6), (325, 1e-5)):
        x, w = _randn(dev, rows, 1024, std=3.0), _randn(dev, 1024, seed=1)
        _close(N.rms_norm_fused(x, w, eps), N.rms_norm_plain(x, w, eps), 1e-5, 1.6e-2)
        r = _randn(dev, rows, 1024, seed=8, std=3.0)
        s, y = N.add_rms_norm_fused(x, r, w, eps)
        assert torch.equal(s, x + r)
        _close(y, N.rms_norm_plain(x + r, w, eps), 1e-5, 1.6e-2)
    for rows, hq, hk, d in ((1184, 16, 2, 64), (2, 16, 8, 128)):
        pk, qs, ks = (_randn(dev, 1, rows, (hq + 2 * hk) * d, std=3.0), _randn(dev, d, seed=2),
                      _randn(dev, d, seed=3))
        ang = (torch.arange(rows, device=dev, dtype=torch.float32)[None, :, None]
               * _randn(dev, d, seed=5, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        ref = R.rms_norm_rope_pack_plain(pk, qs, ks, cos, sin, hq, hk, d)
        _close_qk_rope(R.rms_norm_rope_pack(pk.clone(), qs, ks, cos, sin, hq, hk, d), ref,
                       N.rms_norm_heads_plain(pk, qs, ks, hq, hk, d), pk, hq + hk, d)
    for rows, rot, width, d in ((1184, 18, 20, 64), (2, 24, 32, 128), (325, 32, 48, 64)):
        pk = _randn(dev, 1, rows, width * d, seed=4)
        ang = (torch.arange(rows, device=dev, dtype=torch.float32)[None, :, None]
               * _randn(dev, d, seed=5, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        _close(R.rope_pack(pk.clone(), cos, sin, rot, d), R.rope_pack_plain(pk, cos, sin, rot, d),
               1e-5, 8e-3)
    for rows in (650, 1300):
        x, w, b = (_randn(dev, rows, 1024, std=3.0), _randn(dev, 1024, seed=6),
                   _randn(dev, 1024, seed=7))
        _close(N.layer_norm_fused(x, w, b, 1e-6), N.layer_norm_plain(x, w, b, 1e-6), 1e-5, 8e-3)


def test_code2wav_on_the_card_as_on_the_cpu(dev):
    """A Code2Wav of 2 transformer layers and the whole conv stack, bf16 on
    the card through the kernels against fp32 on the CPU, on one seeded
    code matrix: within chip_smoke's WAV_TOL_RMS (5%) of rms(cpu)."""
    import dataclasses

    import numpy as np

    from t2v_metrics_tpu_torch.models import qwen3omni_talker as tk

    cfg = dataclasses.replace(tk.Code2WavConfig(), upsample_rates=(8, 5, 4, 3),
                              num_hidden_layers=2)
    card = tk.init_code2wav(cfg, 0, dev, torch.bfloat16)
    host = tk.Code2WavModel(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, t in card.state_dict().items():
            host.state_dict()[name].copy_(t.float().cpu())
    codes = np.random.default_rng(0).integers(0, 2048, (1, 16, 20))
    with torch.inference_mode():
        got, want = tk.code2wav(card, cfg, codes).float().cpu(), tk.code2wav(host, cfg, codes)
    rms = float(want.square().mean().sqrt())
    assert got.shape == want.shape and 0.01 < rms < 0.9
    assert float((got - want).square().mean().sqrt()) <= 5e-2 * rms


def _card_clip_flant5(monkeypatch):
    """A small CLIP-FlanT5 on the card: clip-flant5-test widened to heads
    of 64, which the attention kernel takes."""
    import dataclasses

    import t2v_metrics_tpu_torch as tt2v
    from t2v_metrics_tpu_torch.models import adapters

    spec = adapters.CLIP_T5_MODELS["clip-flant5-test"]
    cfg = spec["config"]
    cfg = dataclasses.replace(
        cfg, t5=dataclasses.replace(cfg.t5, d_model=128, d_kv=64, num_heads=2),
        vision=dataclasses.replace(cfg.vision, width=128, heads=2, mlp_dim=256, proj_dim=128))
    monkeypatch.setitem(adapters.CLIP_T5_MODELS, "clip-flant5-test", dict(spec, config=cfg))
    return tt2v.VQAScore("clip-flant5-test", device="cuda")


@pytest.mark.parametrize("hw", [(1024, 1024), (400, 392), (300, 380)])
def test_host_syncs_count_every_copy_the_card_sees(dev, hw, monkeypatch):
    """The copy counters (``tracing.to_device`` / ``to_host``) against the
    card's own record: in a profiled staged ``batch_forward`` and a call of
    a small CLIP-FlanT5, no host-to-device copy is from pageable memory, the
    profiler's copies from page-locked memory are as many as ``h2d_async``
    and its device-to-host copies as many as ``host_syncs``, over both
    resize paths (above and up to 384 px) and with and without the square
    pad."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t2v_metrics_tpu_torch import tracing

    scorer = _card_clip_flant5(monkeypatch)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(6)]
    texts = ["a cube", "two red dogs", "a horse", "the sky", "one chair", "a boat"]
    data = [{"images": [im], "texts": [t]} for im, t in zip(images, texts)]

    def work():
        scorer.batch_forward(data, batch_size=4)
        scorer(images=images[:3], texts=[texts[1]])

    work()                                      # builds, compiles, warms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
    copies = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    counts = tracing.counts()
    pageable = [c for c in copies if c.startswith("Memcpy HtoD (Pageable")]
    pinned = [c for c in copies if c.startswith("Memcpy HtoD (Pinned")]
    down = [c for c in copies if c.startswith("Memcpy DtoH")]
    assert not pageable, sorted(set(copies))
    assert pinned and len(pinned) == counts["h2d_async"], sorted(set(copies))
    assert down and len(down) == counts["host_syncs"], sorted(set(copies))
    assert len(pinned) + len(down) == len(copies), sorted(set(copies))


@pytest.mark.parametrize("hw", [(1024, 1024), (300, 380)])
def test_async_copies_score_as_the_blocking_ones(dev, hw, monkeypatch):
    """Scores through the page-locked, non-blocking copies and the copy
    stream equal, bit for bit, those of the blocking path (``to_device`` as
    a pageable ``Tensor.to``, no copy stream): a staged ``batch_forward`` of
    5 chunks with every image distinct, so that a page-locked buffer reused
    before its copy ran, or a read of the pixels before the copy stream made
    them, changes a score; and a call. Over Pillow's resize (1024 px) and
    the float resize with the square pad (300x380)."""
    import numpy as np

    from t2v_metrics_tpu_torch import tracing

    scorer = _card_clip_flant5(monkeypatch)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(18)]
    words = ["a cube", "two red dogs", "a horse", "the sky", "one chair", "a boat"]
    texts = [f"{words[i % 6]} and {words[(5 * i + 1) % 6]}" for i in range(18)]
    data = [{"images": [im], "texts": [t]} for im, t in zip(images, texts)]

    def work():
        return (scorer.batch_forward(data, batch_size=4),
                scorer(images=images[:5], texts=texts[:2]))

    warm = work()                               # builds, compiles, fills the host pool
    got = work()
    monkeypatch.setattr(tracing, "to_device",
                        lambda a, device, dtype=None: torch.as_tensor(a).to(device, dtype))
    monkeypatch.setattr(tracing, "host_empty",
                        lambda shape, dtype, device: torch.empty(shape, dtype=dtype))
    monkeypatch.setattr(scorer.model.engine, "copies", tracing.CopyStream("cpu"))
    want = work()
    for w, g, b in zip(warm, got, want):
        assert np.isfinite(b).all() and len(np.unique(b)) > 1
        np.testing.assert_array_equal(g, b)
        np.testing.assert_array_equal(w, b)


def _card_qwen3_moe(device="cuda"):
    """qwen3-vl-moe-test widened to what the card's kernels take (head dims
    of 64, widths of whole 128-column tiles), with the sorted dispatch and
    the grouped GEMM: (scorer, config)."""
    import dataclasses

    import t2v_metrics_tpu_torch as tt2v
    from t2v_metrics_tpu_torch.models import qwen3vl as tq3

    cfg = tq3.resolve_config("qwen3-vl-moe-test")
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, hidden=128, heads=2, d_ff=256,
                                        out_hidden=128),
        text=dataclasses.replace(cfg.text, d_model=128, heads=2, kv_heads=1, head_dim=64,
                                 mrope_section=(12, 10, 10), moe_d_ff=64, moe_dispatch=True))
    return tt2v.VQAScore("qwen3-vl-moe-test", config=cfg, device=device), cfg


def test_qwen_moe_trace_copies_back_the_scores_alone(dev):
    """A profiled ``batch_forward`` of a small Qwen3-VL MoE with the routing
    counters on: the card's device-to-host copies are the score read-backs
    alone (``host_syncs``, one a chunk), every host-to-device copy is from
    page-locked memory (``h2d_async``), and the counters, kept on the card
    through the window, read back after it."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t2v_metrics_tpu_torch import tracing

    scorer, cfg = _card_qwen3_moe()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (200, 240, 3), dtype=np.uint8) for _ in range(6)]
    texts = ["a cube", "two red dogs", "a horse", "the sky", "one chair", "a boat"]
    data = [{"images": [im], "texts": [t]} for im, t in zip(images, texts)]
    scorer.batch_forward(data, batch_size=2)    # builds, compiles, warms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # in a process that built the kernels, the profiler dropped the device
        # record of the window's first operation (the first upload's
        # cudaMemcpyAsync was recorded, its Memcpy not): a finished kernel
        # that is no copy goes first
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        out = scorer.batch_forward(data, batch_size=2)
    copies = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    counts = tracing.counts()
    down = [c for c in copies if c.startswith("Memcpy DtoH")]
    pinned = [c for c in copies if c.startswith("Memcpy HtoD (Pinned")]
    assert len(down) == counts["host_syncs"] == 3, sorted(set(copies))
    assert len(pinned) == counts["h2d_async"] and len(pinned) + len(down) == len(copies)
    t = cfg.text
    assert counts["moe_rows"] % (t.experts_per_tok * t.layers) == 0
    assert counts["moe_rows"] <= counts["moe_block_rows"]
    assert counts["moe_max_rows"] * t.num_experts >= counts["moe_rows"]
    assert np.isfinite(out).all()
