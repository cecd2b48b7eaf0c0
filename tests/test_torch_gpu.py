"""Hopper kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (there is no
interpret mode for a CUDA or Triton kernel). This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances as in chip_smoke.py: norms within 1 bf16 ulp (rtol 8e-3; 1.6e-2
for T5's twice-rounded RMSNorm) plus atol 1e-5 near zero; attention atol and
rtol 2e-2 (P rounded to bf16 against per-tile running maxima); the rotary
embedding within 1 bf16 ulp (rtol 8e-3; the kernel may fuse a multiply-add
that the plain version rounds twice in fp32) plus atol 1e-5 near zero.
"""

import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu_torch.ops import attention as A  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts, norms as N  # noqa: E402
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


@pytest.mark.parametrize("shape", [(7, 1024), (3, 5, 1000), (16, 64)])
def test_layer_norm_kernel(dev, shape):
    x = _randn(dev, *shape, std=3.0)
    w, b = _randn(dev, shape[-1], seed=1), _randn(dev, shape[-1], seed=2)
    before = launch_counts()["layer_norm"]
    _close(N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b), 1e-5, 8e-3)
    _close(N.layer_norm_fused(x, w, None), N.layer_norm_plain(x, w, None), 1e-5, 8e-3)
    assert launch_counts()["layer_norm"] == before + 2


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


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal,bias,mask", [
    (2, 70, 70, 4, 4, False, True, True),     # ragged q and k tiles
    (3, 4, 4, 4, 4, True, True, False),       # T5 decoder self
    (2, 4, 130, 4, 4, False, False, True),    # T5 cross
    (2, 9, 200, 8, 2, True, False, True),     # GQA, end-aligned causal
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
    _close(out, A.attention_flat_reference(q, k, v, h, **kw), 2e-2, 2e-2)


def test_attention_kernel_packed_and_masked_rows(dev):
    qkv = _randn(dev, 2, 100, 3 * 4 * 64)
    m = torch.ones((2, 100), dtype=torch.bool, device=dev)
    m[1] = False
    out = A.flash_attention_flat_packed(qkv, 4, kv_mask=m)
    q, k, v, _ = A._split_packed(qkv, 4, None)
    _close(out, A.attention_flat_reference(q, k, v, 4, kv_mask=m), 2e-2, 2e-2)
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
    _close(out, A.attention_flat_reference(q, k, v, h, **kw), 2e-2, 2e-2)


def test_attention_kernel_refuses_what_it_lacks(dev):
    q = _randn(dev, 1, 8, 4 * 32)
    with pytest.raises(NotImplementedError):
        A.flash_attention_flat(q, q, q, 4)                      # head dim 32
    q = _randn(dev, 1, 8, 4 * 64)
    with pytest.raises(NotImplementedError):
        A.attention_flat(q, q, q, 4, causal=True, local_window=4)
    with pytest.raises(NotImplementedError):
        A.attention_flat(q, q, q, 4, causal=True,
                         bidir_ids=torch.zeros((1, 8), device=dev))
    with pytest.raises(ValueError):                             # not square
        A.attention_flat(q[:, :4], q, q, 4,
                         segment_ids=torch.zeros((1, 8), device=dev))
    with pytest.raises(TypeError):
        A.flash_attention_flat(q.float(), q.float(), q.float(), 4)
