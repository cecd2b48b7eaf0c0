"""Port parity: the ops of the Qwen2.5-VL slice against the JAX package on
the CPU — the packed-row rotary embedding (``ops/rope.py``), the RoPE and
M-RoPE tables (``models/decoder.py:rope_cos_sin``), segment-id and GQA
d=128 attention, the host geometry of ``models/qwen2vl.py`` and the device
image preprocess.

Tolerances: 1e-5 for the rotation (fp32, the same expression; the JAX
kernel runs in interpret mode); 2e-5 for attention (fp32, the flash form
divides by the row sum after P.V); cos/sin within 2e-6 (f32 pow and cos of
the two libraries may differ in the last bit); geometry exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl as jq  # noqa: E402
from t2v_metrics_tpu.ops import image as JI  # noqa: E402
from t2v_metrics_tpu.ops import rope as JR  # noqa: E402
from t2v_metrics_tpu.ops.attention import (attention_reference,  # noqa: E402
                                           flash_attention_flat_packed)
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq  # noqa: E402
from t2v_metrics_tpu_torch.ops import attention as TA  # noqa: E402
from t2v_metrics_tpu_torch.ops import image as TI  # noqa: E402
from t2v_metrics_tpu_torch.ops import rope as TR  # noqa: E402

VT = jq.QWEN2_VL_MODELS["qwen2.5-vl-test"]["config"]


def _cos_sin(pos, d):
    half = d // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, half, dtype=np.float32) / half))
    fr = pos[..., None] * inv
    emb = np.concatenate([fr, fr], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


# the shapes of tests/test_rope_kernel.py: Qwen ViT (MHA, d=80), a GQA
# decoder prefill (d=128), and d=64
@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 256, 16, 16, 80),
    (1, 128, 8, 2, 128),
    (2, 128, 4, 4, 64),
])
def test_rope_pack_matches_jax_kernel(b, s, h, kvh, d):
    rng = np.random.default_rng(0)
    lanes = (h + 2 * kvh) * d
    pk = rng.standard_normal((b, s, lanes)).astype(np.float32)
    cos, sin = _cos_sin(rng.integers(0, 512, (b, s)).astype(np.float32), d)
    got = TR.rope_pack(*map(torch.from_numpy, (pk, cos, sin)), h + kvh, d)
    want = JR.rope_pack(jnp.asarray(pk), jnp.asarray(cos), jnp.asarray(sin),
                        h + kvh, d, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the v lanes pass through unchanged, and the input is not written
    np.testing.assert_array_equal(got.numpy()[..., (h + kvh) * d:],
                                  pk[..., (h + kvh) * d:])
    assert not np.array_equal(got.numpy()[..., :d], pk[..., :d])


def test_rope_pack_bf16_rounds_once():
    """bf16 x times f32 cos/sin: products and sum in f32, one rounding."""
    rng = np.random.default_rng(1)
    pk = torch.from_numpy(rng.standard_normal((1, 8, 3 * 2 * 16)).astype(np.float32))
    cos, sin = map(torch.from_numpy, _cos_sin(np.arange(8.0)[None], 16))
    got = TR.rope_pack(pk.bfloat16(), cos, sin, 4, 16)
    want = TR.rope_pack(pk.bfloat16().float(), cos, sin, 4, 16).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("mrope", ["none", "sections", "interleaved"])
def test_rope_cos_sin_matches_jax(mrope):
    cfg = jdec.DecoderConfig(head_dim=16, mrope_section=(4, 2, 2))
    rng = np.random.default_rng(2)
    if mrope == "none":
        pos = rng.integers(0, 300, (2, 9))
    else:
        pos = rng.integers(0, 300, (3, 2, 9))
        cfg = dataclasses.replace(cfg, mrope_interleaved=mrope == "interleaved")
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    got = tdec.rope_cos_sin(tcfg, torch.from_numpy(pos), scaling=2.0)
    want = jdec.rope_cos_sin(cfg, jnp.asarray(pos), scaling=2.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 9, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6, rtol=0)


def test_segment_attention_matches_jax_flat_kernel():
    """Packed attention with segment ids (sorted windows, -1 pads) against
    the JAX flat kernel in interpret mode, at H=4, d=32."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((2, 160, 3 * 4 * 32)).astype(np.float32)
    seg = np.repeat(np.arange(10), 14)[None].repeat(2, 0)
    seg = np.concatenate([seg, np.full((2, 20), -1)], axis=1).astype(np.int32)
    seg[1, :40] = 7                                    # unsorted ids too
    got = TA.attention_flat_packed(torch.from_numpy(qkv), 4,
                                   segment_ids=torch.from_numpy(seg)).numpy()
    want = flash_attention_flat_packed(jnp.asarray(qkv), 4,
                                       segment_ids=jnp.asarray(seg),
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_gqa_causal_d128_matches_reference():
    """The decoder prefill's site: GQA 8/2, causal, key mask, d=128."""
    rng = np.random.default_rng(4)
    b, s, h, kvh, d = 2, 24, 8, 2, 128
    qkv = rng.standard_normal((b, s, (h + 2 * kvh) * d)).astype(np.float32)
    mask = np.arange(s)[None] < np.array([[24], [17]])
    got = TA.attention_flat_packed(torch.from_numpy(qkv), h, kv_heads=kvh,
                                   kv_mask=torch.from_numpy(mask),
                                   causal=True).numpy()
    q, k, v = np.split(qkv, [h * d, (h + kvh) * d], axis=-1)

    def heads(x, n):
        return jnp.asarray(x).reshape(b, s, n, d).transpose(0, 2, 1, 3)

    want = attention_reference(heads(q, h), jnp.repeat(heads(k, kvh), 4, 1),
                               jnp.repeat(heads(v, kvh), 4, 1),
                               kv_mask=jnp.asarray(mask), causal=True)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, s, h * d)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window,grid", [(16, (1, 16, 24)), (16, (1, 18, 26)),
                                         (24, (1, 24, 28)), (112, (1, 70, 70))])
def test_vision_geometry_equals_jax(window, grid):
    """Window permutation, rotary ids, segment ids and the tile layout."""
    v = VT.vision if window != 112 else jq.QwenVisionConfig()
    v = dataclasses.replace(v, window_size=window)
    tv = tq.QwenVisionConfig(**dataclasses.asdict(v))
    got, want = tq.vision_geometry(grid, tv), jq.vision_geometry(grid, v)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_build_rope_index_and_patches_equal_jax():
    tcfg = tq.QWEN2_VL_MODELS["qwen2.5-vl-test"]["config"]
    ids = np.array([5, 6, 503] + [501] * 24 + [504, 7, 8, 9])
    grid = (1, 8, 12)
    np.testing.assert_array_equal(tq.build_rope_index(ids, [grid], tcfg),
                                  jq.build_rope_index(ids, [grid], VT))
    frames = np.random.default_rng(5).standard_normal((1, 3, 32, 48)).astype(np.float32)
    got, got_grid = tq.frames_to_patches(frames, tcfg.vision)
    want, want_grid = jq.frames_to_patches(frames, VT.vision)
    assert got_grid == want_grid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(1024, 1024), (300, 380), (64, 96), (20, 3000),
                                (5000, 4000), (30, 30)])
def test_smart_resize_equals_jax(hw):
    for factor, mx in ((28, 28 * 28 * 1280), (8, 14 * 14 * 4 * 1280)):
        assert TI.smart_resize(*hw, factor, 56 * 56, mx) == \
            JI.smart_resize(*hw, factor, 56 * 56, mx)


def test_image_patches_match_jax_host_path():
    """On the smart-resize grid (no resize) the device preprocess gives the
    JAX host path's patch rows exactly (up to fp32 normalize rounding)."""
    img = np.random.default_rng(6).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    got = tq.image_patches(torch.from_numpy(img.reshape(2, 64, 96 * 3)),
                           tq.QWEN2_VL_MODELS["qwen2.5-vl-test"]["config"].vision,
                           64, 96)
    for i in range(2):
        want, grid = jq.image_to_patches(img[i], VT.vision)
        assert grid == (1, 16, 24)
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw,out", [((300, 380), (308, 392)),
                                    ((1024, 1024), (980, 980))])
def test_device_resize_within_one_level_of_pil(hw, out):
    """A real resize: the two-matmul bicubic rounded to uint8 levels is
    within one level of Pillow's fixed-point two-pass bicubic."""
    from PIL import Image

    img = np.random.default_rng(7).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = TI.resize_uint8_levels_flat(
        torch.from_numpy(img.reshape(1, hw[0], hw[1] * 3)).float(), *out, 3)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BICUBIC))
    diff = np.abs(got.numpy().reshape(*out, 3) - want.astype(np.float32))
    assert diff.max() <= 1.0
    assert np.array_equal(got.numpy(), np.round(got.numpy()))
