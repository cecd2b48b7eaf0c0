"""Port parity: image preprocessing (t2v_metrics_tpu_torch/ops/image.py and
the engine's device and host preprocess) against the JAX package on the CPU.

Tolerance 2e-5 on [0, 1] pixels in fp32 (same coefficients, different
matmul summation order); every uint8 resize (``resize_uint8_pillow_flat``,
the engine's ``pillow_resize_batch``) equals Pillow's bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu.ops import image as JI  # noqa: E402
from t2v_metrics_tpu_torch.ops import image as TI  # noqa: E402

TOL = 2e-5


def _img(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w * 3)).astype(np.float32)


@pytest.mark.parametrize("in_size,out_size", [(300, 336), (380, 336), (57, 14)])
def test_resize_weights_identical(in_size, out_size):
    for f in ("bicubic", "bilinear", "nearest"):
        np.testing.assert_array_equal(TI.resize_weights(in_size, out_size, f),
                                      JI.resize_weights(in_size, out_size, f))
    np.testing.assert_array_equal(TI.kron_resize_weights(in_size, out_size, 3),
                                  JI.kron_resize_weights(in_size, out_size, 3))
    assert TI.resize_shortest_side((in_size, 2 * in_size), out_size) == \
        JI.resize_shortest_side((in_size, 2 * in_size), out_size)


@pytest.mark.parametrize("hw", [(30, 38), (38, 30), (32, 32)])
def test_pad_resize_normalize_pipeline(hw):
    """The engine's device preprocess: pad to square with the CLIP-mean
    fill, resize to 56, clamp, normalize."""
    x = _img(2, *hw)
    fill = [int(m * 255) / 255.0 for m in CLIP_MEAN]
    t = TI.pad_square_flat(torch.from_numpy(x), 3, fill)
    j = JI.pad_square_flat(jnp.asarray(x), 3, fill)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    t = torch.clamp(TI.resize_flat(t, 56, 56, 3), 0.0, 1.0)
    j = jnp.clip(JI.resize_flat(j, 56, 56, 3), 0.0, 1.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
    t = TI.normalize_flat(t, CLIP_MEAN, CLIP_STD)
    j = JI.normalize_flat(j, CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=TOL)


def test_crop_and_patchify():
    x = _img(2, 40, 50, 1)
    np.testing.assert_array_equal(
        TI.center_crop_flat(torch.from_numpy(x), 28, 28, 3).numpy(),
        np.asarray(JI.center_crop_flat(jnp.asarray(x), 28, 28, 3)))
    y = _img(2, 28, 28, 2)
    np.testing.assert_array_equal(
        TI.patchify_flat(torch.from_numpy(y), 14, 3).numpy(),
        np.asarray(JI.patchify_flat(jnp.asarray(y), 14, 3)))
    np.testing.assert_array_equal(TI.patch_perm(14, 3), JI.patch_perm(14, 3))


@pytest.mark.parametrize("pad_square", [True, False])
def test_host_uint8_path_matches_pillow(pad_square):
    """Images that do not take the fp32 device path are padded (or resized
    by the shortest side and centre-cropped) and resized with Pillow's uint8
    pipeline, bit for bit (JAX package: media.images.load_batch)."""
    from t2v_metrics_tpu.media.images import load_batch
    from t2v_metrics_tpu_torch.engine.scoring import pillow_resize_batch

    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (41, 67, 3), dtype=np.uint8),
            rng.integers(0, 256, (90, 33, 3), dtype=np.uint8),
            rng.integers(0, 256, (41, 67, 3), dtype=np.uint8)]
    got = pillow_resize_batch(imgs, 56, pad_square, "cpu")
    want = load_batch(imgs, 56, pad_square=pad_square, raw_uint8=True)
    assert got.dtype == torch.uint8 and got.shape == (3, 56, 56 * 3)
    np.testing.assert_array_equal(got.numpy(), want.reshape(3, 56, 56 * 3))


def test_device_batch_only_for_same_shape_small_uint8():
    from t2v_metrics_tpu_torch.engine.scoring import _device_resize_batch

    a = np.zeros((30, 40, 3), np.uint8)
    assert _device_resize_batch([a, a.copy()], "cpu").shape == (2, 30, 120)
    assert _device_resize_batch([a, np.zeros((31, 40, 3), np.uint8)], "cpu") is None
    assert _device_resize_batch([np.zeros((500, 40, 3), np.uint8)], "cpu") is None
    assert _device_resize_batch(["x.png"], "cpu") is None


@pytest.mark.parametrize("hw", [(1024, 1024), (1024, 768)])
def test_host_resize_llava_size_matches_pillow(hw):
    """LLaVA's path and CLIP-FlanT5's for images over 384 px: expand2square
    with the CLIP-mean fill and Pillow's uint8 bicubic down to 336, bit for
    bit (JAX package: media.images.load_batch, Pillow)."""
    from t2v_metrics_tpu.media.images import load_batch
    from t2v_metrics_tpu_torch.engine.scoring import pillow_resize_batch

    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2)]
    got = pillow_resize_batch(imgs, 336, True, "cpu")
    want = load_batch(imgs, 336, pad_square=True, raw_uint8=True)
    assert got.shape == (2, 336, 336 * 3)
    np.testing.assert_array_equal(got.numpy(), want.reshape(2, 336, 336 * 3))


def test_pillow_fixed_point_resize_is_pillow_bit_for_bit():
    """``resize_uint8_pillow_flat`` (InternVL's tiles, Molmo2's 336 px) equals
    Pillow's uint8 bicubic at 120 random sizes, down- and upsampling (up to
    ~30x), and at the slices' sizes: 1024 -> 1344 and 300x380 -> 1344x1792
    (InternVL's tile grids), 480x640 -> 448 and 336 (video frames); an image
    at its own size passes through, a change of one side resizes only it."""
    from PIL import Image

    rng = np.random.default_rng(6)
    sizes = [tuple(int(v) for v in rng.integers(3, 90, 4)) for _ in range(120)]
    sizes += [(1024, 1024, 1344, 1344), (300, 380, 1344, 1792), (480, 640, 448, 448),
              (480, 640, 336, 336), (40, 40, 40, 40), (40, 30, 40, 77)]
    for h, w, oh, ow in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
        got = TI.resize_uint8_pillow_flat(torch.from_numpy(img.reshape(1, h, w * 3)), oh, ow, 3)
        assert got.dtype == torch.float32 and got.shape == (1, oh, ow * 3)
        np.testing.assert_array_equal(got[0].numpy(), want.reshape(oh, -1),
                                      err_msg=str((h, w, oh, ow)))
