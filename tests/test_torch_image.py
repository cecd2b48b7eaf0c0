"""Port parity: image preprocessing (t2v_metrics_tpu_torch/ops/image.py and
the engine's device and host preprocess) against the JAX package on the CPU.

Tolerance 2e-5 on [0, 1] pixels in fp32 (same coefficients, different
matmul summation order); the host uint8 path may differ from Pillow by one
level where a value sits on a rounding boundary.
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


def test_host_uint8_path_matches_pillow():
    """Images that do not take the device path are padded and resized on the
    host with Pillow's uint8 pipeline (JAX package: media.images.load_batch)."""
    from t2v_metrics_tpu.media.images import load_batch
    from t2v_metrics_tpu_torch.engine.scoring import _host_resize_batch

    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (41, 67, 3), dtype=np.uint8),
            rng.integers(0, 256, (90, 33, 3), dtype=np.uint8)]
    got = _host_resize_batch(imgs, 56, pad_square=True)
    want = load_batch(imgs, 56, pad_square=True, raw_uint8=True)
    assert got.shape == (2, 56, 56 * 3)
    diff = np.abs(got.astype(int) - want.reshape(2, 56, 56 * 3).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_device_batch_only_for_same_shape_small_uint8():
    from t2v_metrics_tpu_torch.engine.scoring import _device_resize_batch

    a = np.zeros((30, 40, 3), np.uint8)
    assert _device_resize_batch([a, a.copy()]).shape == (2, 30, 120)
    assert _device_resize_batch([a, np.zeros((31, 40, 3), np.uint8)]) is None
    assert _device_resize_batch([np.zeros((500, 40, 3), np.uint8)]) is None
    assert _device_resize_batch(["x.png"]) is None
