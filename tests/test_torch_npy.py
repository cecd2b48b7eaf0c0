"""Port parity: ``.npy`` image paths. The port's one image loader
(``engine/scoring.py:_load_uint8``, behind every local image adapter) reads
a path ending in ``.npy`` as the JAX package's ``media.images.image_loader``
does: a BGR array flipped to RGB and, unless uint8, clipped to [0, 255] and
truncated to uint8. It needs no Pillow.

Tolerances: pixels and scores are compared exactly.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu.media.images import image_loader  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu_torch.engine.scoring import _load_uint8  # noqa: E402
from t2v_metrics_tpu_torch.media.video import MediaError  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEXTS = ["a red cube on a table", "two dogs"]
_SCORERS = {}


def _bgr(seed, h, w, dtype):
    """A seeded BGR image; float ones reach past [0, 255] on both sides."""
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng.uniform(-20.0, 280.0, (h, w, 3)).astype(dtype)


@pytest.mark.parametrize("as_path", [False, True], ids=["str", "pathlib"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64],
                         ids=["float32", "uint8", "float64"])
def test_npy_path_loads_as_the_jax_loader(tmp_path, dtype, as_path):
    arr = _bgr(0, 9, 13, dtype)
    path = tmp_path / "img.npy"
    np.save(path, arr)
    path = path if as_path else str(path)
    got, want = _load_uint8(path), image_loader(path)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)
    # truncation, not rounding, and the flip of the channels
    np.testing.assert_array_equal(got, np.clip(arr[:, :, ::-1], 0, 255).astype(np.uint8))


def test_unreadable_npy_raises_media_error(tmp_path):
    """A missing ``.npy``, one that is not an array and one that is not HWC
    raise ``MediaError`` naming the path."""
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not an array")
    flat = tmp_path / "flat.npy"
    np.save(flat, np.zeros((4, 4), np.float32))
    for path in (tmp_path / "missing.npy", str(bad), flat):
        with pytest.raises(MediaError, match=str(path).replace(".", r"\.")):
            _load_uint8(path)


def test_npy_scoring_loads_no_pillow(tmp_path):
    """Scoring a ``.npy`` path on clip-flant5-test leaves PIL out of
    sys.modules: the route needs no Pillow."""
    path = tmp_path / "img.npy"
    np.save(path, _bgr(1, 40, 52, np.float32))
    code = (
        "import sys, numpy as np\n"
        "import t2v_metrics_tpu_torch as t\n"
        "s = t.VQAScore('clip-flant5-test', device='cpu')\n"
        f"assert np.isfinite(s(images=[{str(path)!r}], texts=['a photo'])).all()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'PIL'))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout[-2000:]


def scorer(name):
    if name not in _SCORERS:
        _SCORERS[name] = tt2v.VQAScore(name, device="cpu")
    return _SCORERS[name]


@pytest.mark.parametrize("name,hw,as_array", [
    ("clip-flant5-test", (400, 392), "loader"),
    ("clip-flant5-test", (30, 38), "clipped"),
    ("qwen2.5-vl-test", (30, 38), "loader"),
    ("qwen2.5-vl-test", (30, 38), "clipped"),
])
def test_npy_path_scores_as_its_array(tmp_path, name, hw, as_array):
    """``VQAScore`` scores ``.npy`` paths exactly as the same images given
    as arrays: the JAX loader's uint8 arrays, or the flipped and clipped
    float arrays, which the engine truncates to uint8. CLIP-FlanT5 sends
    same-shape uint8 arrays of at most 384 px through its float device
    resize and every other image through Pillow's exact resize (as the JAX
    engine does), so its uint8 case is above 384 px and its small case
    passes float arrays."""
    bgrs = [_bgr(10 + i, *hw, np.float32) for i in range(2)]
    paths = []
    for i, bgr in enumerate(bgrs):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], bgr)
    arrays = ([image_loader(p) for p in paths] if as_array == "loader"
              else [np.clip(b[:, :, [2, 1, 0]], 0, 255) for b in bgrs])
    s = scorer(name)
    by_path = s(images=paths, texts=TEXTS)
    assert by_path.shape == (2, 2) and np.isfinite(by_path).all()
    np.testing.assert_array_equal(by_path, s(images=arrays, texts=TEXTS))
