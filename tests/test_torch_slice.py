"""Port parity: the clip-flant5 VQAScore slice end to end — the port's
``VQAScore("clip-flant5-test")`` against ``t2v_metrics_tpu.VQAScore`` on the
same parameters (carried over by ``bridge.py``), the same tokenizer instance
(its vocabulary is built on the fly) and the same seeded uint8 images.

Tolerance 1e-4 on mean answer log-probs (log of the scores) in fp32: the two
CPU BLAS libraries sum in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-4
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


@pytest.fixture(scope="module")
def scorers():
    cfg = J_MODELS["clip-flant5-test"]["config"]
    jp = jcft5.init_clip_t5(jax.random.PRNGKey(0), cfg)
    # widen the score spread past the near-uniform random-init logits
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(x) * np.float32(4.0) if np.ndim(x) == 2 else np.asarray(x)
              for x in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
    j = jt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok)
    t = tt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok, device="cpu")
    images = [rng.integers(0, 256, (30, 38, 3), dtype=np.uint8) for _ in range(3)]
    return j, t, images


def test_score_matrix_matches_jax(scorers):
    j, t, images = scorers
    want = j(images=images, texts=TEXTS)
    got = t(images=images, texts=TEXTS)
    assert got.shape == (3, 4) and got.dtype == np.float32
    assert np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    # the scores do tell pairs apart, so agreement is not trivial
    assert np.ptp(np.log(want)) > 100 * TOL


def test_pairwise_forward_matches_jax(scorers):
    j, t, images = scorers
    imgs = [images[0], images[2], images[0]]
    texts = TEXTS[:3]
    want = j.model.forward(imgs, texts)
    got = t.model.forward(imgs, texts)
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)


def test_batch_forward_rows_equal_forward(scorers):
    _, t, images = scorers
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(5)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (5, 1, 4)
    for i in range(5):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 3]], texts=TEXTS)[0],
                                   atol=1e-6, rtol=1e-5)


def test_image_features_and_score_pairs_match_jax(scorers):
    """The slice below the engine: projected features and per-pair log-probs."""
    j, t, images = scorers
    pixels = np.random.default_rng(4).normal(size=(2, 56, 168)).astype(np.float32)
    jparams, cfg = j.model.engine.params, j.model.config
    tparams, tcfg = t.model.engine.params, t.model.config
    want = np.asarray(jcft5.image_features(jparams, cfg, pixels))
    from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5

    with torch.inference_mode():
        got = tcft5.image_features(tparams, tcfg, torch.from_numpy(pixels))
    # features are O(100) under the widened weights: the bound is relative
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(),
                               rtol=TOL)


def test_cpu_run_launches_no_kernel(scorers):
    _, t, images = scorers
    before = launch_counts()
    t(images=images[:1], texts=TEXTS[:1])
    assert launch_counts() == before


def test_path_input_scores(scorers, tmp_path):
    """A path decodes with PIL and takes the host resize path."""
    from PIL import Image

    _, t, images = scorers
    path = str(tmp_path / "img.png")
    Image.fromarray(images[1]).save(path)
    got = t(images=[path], texts=TEXTS[:2])
    ref = t(images=[images[1]], texts=TEXTS[:2])
    assert got.shape == (1, 2) and np.all(np.isfinite(got))
    # host uint8 resize vs device float resize of the same pixels
    np.testing.assert_allclose(np.log(got), np.log(ref), atol=5e-2, rtol=0)


def test_unported_options_raise(tmp_path, monkeypatch):
    from t2v_metrics_tpu_torch.models.checkpoint import CheckpointError

    with pytest.raises(ValueError):   # int8 and int8+vit are ported; no other mode
        tt2v.VQAScore("clip-flant5-test", device="cpu", quant="int4")
    for var in ("HF_HUB_CACHE", "HF_HOME", "HOME", "T2V_TPU_CACHE"):
        monkeypatch.setenv(var, str(tmp_path / var))    # empty local caches
    with pytest.raises(CheckpointError, match="never downloads"):
        tt2v.VQAScore("clip-flant5-xl", device="cpu")  # pretrained weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt2v.VQAScore("clip-flant5-test", device="cuda")
