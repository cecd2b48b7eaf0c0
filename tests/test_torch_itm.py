"""Port parity: the ITMScore slice (t2v_metrics_tpu_torch/models/blip2_itm.py:
the EVA tower, the Q-Former and ``itm_scores``; models/itm_adapter.py; the
registry and the ``ITMScore`` facade) against the JAX package on the CPU,
with the JAX parameters carried over by ``bridge.py``.

Tolerances in fp32: 1e-4 on the towers (the EVA tower and the Q-Former; the
two CPU BLAS libraries sum in different orders and the differences compound
over the layers), 1e-5 on P(match), a softmax of the averaged ITM logits.
Images the facades score are already at the model's size, so the device
resize passes them through exactly; the resize itself is held against
Pillow bit for bit (``resize_uint8_pillow_flat``: Pillow's fixed-point
coefficients).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import blip2_itm as jbitm  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import blip2_itm as tbitm  # noqa: E402
from t2v_metrics_tpu_torch.models import itm_adapter  # noqa: E402
from t2v_metrics_tpu_torch.ops.image import resize_uint8_pillow_flat  # noqa: E402

TOL = 1e-4
P_TOL = 1e-5
NAME = "blip2-itm-test"
IMG = 28
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


@pytest.fixture(scope="module")
def models():
    jcfg = jbitm.BLIP2_ITM_MODELS[NAME]["config"]
    tcfg = tbitm.BLIP2_ITM_MODELS[NAME]["config"]
    jp = jbitm.init_blip2_itm(jax.random.PRNGKey(0), jcfg)
    # random (nonzero) biases and norm parameters, so that the bridge's
    # mapping of every leaf is exercised; larger weights spread P(match)
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) * np.float32(2.0 if np.ndim(x) == 2 else 1.0)
              + rng.normal(size=np.shape(x)).astype(np.float32) * 0.05 for x in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    tp = bridge.blip2_itm_from_numpy(jp, tcfg, "cpu", torch.float32)
    return jcfg, jp, tcfg, tp


def test_vision_tower_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    px = np.random.default_rng(2).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jbitm.vision_tower(jp["vision"], jcfg.vision, jnp.asarray(px)))
    with torch.inference_mode():
        got = tbitm.vision_tower(tp.vision, tcfg.vision,
                                 torch.from_numpy(px.reshape(3, IMG, IMG * 3))).numpy()
    assert got.shape == want.shape == (3, 1 + tcfg.vision.num_patches, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_qformer_matches_jax(models):
    """Self-attention over 4 queries + 6 text tokens under the text mask,
    cross-attention (layer 0) from the queries to 5 image rows."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(2, 10, 32)).astype(np.float32)
    image = rng.normal(size=(2, 5, 32)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False
    want = np.asarray(jbitm.qformer(jp["qformer"], jcfg.qformer, jnp.asarray(embeds),
                                    jnp.asarray(mask), jnp.asarray(image), 4))
    with torch.inference_mode():
        got = tbitm.qformer(tp.qformer, tcfg.qformer, torch.from_numpy(embeds),
                            torch.from_numpy(mask), torch.from_numpy(image), 4).numpy()
    assert got.shape == want.shape == (2, 10, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_itm_scores_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(4)
    px = rng.normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    ids = np.array([[5, 7, 8, 9, 1, 0, 0], [5, 12, 13, 1, 0, 0, 0], [5, 20, 21, 22, 23, 24, 1]])
    mask = ids != 0
    want = np.asarray(jbitm.itm_scores(jp, jcfg, jnp.asarray(px), jnp.asarray(ids),
                                       jnp.asarray(mask)))
    with torch.inference_mode():
        got = tbitm.itm_scores(tp, tcfg, torch.from_numpy(px.reshape(3, IMG, IMG * 3)),
                               torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)
    assert np.ptp(want) > 100 * P_TOL


def test_init_distributions():
    cfg = tbitm.BLIP2_ITM_MODELS[NAME]["config"]
    p = tbitm.init_blip2_itm(cfg, 0, "cpu")
    layer = p.qformer.layers[0]
    assert layer.cross is not None and p.qformer.layers[1].cross is None
    assert torch.equal(layer.self_attn.ln.scale, torch.ones(32))
    assert torch.equal(p.vision.blocks[0].qkv.b, torch.zeros(96))
    for x, std in ((p.vision.blocks[0].fc1.w, 32 ** -0.5), (layer.cross.kv.w, 32 ** -0.5),
                   (layer.ffn_query.fc2.w, 64 ** -0.5), (p.qformer.word_emb, 0.02),
                   (p.vision.patch_w, 588 ** -0.5)):
        assert abs(x.std().item() / std - 1) < 0.2


@pytest.fixture(scope="module")
def scorers(models):
    jcfg, jp, tcfg, _ = models
    tok = SimpleT5Tokenizer(tcfg.qformer.vocab_size)
    j = jt2v.ITMScore(NAME, params=jp, tokenizer=tok)
    t = tt2v.ITMScore(NAME, params=jp, tokenizer=tok, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(3)]
    return j, t, images


def test_itmscore_facade_matches_jax(scorers):
    j, t, images = scorers
    want = j(images=images, texts=TEXTS)
    got = t(images=images, texts=TEXTS)
    assert got.shape == (3, 4) and got.dtype == np.float32
    assert np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)
    assert np.ptp(want) > 100 * P_TOL


def test_pairwise_forward_and_batch_forward_match_jax(scorers):
    j, t, images = scorers
    imgs, texts = [images[0], images[2], images[0]], TEXTS[:3]
    np.testing.assert_allclose(t.model.forward(imgs, texts), j.model.forward(imgs, texts),
                               atol=P_TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(5)]
    got = t.batch_forward(data, batch_size=2)
    assert got.shape == (5, 1, 4)
    np.testing.assert_allclose(got, j.batch_forward(data, batch_size=2), atol=P_TOL, rtol=0)


def test_tower_runs_once_per_distinct_image(scorers, monkeypatch):
    """The JAX adapter runs the tower once per pair; the port once per
    distinct image (one call per same-shape group), with the same scores."""
    _, t, images = scorers
    calls = []
    tower = tbitm.vision_tower

    def spy(p, cfg, pixels):
        calls.append(pixels.shape[0])
        return tower(p, cfg, pixels)

    monkeypatch.setattr(tbitm, "vision_tower", spy)
    odd = np.random.default_rng(6).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    got = t(images=[images[0], images[1], odd], texts=TEXTS)
    assert sorted(calls) == [1, 2]         # 12 pairs: 2 same-shape images + 1 other
    monkeypatch.undo()
    for i, img in enumerate([images[0], images[1], odd]):
        np.testing.assert_allclose(got[i], t(images=[img], texts=TEXTS)[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(40, 50), (300, 380), (28, 28), (17, 9)])
def test_preprocess_within_one_level_of_pillow(shape):
    """The device resize against Pillow's BICUBIC on uint8 (what the JAX
    adapter runs on the host): equal bit for bit; the normalisation is the
    JAX adapter's."""
    from PIL import Image

    img = np.random.default_rng(7).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((IMG, IMG), Image.BICUBIC), np.float32)
    flat = torch.from_numpy(img.reshape(1, shape[0], shape[1] * 3))
    got = resize_uint8_pillow_flat(flat, IMG, IMG, 3)[0].numpy().reshape(IMG, IMG, 3)
    np.testing.assert_array_equal(got, want)
    mean, std = np.asarray(jt2v.constants.CLIP_MEAN), np.asarray(jt2v.constants.CLIP_STD)
    norm = itm_adapter.itm_preprocess(flat, IMG)[0].numpy()
    np.testing.assert_allclose(norm.reshape(IMG, IMG, 3), (got / 255.0 - mean) / std,
                               atol=1e-6, rtol=0)


def test_video_is_scored_as_concatenated_frames(scorers):
    """``video_mode = "concat"``: a video path scores as its frames side by
    side in one image."""
    pytest.importorskip("cv2")
    from t2v_metrics_tpu_torch.media.video import concatenate_horizontal, extract_frames

    _, t, _ = scorers
    video = "_test_assets/vid.mp4"
    assert t.model.video_mode == "concat"
    frames = concatenate_horizontal(extract_frames(video, 4, mode="step"), dist=10)
    np.testing.assert_array_equal(t(images=[video], texts=TEXTS, num_frames=4),
                                  t(images=[frames], texts=TEXTS))


def test_unknown_itm_model_is_refused():
    with pytest.raises(AssertionError):
        tt2v.ITMScore("blip2-itm-xl", device="cpu", init="random")
    with pytest.raises(ValueError, match="unknown ITMScore model"):
        from t2v_metrics_tpu_torch.registry import get_itmscore_model

        get_itmscore_model("blip2-itm-xl", device="cpu")
