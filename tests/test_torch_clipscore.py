"""Port parity: the CLIPScore slice (t2v_metrics_tpu_torch/models/clip.py text
tower, encoders and cosine matrix; engine/scoring.py:CLIPEngine; the
CLIPScore adapter, registry and facade) against the JAX package on the CPU,
with the JAX parameters carried over by ``bridge.py``.

Tolerances in fp32: 1e-4 on the text tower, ``encode_text`` and
``clip_scores``, as the vision tower test (the two CPU BLAS libraries sum the
tower's matmuls in different orders and the differences compound over the
layers); 1e-5 on the facades' cosine scores, which are normalised (the
towers' differences are ~1e-6 of a unit vector here). Images the facades
score are already at the model's size, so neither side resizes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import adapters as jadapters  # noqa: E402
from t2v_metrics_tpu.models import clip as jclip  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import adapters as tadapters  # noqa: E402
from t2v_metrics_tpu_torch.models import clip as tclip  # noqa: E402

TOL = 1e-4
SCORE_TOL = 1e-5
VISION = dict(image_size=32, patch_size=8, width=32, layers=2, heads=4, mlp_dim=64,
              proj_dim=24)
TEXT = dict(vocab_size=99, context_length=16, width=32, layers=2, heads=4, mlp_dim=64,
            proj_dim=24)
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


def _perturbed(tree, seed):
    """Random (nonzero) biases and norm parameters, so that the bridge's
    mapping of every leaf is exercised."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + rng.normal(size=np.shape(x)).astype(np.float32) * 0.05
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def models():
    jv, jt = jclip.CLIPVisionConfig(**VISION), jclip.CLIPTextConfig(**TEXT)
    tv, tt = tclip.CLIPVisionConfig(**VISION), tclip.CLIPTextConfig(**TEXT)
    jp = _perturbed(jclip.init_clip(jax.random.PRNGKey(0), jv, jt), 1)
    tp = bridge.clip_from_numpy(jp, (tv, tt), "cpu", torch.float32)
    return (jv, jt, jp), (tv, tt, tp)


def _ids(n, s, seed=3):
    """(n, s) ids with the EOT (the highest id, 98) at a random position and
    zeros after it."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, s), np.int32)
    for i in range(n):
        eot = int(rng.integers(2, s))
        ids[i, :eot] = rng.integers(3, 98, eot)
        ids[i, eot] = 98
    return ids


def test_text_tower_matches_jax(models):
    (jv, jt, jp), (tv, tt, tp) = models
    ids = _ids(5, TEXT["context_length"])
    want = np.asarray(jclip.text_tower(jp["text"], jt, jax.numpy.asarray(ids)))
    with torch.inference_mode():
        got = tclip.text_tower(tp.text, tt, torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (5, TEXT["proj_dim"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_encoders_and_clip_scores_match_jax(models):
    (jv, jt, jp), (tv, tt, tp) = models
    ids = _ids(4, TEXT["context_length"], seed=4)
    pixels = np.random.default_rng(5).normal(size=(3, 32, 32 * 3)).astype(np.float32)
    jx, jids = jax.numpy.asarray(pixels), jax.numpy.asarray(ids)
    with torch.inference_mode():
        tx, tids = torch.from_numpy(pixels), torch.from_numpy(ids).long()
        got_t = tclip.encode_text(tp, tt, tids).numpy()
        got_i = tclip.encode_image(tp, tv, tx).numpy()
        got = tclip.clip_scores(tp, tv, tt, tx, tids).numpy()
    np.testing.assert_allclose(np.linalg.norm(got_t, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got_t, np.asarray(jclip.encode_text(jp, jt, jids)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_i, np.asarray(jclip.encode_image(jp, jv, jx)),
                               atol=TOL, rtol=TOL)
    want = np.asarray(jclip.clip_scores(jp, jv, jt, jx, jids))
    assert got.shape == want.shape == (3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.ptp(want) > 100 * TOL     # the scores tell the pairs apart


def test_init_text_distributions():
    """init_text and init_clip draw with the JAX package's scales."""
    tv, tt = tclip.CLIPVisionConfig(**VISION), tclip.CLIPTextConfig(**TEXT)
    p = tclip.init_clip(tv, tt, 0, "cpu")
    t = p.text
    assert torch.equal(t.blocks[0].ln1.scale, torch.ones(32))
    assert torch.equal(t.blocks[1].qkv.b, torch.zeros(96))
    assert abs(p.logit_scale.item() - np.log(1 / 0.07)) < 1e-6
    for x, std in ((t.blocks[0].fc1.w, 32 ** -0.5), (t.blocks[0].fc2.w, 64 ** -0.5),
                   (t.tok_emb, 0.02), (t.pos_emb, 0.01), (t.proj, 32 ** -0.5)):
        assert abs(x.std().item() / std - 1) < 0.2


@pytest.fixture(scope="module")
def scorers(models):
    (jv, jt, jp), _ = models
    tok = SimpleT5Tokenizer(TEXT["vocab_size"])
    kw = dict(params=jp, tokenizer=tok, vision_config=jv, text_config=jt)
    j = jt2v.CLIPScore("clipscore-test", **kw)
    kw.update(vision_config=tclip.CLIPVisionConfig(**VISION),
              text_config=tclip.CLIPTextConfig(**TEXT))
    t = tt2v.CLIPScore("clipscore-test", device="cpu", dtype=torch.float32, **kw)
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    return j, t, images


def test_clipscore_facade_matches_jax(scorers):
    j, t, images = scorers
    want = j(images=images, texts=TEXTS)
    got = t(images=images, texts=TEXTS)
    assert got.shape == (3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    assert np.ptp(want) > 100 * SCORE_TOL


def test_pairwise_forward_and_batch_forward_match_jax(scorers):
    j, t, images = scorers
    imgs, texts = [images[0], images[2], images[0]], [TEXTS[0], TEXTS[1], TEXTS[0]]
    np.testing.assert_allclose(t.model.forward(imgs, texts), j.model.forward(imgs, texts),
                               atol=SCORE_TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(5)]
    got = t.batch_forward(data, batch_size=2)
    assert got.shape == (5, 1, 4)
    np.testing.assert_allclose(got, j.batch_forward(data, batch_size=2),
                               atol=SCORE_TOL, rtol=0)


def test_forward_pairwise_encodes_each_image_and_text_once(scorers, monkeypatch):
    """A batch_forward chunk repeats each image over its texts: the engine
    encodes the 2 distinct images and 3 distinct texts once each (in their
    buckets), and each pair reads its own entry of the matrix."""
    _, t, images = scorers
    seen = {"image": [], "text": []}
    enc_i, enc_t = tclip.encode_image, tclip.encode_text

    def spy(kind, fn):
        def wrapped(params, cfg, x, *a, **k):
            seen[kind].append(x.shape[0])
            return fn(params, cfg, x, *a, **k)
        return wrapped

    monkeypatch.setattr(tclip, "encode_image", spy("image", enc_i))
    monkeypatch.setattr(tclip, "encode_text", spy("text", enc_t))
    imgs = [images[0]] * 3 + [images[1]] * 3
    texts = TEXTS[:3] * 2
    got = t.model.forward(imgs, texts)
    assert seen == {"image": [2], "text": [4]}      # 2 images; 3 texts in bucket 4
    monkeypatch.undo()
    full = t.model.score_matrix(images[:2], TEXTS[:3])
    np.testing.assert_array_equal(got, full.ravel())


@pytest.mark.parametrize("name", ["openai:ViT-B-32", "laion2b_s34b_b79k:ViT-B-32",
                                  "datacomp:ViT-L-14-336", "openai:ViT-H-14",
                                  "ViT-B-32", "clipscore-test", "blip2-itm"])
def test_resolve_clipscore_name_matches_jax(name):
    assert tadapters.resolve_clipscore_name(name) == jadapters.resolve_clipscore_name(name)


def test_dynamic_openclip_name_builds_its_architecture():
    """A ``pretrain_tag:Arch`` name outside the registry builds (here with
    tiny configs over the arch's); an unknown arch is refused, as in JAX."""
    tv, tt = tclip.CLIPVisionConfig(**VISION), tclip.CLIPTextConfig(**TEXT)
    s = tt2v.CLIPScore("laion2b_s34b_b79k:ViT-B-32", device="cpu", init="random",
                       vision_config=tv, text_config=tt)
    assert isinstance(s.model, tadapters.CLIPScoreAdapter)
    assert s.model.vcfg is tv and len(s.model.engine.params.text.blocks) == 2
    with pytest.raises(AssertionError):
        tt2v.CLIPScore("laion2b:ViT-H-14", device="cpu", init="random")


def test_model_lists_equal_the_jax_package():
    assert tt2v.list_all_clipscore_models() == jt2v.list_all_clipscore_models()
    assert tt2v.list_all_itmscore_models() == jt2v.list_all_itmscore_models()
    # every VQAScore model of the port is one of the JAX package's, in order
    jvqa = jt2v.list_all_vqascore_models()
    port = tt2v.list_all_vqascore_models()
    assert [m for m in jvqa if m in port] == port
    assert tt2v.list_all_models() == (port + jt2v.list_all_clipscore_models()
                                      + jt2v.list_all_itmscore_models())
    assert set(tt2v.list_all_models()) <= set(jt2v.list_all_models())


@pytest.mark.parametrize("name,facade", [("clipscore-test", "CLIPScore"),
                                         ("blip2-itm-test", "ITMScore"),
                                         ("clip-flant5-test", "VQAScore")])
def test_get_score_model_picks_the_jax_packages_facade(name, facade):
    s = tt2v.get_score_model(name, device="cpu", init="random")
    assert type(s).__name__ == facade
    assert type(jt2v.get_score_model(name, init="random")).__name__ == facade
    with pytest.raises(ValueError, match="unknown model"):
        tt2v.get_score_model("no-such-model", device="cpu")


def test_video_concat_matches_jax(scorers):
    """A video is scored as its frames side by side in one image
    (``video_mode = "concat"``): two 128x96 frames give a 266-pixel-wide
    image, which both engines resize on their device path."""
    pytest.importorskip("cv2")
    j, t, _ = scorers
    video = "_test_assets/vid.mp4"
    assert t.model.video_mode == "concat"
    want = j(images=[video], texts=TEXTS, num_frames=2)
    got = t(images=[video], texts=TEXTS, num_frames=2)
    assert got.shape == (1, 4)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("facade,name", [("CLIPScore", "clipscore-test"),
                                         ("ITMScore", "blip2-itm-test")])
def test_entry_points_need_a_gpu(facade, name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tt2v, facade)(name, init="random")
