"""Port parity: Molmo2 — the registry, ``image_features`` (CLIP at feature
layer -2, the k x k mean pool, the GELU connector), ``VQAScore("molmo2-test")``
rollout scores (the batched rollout for more than one pair, the
per-sequence one for a single pair, the end alignment with a special last
token), ``score_matrix``, ``batch_forward``, ``generate`` (greedy batched;
sampled per sequence with a numpy seed), ``vid.mp4`` and its
``DecodedVideo`` — against the JAX package on the same parameters (carried
over by ``bridge.py``), the same tokenizer instance and the same seeded
uint8 inputs; the batched rollout against the per-sequence one; the
checkpoint paths (a native tree whose dims are adopted; the dims guard).

No public HF implementation of Molmo2 exists (``models/molmo2.py``), so
there is no HF parity here. Tolerances (fp32): 1e-5 on features and log
scores (the resize to 336 px is Pillow's bit for bit in both packages);
strings equal (the tokenizer spells ids, so equal strings are equal
tokens).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import molmo2 as jm2  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.media.video import DecodedVideo, extract_frames  # noqa: E402
from t2v_metrics_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from t2v_metrics_tpu_torch.models import molmo2 as tm2  # noqa: E402
from t2v_metrics_tpu_torch.models.generation import score_rollout  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-5
NAME = "molmo2-test"
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
VID = "_test_assets/vid.mp4"
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(cfg=None):
    """Numpy parameters in the JAX layout: matrices x 2, vectors moved off
    their init by N(0, 0.1)."""
    cfg = cfg or jm2.MOLMO2_MODELS[NAME]["config"]
    if cfg not in _PARAMS:
        jp = jm2.init_molmo2(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(0)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[cfg] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[cfg]


def _images(seed, n=2, hw=(28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _scorers(tok=None):
    tok = tok or IdTokenizer(512)
    return (jt2v.VQAScore(NAME, params=_params(), tokenizer=tok),
            tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)


def test_registry_matches_jax():
    assert list(tm2.MOLMO2_MODELS) == list(jm2.MOLMO2_MODELS)
    for name, spec in jm2.MOLMO2_MODELS.items():
        got = tm2.MOLMO2_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
        assert got["config"].tokens_per_image == spec["config"].tokens_per_image
    assert tm2.NATIVE_VIDEO_FRAMES == jm2.NATIVE_VIDEO_FRAMES
    cfg = tm2.MOLMO2_MODELS["molmo2-4b"]["config"]
    assert (cfg.tokens_per_image, cfg.text.head_dim, cfg.text.kv_heads) == (144, 80, 8)


@pytest.mark.parametrize("pool", [1, 2])
def test_image_features_match_jax(pool):
    """At 56 px (a 4x4 patch grid): pool 2 averages each 2x2 block."""
    cfg = jm2.MOLMO2_MODELS[NAME]["config"]
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, image_size=56),
                              pool=pool)
    tcfg = tm2.MOLMO2_MODELS[NAME]["config"]
    tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, image_size=56),
                               pool=pool)
    params = _params(cfg)
    px = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jm2.image_features(params, cfg, jnp.asarray(px)))
    model = bridge.molmo2_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tm2.image_features(model, tcfg, torch.from_numpy(px.reshape(2, 56, -1)))
    assert got.shape == (2, 16 // pool ** 2, cfg.text.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("path", ["batched", "per_sequence"])
def test_rollout_scores_match_jax(path):
    """More than one pair takes the batched rollout, one pair the
    per-sequence one; images at 28 px and resized from 40x60."""
    j, t = _scorers()
    images = _images(1, 2) + _images(2, 1, (40, 60))
    if path == "batched":
        want = j(images=images, texts=TEXTS)
        before = launch_counts()
        got = t(images=images, texts=TEXTS)
        assert launch_counts() == before             # the CPU runs no kernel
        assert got.shape == (3, 3)
    else:
        want = np.stack([j(images=[im], texts=[TEXTS[1]]) for im in images])
        got = np.stack([t(images=[im], texts=[TEXTS[1]]) for im in images])
    assert np.all((got >= 0) & (got <= 1))
    _close(got, want)
    assert np.ptp(np.log(want)) > 100 * TOL


def test_batched_rollout_equals_sequential_and_special_offset():
    """Over 4 steps: the batched rollout's scores equal the per-sequence
    ones; with the last generated id special, both score one step earlier,
    as the JAX package does."""
    tok = IdTokenizer(512)
    j, t = _scorers(tok)
    images = _images(3, 3)
    batched = t.model.forward(images, TEXTS, max_new_tokens=4)
    single = np.concatenate([t.model.forward([im], [tx], max_new_tokens=4)
                             for im, tx in zip(images, TEXTS)])
    _close(batched, single)
    _close(batched, j.model.forward(images, TEXTS, max_new_tokens=4))
    q = 'Does this figure show "{}"? Please answer Yes or No.'.format(TEXTS[0])
    gen, dists = t.model._rollout(images[0], q, 4)
    assert len(gen) == 4
    tok.pad_token_id = gen[-1]
    assert gen[-1] in t.model._special_ids()
    want, got = j.model.forward(images, TEXTS, max_new_tokens=4), \
        t.model.forward(images, TEXTS, max_new_tokens=4)
    _close(got, want)
    ans = t.model._encode_text("Yes")
    shifted = score_rollout(dists, gen, ans, t.model._special_ids())
    assert abs(np.log(got[0]) - np.log(shifted)) <= TOL
    assert abs(np.log(shifted) - np.log(score_rollout(dists, gen, ans, {1}))) > 100 * TOL


def test_score_matrix_and_batch_forward():
    j, t = _scorers()
    images = _images(4, 2)
    _close(t.model.score_matrix(images, TEXTS), j.model.score_matrix(images, TEXTS))
    data = [{"images": [images[i % 2]], "texts": TEXTS[:2]} for i in range(3)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (3, 1, 2)
    for i in range(3):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 2]], texts=TEXTS[:2])[0],
                                   atol=1e-7, rtol=1e-5)


def test_generate_matches_jax():
    """Greedy: one batched decode in both packages; sampled: one sequence at
    a time with the same numpy seed (the JAX adapter draws from
    np.random.default_rng)."""
    j, t = _scorers()
    images = _images(5, 2)
    texts = ["describe", "what is on the table"]
    want = j.model.generate(images, texts, max_new_tokens=6)
    assert t.model.generate(images, texts, max_new_tokens=6) == want
    assert t.model.generate(images[:1], texts[:1], max_new_tokens=6) == want[:1]
    kw = dict(max_new_tokens=6, temperature=1.5)
    with mock.patch("numpy.random.default_rng", lambda *a: np.random.Generator(
            np.random.PCG64(3))):
        want = j.model.generate(images[:1], texts[:1], **kw)
    assert t.model.generate(images[:1], texts[:1], rng=np.random.Generator(np.random.PCG64(3)),
                            **kw) == want


def test_video_matches_jax():
    """vid.mp4 (20 frames of 96x128): 8 linspace frames resized to 28 px;
    its ``DecodedVideo`` scores as the file; load_images passes videos
    through (native video)."""
    j, t = _scorers()
    want = j(images=[VID], texts=TEXTS)
    got = t(images=[VID], texts=TEXTS)
    _close(got, want)
    decoded = DecodedVideo(np.stack(extract_frames(VID, 1000, mode="linspace")), 10.0)
    np.testing.assert_array_equal(t(images=[decoded], texts=TEXTS), got)
    _close(t.model.forward([VID], TEXTS[:1]), j.model.forward([VID], TEXTS[:1]))
    assert t.model.load_images([VID]) == [VID]
    assert t.model._encode_visuals([decoded])[0].shape[0] == 8 * 4
    want = j.model.generate([VID, _images(6, 1)[0]], ["describe", "a"], max_new_tokens=5)
    assert t.model.generate([decoded, _images(6, 1)[0]], ["describe", "a"],
                            max_new_tokens=5) == want


def test_checkpoints_and_entry_points(tmp_path):
    """A native tree of other dims is adopted (with a warning); a misshapen
    one is refused with each leaf named; a directory that is not a native
    tree raises; without weights the registry models raise, as the JAX
    adapter does."""
    tree = jax.tree.map(np.asarray, jm2.init_molmo2(jax.random.PRNGKey(3),
                                                    jm2.MOLMO2_MODELS[NAME]["config"]))
    tree["decoder"]["blocks"] = tree["decoder"]["blocks"][:1]
    ckpt.save_params(tree, str(tmp_path / "native"))
    with pytest.warns(UserWarning, match="text.layers 2 -> 1"):
        s = tt2v.VQAScore(NAME, checkpoint=str(tmp_path / "native"), device="cpu",
                          tokenizer=IdTokenizer(512))
    assert s.model.config.text.layers == 1 and len(s.model.params.decoder.blocks) == 1
    assert s(images=_images(7, 1), texts=["a"]).shape == (1, 1)
    bad = jax.tree.map(np.asarray, jm2.init_molmo2(jax.random.PRNGKey(3),
                                                   jm2.MOLMO2_MODELS[NAME]["config"]))
    bad["connector"]["fc1"] = {"w": np.zeros((7, 7), np.float32),
                               "b": np.zeros((7,), np.float32)}
    del bad["decoder"]["blocks"][0]["attn"]["q_norm"]
    ckpt.save_params(bad, str(tmp_path / "bad"))
    with pytest.raises(ValueError) as ei:
        tt2v.VQAScore(NAME, checkpoint=str(tmp_path / "bad"), device="cpu")
    msg = str(ei.value)
    assert "shape mismatch" in msg and "connector/fc1/w" in msg
    assert "missing" in msg and "q_norm" in msg and "PROVISIONAL" in msg
    (tmp_path / "hf").mkdir()
    with pytest.raises(ckpt.CheckpointError, match="manifest.json"):
        tt2v.VQAScore(NAME, checkpoint=str(tmp_path / "hf"), device="cpu")
    with pytest.raises(RuntimeError, match="no public HF implementation"):
        tt2v.VQAScore("molmo2-8b", device="cpu")
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("molmo2-8b", init="random")
    m = tm2.init_molmo2(tm2.MOLMO2_MODELS[NAME]["config"], 0, "cpu")
    assert torch.equal(m.connector.fc1.b, torch.zeros(48))
    assert torch.equal(m.decoder.blocks[0].q_norm.scale, torch.ones(16))
