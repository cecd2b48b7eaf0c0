"""Port parity: InternVL 3 / 3.5 — the registry, the ``internvl2_5``
conversation, the tile grid (the reference's tie rule over a sweep of
sizes), the tiles against the JAX package's Pillow tiles, ``pixel_shuffle``,
``image_features`` (the 300M LayerNorm tower with packed q|k|v, the 6B-style
RMSNorm tower with q / k normalized over the whole width), ``splice_and_score``,
``VQAScore`` scores, ``score_matrix``, ``batch_forward``, ``generate``
(batched, per sequence, a video's frame blocks) and ``vid.mp4`` — at
``internvl3-test`` (Qwen2.5 backbone), ``internvl3.5-test`` (Qwen3) and
``internvl3.5-moe-test`` (the 6B-style tower, a MoE backbone), against the
JAX package on the same parameters (carried over by ``bridge.py``), the
same tokenizer instance and the same seeded uint8 inputs. The HF cases
(``InternVLForConditionalGeneration`` through ``checkpoint=``) are in
``tests/test_torch_hf_parity.py``.

Tolerances (fp32): tiles equal to the JAX package's (Pillow's) bit for bit
(``ops/image.py:resize_uint8_pillow_flat``); 1e-5 on features and log
scores, with or without a resize; ``generate`` strings equal (the tokenizer
spells ids, so equal strings are equal tokens).
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
from t2v_metrics_tpu.models import fastchat_utils as jfc  # noqa: E402
from t2v_metrics_tpu.models import internvl as jivl  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.media.video import DecodedVideo  # noqa: E402
from t2v_metrics_tpu_torch.models import fastchat_utils as tfc  # noqa: E402
from t2v_metrics_tpu_torch.models import internvl as tivl  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-5
NAMES = ["internvl3-test", "internvl3.5-test", "internvl3.5-moe-test"]
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
VID = "_test_assets/vid.mp4"
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(name, cfg=None):
    """Numpy parameters in the JAX layout: matrices x 2 (wider logits),
    vectors moved off their init by N(0, 0.1)."""
    key = (name, cfg)
    if key not in _PARAMS:
        cfg = cfg or jivl.INTERNVL_MODELS[name]["config"]
        jp = jivl.init_internvl(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(0)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[key] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[key]


def _images(seed, n=2, hw=(28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _scorers(name, tok=None):
    tok = tok or IdTokenizer(512)
    return (jt2v.VQAScore(name, params=_params(name), tokenizer=tok),
            tt2v.VQAScore(name, params=_params(name), tokenizer=tok, device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(np.log(got), np.log(want), atol=tol, rtol=0)


def test_registry_matches_jax():
    assert list(tivl.INTERNVL_MODELS) == list(jivl.INTERNVL_MODELS)
    for name, spec in jivl.INTERNVL_MODELS.items():
        got = tivl.INTERNVL_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
        assert got["config"].tokens_per_tile == spec["config"].tokens_per_tile
    cfg = tivl.INTERNVL_MODELS["internvl3.5-38b"]["config"]
    assert (cfg.vision.width, cfg.vision.heads, cfg.vision.qk_norm, cfg.vision.norm_type,
            cfg.tokens_per_tile) == (3200, 25, True, "rms", 256)


def test_conversation_templates_match_jax():
    """The four templates give the JAX package's prompts; ``internvl2_5``'s
    system message is not ASCII, and a copy leaves the registered one as
    it was."""
    for name in jfc.conv_templates:
        t, j = tfc.get_conv_template(name), jfc.get_conv_template(name)
        for conv in (t, j):
            conv.append_message(conv.roles[0], "<image>\nIs this a cat?")
            conv.append_message(conv.roles[1], None)
        assert t.get_prompt() == j.get_prompt(), name
        assert (t.sep, t.sep2, t.stop_str, t.roles) == (j.sep, j.sep2, j.stop_str, j.roles)
    assert list(tfc.conv_templates) == list(jfc.conv_templates)
    assert not tfc.get_conv_template("internvl2_5").system_message.isascii()
    assert tfc.get_conv_template("internvl2_5").messages == []
    for style in ("ADD_COLON_SINGLE", "ADD_COLON_TWO", "NO_COLON_SINGLE"):
        kw = dict(name="x", system_message="sys", sep="\n", sep2="</s>",
                  roles=("U", "A"))
        t = tfc.Conversation(sep_style=tfc.SeparatorStyle[style], **kw)
        j = jfc.Conversation(sep_style=jfc.SeparatorStyle[style], **kw)
        for conv in (t, j):
            conv.append_message("U", "hi")
            conv.append_message("A", None)
        assert t.get_prompt() == j.get_prompt(), style


SWEEP = [(h, w) for h in (10, 14, 21, 28, 33, 40, 56, 60, 84, 112)
         for w in (7, 14, 20, 28, 42, 56, 70, 84, 100, 140)]


@pytest.mark.parametrize("max_num", [1, 4, 6, 12])
def test_tile_grid_matches_jax_over_a_sweep(max_num):
    """The grid and the tile count of ``dynamic_preprocess`` over 100 sizes
    at a 28-px tile (the tie rule compares the image's area with the
    grid's, so it bites at every scale), and the tiles equal the JAX
    package's (Pillow's) bit for bit, up to 4x upsampling."""
    rng = np.random.default_rng(max_num)
    for h, w in SWEEP:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = jivl.dynamic_preprocess(img, max_num=max_num, image_size=28)
        got = tivl.tile_pixels(torch.from_numpy(img.reshape(h, -1)), max_num, 28)
        cols, rows = tivl.tile_grid(h, w, max_num=max_num, image_size=28)
        assert got.shape[0] == len(want) == cols * rows + (cols * rows > 1), (h, w)
        np.testing.assert_array_equal(got.numpy(), np.stack(want).reshape(len(want), 28, -1))


@pytest.mark.parametrize("hw,grid,n", [((1024, 1024), (3, 3), 10), ((300, 380), (4, 3), 13)])
def test_tiles_at_448_equal_pillow(hw, grid, n):
    """The tie rule: a square 1024 px image takes 3x3 + the thumbnail (a
    rule that keeps the first best ratio gives 1 tile); 300x380 takes 4x3 +
    the thumbnail, upsampled 4.6x. The tiles equal Pillow's bit for bit."""
    img = np.random.default_rng(5).integers(0, 256, (*hw, 3), dtype=np.uint8)
    assert tivl.tile_grid(*hw) == grid
    want = np.stack(jivl.dynamic_preprocess(img, max_num=12, image_size=448))
    got = tivl.tile_pixels(torch.from_numpy(img.reshape(hw[0], -1)), 12, 448).numpy()
    assert got.shape == (n, 448, 448 * 3) and want.shape[0] == n
    np.testing.assert_array_equal(got, want.reshape(n, 448, -1))
    norm = tivl.preprocess_tiles(torch.from_numpy(want.reshape(n, 448, -1)))
    np.testing.assert_allclose(norm.numpy(), jivl.preprocess_tiles(list(want)).reshape(
        n, 448, -1), atol=1e-6, rtol=0)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 12)).astype(np.float32)
    want = np.asarray(jivl.pixel_shuffle(jnp.asarray(x), 0.5))
    got = tivl.pixel_shuffle(torch.from_numpy(x), 0.5).numpy()
    assert got.shape == (2, 4, 4, 48)
    np.testing.assert_array_equal(got, want)
    # the two transposes matter: without them the same values land elsewhere
    assert not np.array_equal(got, x.reshape(2, 4, 4, 48))


@pytest.mark.parametrize("name", NAMES)
def test_image_features_and_splice_and_score_match_jax(name):
    """At a 56-px tile (a 4x4 patch grid: the shuffle moves real rows)."""
    cfg = jivl.INTERNVL_MODELS[name]["config"]
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, image_size=56))
    tcfg = tivl.INTERNVL_MODELS[name]["config"]
    tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, image_size=56))
    params = _params(name, cfg)
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jivl.image_features(params, cfg, jnp.asarray(px)))
    model = bridge.internvl_from_numpy(params, tcfg, "cpu", torch.float32)
    assert (model.vision.blocks[0].qkv is None) == cfg.vision.qk_norm
    with torch.inference_mode():
        got = tivl.image_features(model, tcfg, torch.from_numpy(px.reshape(3, 56, -1)))
    assert got.shape == (3, 4, cfg.text.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())

    b, s, t_img = 2, 24, 8
    ids = rng.integers(3, 500, (b, s))
    vis_mask = np.zeros((b, s), bool)
    vis_mask[:, 4:4 + t_img] = True
    ids[vis_mask] = cfg.image_token_id
    vis_slot = np.zeros((b, s), np.int64)
    vis_slot[vis_mask] = np.tile(np.arange(t_img), b)
    feats = want.reshape(1, -1, cfg.text.d_model)[:, :t_img].repeat(b, 0)
    attn = np.arange(s)[None] < np.array([[24], [19]])
    ans_ids = rng.integers(3, 500, (b, 1))
    ans_pos = np.array([[23], [18]])
    ans_mask = np.ones((b, 1), np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    arrays = (ids, feats, vis_mask, vis_slot, pos, attn, ans_ids, ans_pos, ans_mask)
    w = np.asarray(jivl.splice_and_score(params, cfg, *map(jnp.asarray, arrays)))
    with torch.inference_mode():
        g = tivl.splice_and_score(model, tcfg, *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_scores_match_jax(name):
    """Images at the tile size (one tile, no resize on either side)."""
    j, t = _scorers(name)
    images = _images(3, 3)
    want = j(images=images, texts=TEXTS)
    before = launch_counts()
    got = t(images=images, texts=TEXTS)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, 3) and np.all((got >= 0) & (got <= 1))
    _close(got, want, TOL)
    assert np.ptp(np.log(want)) > 100 * TOL


def test_pairwise_forward_batch_forward_and_resized_images_match_jax():
    """Pairs sharing an image (the tower runs once for it), ``batch_forward``
    rows equal ``__call__``'s, and images that take the tile grid (40x60:
    2x2 by the tie rule + the thumbnail; 70x30: 1x2 + the thumbnail)."""
    j, t = _scorers("internvl3.5-test")
    images = _images(4, 3)
    imgs = [images[0], images[2], images[0]]
    _close(t.model.forward(imgs, TEXTS), j.model.forward(imgs, TEXTS), TOL)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(4)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (4, 1, 3)
    for i in range(4):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 3]], texts=TEXTS)[0],
                                   atol=1e-7, rtol=1e-5)
    wide = _images(6, 1, (40, 60)) + _images(7, 1, (70, 30))
    assert [t.model._tiles(im, 32).shape[0] for im in wide] == [5, 3]
    _close(t(images=wide, texts=TEXTS[:2]), j(images=wide, texts=TEXTS[:2]), TOL)


@pytest.mark.parametrize("name", ["internvl3-test", "internvl3.5-moe-test"])
def test_generate_matches_jax(name):
    """Batched (two images) and per sequence (one image, one video of
    ``Frame{i}: <image>`` blocks): the same token ids."""
    j, t = _scorers(name)
    images = _images(8, 2)
    texts = ["describe", "what is on the table"]
    want = j.model.generate(images, texts, max_new_tokens=6)
    assert t.model.generate(images, texts, max_new_tokens=6) == want
    assert all(len(w.split()) >= 1 for w in want)
    got = t.model.generate([images[0]], texts[:1], max_new_tokens=6)
    assert got == j.model.generate([images[0]], texts[:1], max_new_tokens=6)
    assert got[0] == want[0]


def test_video_scores_and_generate_match_jax():
    """vid.mp4 (20 frames of 96x128: all 20 at 32 segments) through both
    packages, each frame resized to the 28-px tile; a ``DecodedVideo`` of the
    same frames scores as the file; generate over 4 frame blocks."""
    from t2v_metrics_tpu_torch.media.video import extract_frames

    j, t = _scorers("internvl3.5-test")
    assert t.model._tiles(VID, 32).shape[0] == 20
    want = j(images=[VID], texts=TEXTS)
    got = t(images=[VID], texts=TEXTS)
    _close(got, want, TOL)
    frames = np.stack(extract_frames(VID, 1000, mode="linspace"))
    decoded = DecodedVideo(frames, 10.0)
    np.testing.assert_array_equal(t(images=[decoded], texts=TEXTS), got)
    _close(t.model.forward([VID, VID], TEXTS[:2], num_segments=4),
           j.model.forward([VID, VID], TEXTS[:2], num_segments=4), TOL)
    want = j.model.generate([VID], ["describe"], num_frames=4, max_new_tokens=5)
    assert t.model.generate([decoded], ["describe"], num_frames=4, max_new_tokens=5) == want


def test_sampled_generate_takes_the_numpy_seed():
    """Nucleus sampling, one sequence at a time, with the caller's
    generator: the JAX adapter's draws from np.random.default_rng, given the
    same seed here."""
    j, t = _scorers("internvl3-test")
    img = _images(9, 1)
    kw = dict(max_new_tokens=6, do_sample=True, temperature=1.5)
    with mock.patch("numpy.random.default_rng", lambda *a: np.random.Generator(
            np.random.PCG64(11))):
        want = j.model.generate(img, ["describe"], **kw)
    got = t.model.generate(img, ["describe"], rng=np.random.Generator(np.random.PCG64(11)),
                           **kw)
    assert got == want


def test_build_ids_and_eos_match_jax():
    j, t = _scorers("internvl3-test")
    for q, n in (("Is this a cat?", 1), ("two dogs", 5)):
        assert t.model._build_ids(q, n) == j.model._build_ids(q, n)
    prompt = "Frame1: <image>\nFrame2: <image>\ndescribe"
    assert t.model._build_ids_multi(prompt, [1, 1]) == j.model._build_ids_multi(prompt, [1, 1])
    assert t.model._eos_ids() == j.model._eos_ids() == {1}


def test_random_init_and_entry_points():
    cfg = tivl.INTERNVL_MODELS["internvl3.5-moe-test"]["config"]
    m = tivl.init_internvl(cfg, 0, "cpu")
    blk = m.vision.blocks[0]
    assert blk.qkv is None and blk.q_norm.scale.shape == (32,) and blk.ln1.bias is None
    assert torch.equal(blk.lambda_1, torch.full((32,), 0.1))
    assert m.decoder.blocks[0].moe is not None
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("internvl3.5-8b", init="random")
    assert tt2v.VQAScore("internvl3-test", device="cpu").model.device.type == "cpu"
