"""Port parity: video VQAScore for Qwen2.5-VL, Qwen3-VL (dense and MoE) and
Gemma 3 against the JAX package, on the same parameters (carried over by
``bridge.py``), the same tokenizer instance and the same clips.

The helpers below the file reader are held exactly: the fps sampling of
``_decode_video_raw`` (frames bitwise, seconds per temporal grid step),
Gemma's truncated-linspace frames and their timestamps, and the M-RoPE
index of video grids. ``video_patches`` is held to 1e-6 against the device
preprocess inside the JAX adapter's ``_video_feats_jit``.

Scores: where both packages resize with the same function (Qwen2.5-VL's one
float pass; Qwen3-VL and Gemma on clips already at their resized size,
``vid.mp4``'s 96x128 at the Qwen test configs' factor 8, a cv2-written 28x28
clip at the Gemma test tower's size) the scores are held to 1e-5 and their
logs to 1e-4 nats, the image tests' bar (fp32; the two CPU BLAS libraries
sum in different orders). Where the port's exact resize stands for the JAX
adapters' Pillow (Qwen3-VL on a cv2-written 100x150 clip, Gemma 3 on
``vid.mp4`` resized to 28x28) the two give the same pixels
(``ops/image.py:resize_uint8_pillow_flat``, bit for bit), so the same bars
hold.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import gemma3 as jg3  # noqa: E402
from t2v_metrics_tpu.models import gemma_adapters as jga  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl as jq  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl_adapter as jqa  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.media.video import DecodedVideo  # noqa: E402
from t2v_metrics_tpu_torch.models import gemma_adapters as tga  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl_adapter as tqa  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402

VID = "_test_assets/vid.mp4"
TOL = 1e-4          # log scores, as the image tests
SCORE_TOL = 1e-5    # scores
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
QWEN = ("qwen2.5-vl-test", "qwen3-vl-test", "qwen3-vl-moe-test")
_SCORERS = {}


def _qwen_config(name):
    return (jq.QWEN2_VL_MODELS[name]["config"] if name.startswith("qwen2.5")
            else jq3.resolve_config(name))


def _port_config(name):
    """The port's Qwen3-VL config with the JAX package's pixel
    normalisation, CLIP's mean and std (the port gives Qwen3-VL its
    published processor's 0.5); None (the registry's) for the others."""
    if not name.startswith("qwen3"):
        return None
    cfg = tq3.resolve_config(name)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_mean=CLIP_MEAN, image_std=CLIP_STD))


def _params(name):
    """Numpy parameters in the JAX layout: matrices x3 (Qwen) or x2 with the
    Gemma norm scales drawn away from zero, as the family's image tests."""
    if name == "gemma-3-test":
        jp = jg3.init_gemma3(jax.random.PRNGKey(0), jg3.GEMMA3_MODELS[name]["config"])
        rng = np.random.default_rng(0)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        return jax.tree.unflatten(treedef, leaves)
    init = jq.init_qwen2vl if name.startswith("qwen2.5") else jq3.init_qwen3vl
    leaves, treedef = jax.tree.flatten(init(jax.random.PRNGKey(0), _qwen_config(name)))
    leaves = [np.asarray(x) * np.float32(3.0) if np.ndim(x) == 2 else np.asarray(x)
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


def scorers(name):
    """(JAX scorer, port scorer on the CPU) of one test model, made once."""
    if name not in _SCORERS:
        params = _params(name)
        vocab = (jg3.GEMMA3_MODELS[name]["config"] if name == "gemma-3-test"
                 else _qwen_config(name)).text.vocab_size
        tok = SimpleT5Tokenizer(vocab)
        _SCORERS[name] = (jt2v.VQAScore(name, params=params, tokenizer=tok),
                          tt2v.VQAScore(name, params=params, tokenizer=tok, device="cpu",
                                        config=_port_config(name)))
    return _SCORERS[name]


def _write_clip(path, h, w, n=12, fps=10.0, seed=0):
    """A seeded clip, lossless (FFV1), so that the JAX package's libav reader
    (where built) and cv2 decode the same frames."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    assert writer.isOpened()
    for _ in range(n):
        writer.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    writer.release()
    return str(path)


def _decoded(path):
    """Every frame of a clip, read in order, and its frame rate."""
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return DecodedVideo(np.stack(frames), fps)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.log(got), np.log(want), atol=tol, rtol=0)
    if tol == TOL:
        np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Below the reader: sampling, frames, the rope index, the preprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2.5-vl-test", "qwen3-vl-test"])
@pytest.mark.parametrize("fps", [8.0, 2.0, "dynamic", 3.0])
def test_decode_video_raw_matches_jax(name, fps):
    """fps sampling of vid.mp4 (20 frames at 10 fps): 16 frames at fps 8,
    the floor of 4 at fps 2 and "dynamic", 6 at fps 3 (round to even);
    frames bitwise, seconds per temporal grid step equal, the same from a
    ``DecodedVideo`` of the clip."""
    me = types.SimpleNamespace(config=_qwen_config(name))
    want, want_spg = jqa.Qwen2VLAdapter._decode_video_raw(me, VID, fps)
    got, spg = tqa.Qwen2VLAdapter._decode_video_raw(me, VID, fps)
    assert got.dtype == np.uint8 and got.shape[0] % 2 == 0
    np.testing.assert_array_equal(got, want)
    assert spg == want_spg
    got, spg = tqa.Qwen2VLAdapter._decode_video_raw(me, _decoded(VID), fps)
    np.testing.assert_array_equal(got, want)
    assert spg == want_spg


def test_decode_video_raw_pads_to_the_temporal_patch(tmp_path):
    """An odd sample count (5 frames at 10 fps sampled at 30 fps take
    max(4, min(768, 5, 16)) = 5 indices) repeats the last frame to 6; spg_t
    is computed after the padding."""
    clip = _write_clip(tmp_path / "odd.avi", 32, 48, n=5)
    me = types.SimpleNamespace(config=_qwen_config("qwen2.5-vl-test"))
    want, want_spg = jqa.Qwen2VLAdapter._decode_video_raw(me, clip, 30.0)
    got, spg = tqa.Qwen2VLAdapter._decode_video_raw(me, clip, 30.0)
    assert got.shape[0] == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[5], got[4])
    assert spg == want_spg


@pytest.mark.parametrize("num_frames", [10, 4])
def test_gemma_extract_frames_matches_jax(num_frames):
    """Truncated linspace indices, not rounded ones: at 10 frames of
    vid.mp4 the two rules differ at 4 of the 10 indices."""
    want = jga._GemmaBase._extract_frames(None, VID, num_frames)
    for video in (VID, _decoded(VID)):
        got = tga._GemmaBase._extract_frames(video, num_frames)
        assert [ts for ts, _ in got] == [ts for ts, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    idx = np.linspace(0, 19, num_frames, dtype=int)
    assert [ts for ts, _ in want] == [round(i / 10.0, 2) for i in idx]
    if num_frames == 10:
        rounded = np.round(np.linspace(0, 19, num_frames)).astype(int)
        assert int((rounded != idx).sum()) == 4


def test_build_rope_index_video_grids_match_jax():
    """Video grids with seconds per grid step (the temporal index int64 of
    t * spg * tokens_per_second), an image then a video in one sequence,
    and the default spg of a video block."""
    for name in ("qwen2.5-vl-test", "qwen3-vl-test"):
        cfg = _qwen_config(name)
        tcfg = (tq.QWEN2_VL_MODELS[name]["config"] if name.startswith("qwen2.5")
                else tq3.resolve_config(name))
        img, vid = cfg.image_token_id, cfg.video_token_id
        cases = [
            ([3, 4] + [vid] * 4 * 3 * 4 + [5, 6], [(4, 6, 8)], [0.25]),
            ([3] + [vid] * 3 * 2 * 2 + [7], [(3, 4, 4)], [1.0 / 3.0]),
            ([3] + [img] * 6 + [4] + [vid] * 2 * 3 * 2 + [5], [(1, 4, 6), (2, 6, 4)],
             [0.0, 0.7]),
            ([3] + [vid] * 2 * 2 * 2 + [5], [(2, 4, 4)], None),
        ]
        for ids, grids, spg in cases:
            ids = np.asarray(ids)
            want = jq.build_rope_index(ids, grids, cfg, second_per_grid_ts=spg)
            got = tq.build_rope_index(ids, grids, tcfg, second_per_grid_ts=spg)
            np.testing.assert_array_equal(got, want)


def test_mixed_batch_rope_and_prompts_match_jax():
    """_prepare_pairs over an image and a video: ids, masks, slots and the
    (3, P, S) rope index equal, the features within the tower bar."""
    img = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for name in ("qwen2.5-vl-test", "qwen3-vl-test"):
        j, t = scorers(name)
        qs = [f"q {i}" for i in range(3)]
        want, wl = j.model._prepare_pairs([img, VID, img], qs, 2.0)
        got, gl = t.model._prepare_pairs([img, VID, img], qs, 2.0)
        assert gl == wl
        for k in (0, 2, 3, 4, 5):
            np.testing.assert_array_equal(got[k], want[k])
        w = np.asarray(want[1])
        np.testing.assert_allclose(got[1].numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("tiled", [True, False])
def test_video_patches_match_jax_video_feats(tiled, monkeypatch):
    """``video_patches`` (one float bicubic pass, rounded once) against the
    preprocess inside the JAX adapter's ``_video_feats_jit``, whose tower is
    replaced by the identity: the same patch rows in window (or tile) order,
    padded to the bucket, within 1e-6; except where the float pass sits on
    a rounding tie (a level + 0.5: the two BLAS libraries' sums differ by
    ~1e-5 there, so round-half-even may go either way), where the two may
    be one uint8 level apart: at most one element per such pixel."""
    import jax.numpy as jnp
    from t2v_metrics_tpu.ops import image as jimage
    name = "qwen2.5-vl-test"
    cfg = _qwen_config(name)
    if not tiled:   # 3x3-merged-patch windows overflow the bucket untiled
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, window_size=24))
    h0, w0 = (70, 90) if tiled else (60, 130)
    frames = np.random.default_rng(2).integers(0, 256, (2, 4, h0, w0, 3), dtype=np.uint8)
    hb, wb = tqa.smart_resize(h0, w0, 8, tqa.VIDEO_MIN_PIXELS, tqa.VIDEO_MAX_PIXELS)
    grid = (2, hb // 4, wb // 4)
    s = int(np.prod(grid))
    sb = tqa._bucket(s, tqa.PATCH_BUCKETS)
    geom, pos_hw, win_seg, full_seg, reverse, is_tiled = jqa._padded_geometry(
        cfg.vision, grid, s, sb)
    assert is_tiled == tiled
    perm = geom["perm_tile"] if tiled else geom["perm"]
    monkeypatch.setattr(jq, "vision_tower_batch", lambda p, c, flat, *a, **k: flat)
    me = types.SimpleNamespace(config=cfg)
    fn = jqa.Qwen2VLAdapter._video_feats_jit(me, frames.shape[1:4], hb, wb, grid, sb,
                                             np.float32, tiled)
    n = frames.shape[0]
    pixels = frames.reshape(n, 4, h0, w0 * 3)
    want = np.asarray(fn({"vision": None}, pixels, perm,
                         *[np.broadcast_to(a, (n, *a.shape)) for a in
                           (pos_hw, win_seg, full_seg, reverse)]))
    tvision = tq.QwenVisionConfig(**dataclasses.asdict(cfg.vision))   # CLIP's mean and std
    rows = tq.video_patches(torch.from_numpy(pixels), tvision, hb, wb)[
        :, torch.from_numpy(perm.astype(np.int64))]
    got = torch.nn.functional.pad(rows, (0, 0, 0, sb - rows.shape[1])).numpy()
    assert got.shape == want.shape == (n, sb, cfg.vision.patch_dim)
    real = win_seg >= 0   # each patch row once (tile pad slots repeat row 0)
    err = np.abs(got - want)[:, real]
    ties = np.abs(np.asarray(jimage.resize_flat(jnp.asarray(pixels, jnp.float32), hb, wb, 3))
                  % 1.0 - 0.5) < 1e-4
    assert int((err > 1e-6).sum()) <= int(ties.sum()) < 1e-2 * ties.size
    assert err.max() <= 1.0 / 255.0 / min(CLIP_STD) + 1e-6
    np.testing.assert_allclose(got[:, ~real], want[:, ~real], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Scores through the public entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QWEN)
def test_qwen_video_scores_match_jax(name):
    """vid.mp4 through ``__call__`` at the default fps and at fps 2.0, and
    through ``batch_forward`` over ``"videos"`` samples with fps 2.0."""
    j, t = scorers(name)
    _close(t(images=[VID], texts=TEXTS[:2]), j(images=[VID], texts=TEXTS[:2]))
    want = j(images=[VID], texts=TEXTS, fps=2.0)
    _close(t(images=[VID], texts=TEXTS, fps=2.0), want)
    data = [{"videos": [VID], "texts": TEXTS} for _ in range(3)]
    got = t.batch_forward(data, batch_size=2, fps=2.0)
    _close(got, j.batch_forward(data, batch_size=2, fps=2.0))
    _close(got[0], want)


@pytest.mark.parametrize("name", ["qwen2.5-vl-test", "qwen3-vl-test", "gemma-3-test"])
def test_image_and_video_in_one_call_match_jax(name, tmp_path):
    """One call over an image and a video: one padded feature tensor, the
    image's and the video's prompts and rope indices side by side."""
    j, t = scorers(name)
    if name == "gemma-3-test":
        img = np.random.default_rng(3).integers(0, 256, (28, 28, 3), dtype=np.uint8)
        vid = _write_clip(tmp_path / "tower.avi", 28, 28)
    else:
        img = np.random.default_rng(3).integers(0, 256, (64, 96, 3), dtype=np.uint8)
        vid = VID
    _close(t(images=[img, vid], texts=TEXTS[:2]), j(images=[img, vid], texts=TEXTS[:2]))


def test_qwen3_resized_clip_scores_near_jax(tmp_path):
    """A cv2-written 100x150 clip, resized to 96x152: the JAX adapter
    resizes its frames with Pillow on the host, the port on the device with
    Pillow's fixed-point resize, bit for bit."""
    clip = _write_clip(tmp_path / "c.avi", 100, 150)
    for name in ("qwen3-vl-test", "qwen3-vl-moe-test"):
        j, t = scorers(name)
        _close(t(images=[clip], texts=TEXTS[:2]), j(images=[clip], texts=TEXTS[:2]))


def test_gemma_video_scores_match_jax(tmp_path):
    """A cv2-written clip at the test tower's size (no resize): ``__call__``
    (10 frames) and ``batch_forward`` with num_frames 4 against the JAX
    package's batch_forward; vid.mp4 (frames resized 96x128 -> 28x28,
    Pillow against the port's exact resize) at the same bars."""
    j, t = scorers("gemma-3-test")
    clip = _write_clip(tmp_path / "tower.avi", 28, 28, n=14)
    _close(t(images=[clip], texts=TEXTS), j(images=[clip], texts=TEXTS))
    data = [{"videos": [clip], "texts": TEXTS[:2]} for _ in range(3)]
    got = t.batch_forward(data, batch_size=2, num_frames=4)
    _close(got, j.batch_forward(data, batch_size=2, num_frames=4))
    _close(got[:, 0], t.model.forward([clip] * 2, TEXTS[:2], num_frames=4)[None]
           .repeat(3, 0))
    for nf in (10, 4):
        _close(t.model.forward([VID] * 2, TEXTS[:2], num_frames=nf),
               j.model.forward([VID] * 2, TEXTS[:2], num_frames=nf))
    data = [{"videos": [VID], "texts": TEXTS[:2]}]
    _close(t.batch_forward(data), j.batch_forward(data))


@pytest.mark.parametrize("name", QWEN + ("gemma-3-test",))
def test_decoded_video_scores_equal_the_file(name):
    """A ``DecodedVideo`` (the way in on a machine without a reader) scores
    bitwise as the file it was decoded from."""
    _, t = scorers(name)
    want = t(images=[VID], texts=TEXTS[:2])
    clip = _decoded(VID)
    np.testing.assert_array_equal(t(images=[clip], texts=TEXTS[:2]), want)
    data = [{"videos": [clip], "texts": TEXTS[:2]}, {"videos": [VID], "texts": TEXTS[:2]}]
    got = t.batch_forward(data, batch_size=2)
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("name", ["qwen2.5-vl-test", "gemma-3-test"])
def test_video_needs_a_reader(name, monkeypatch):
    """No fallback: a video path without cv2 raises the reader's
    ImportError, and a path cv2 cannot open raises, never a score."""
    _, t = scorers(name)
    with pytest.raises(OSError, match="cannot open video"):
        t(images=["missing.mp4"], texts=["a"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        t(images=[VID], texts=["a"])
