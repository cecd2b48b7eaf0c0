"""Port parity: the Apollo-era loaders (``media/video_utils.py``) and
``media/video.py``'s ``video_info``, ``concatenate_vertical`` and
``concatenate_grid`` against the JAX package on the CPU.

Index math, token budget, padding and clip splits are compared exactly.
Frames come from seeded FFV1 clips that the tests write with cv2: FFV1 is
lossless, so the JAX package's libav reader (where built) and the port's
cv2 reader decode the same frames, and frames, timestamps and collages are
compared bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from t2v_metrics_tpu.media import native_loader  # noqa: E402
from t2v_metrics_tpu.media import video as JV  # noqa: E402
from t2v_metrics_tpu.media import video_utils as JU  # noqa: E402
from t2v_metrics_tpu_torch.media import video as TV  # noqa: E402
from t2v_metrics_tpu_torch.media import video_utils as TU  # noqa: E402
from t2v_metrics_tpu_torch.media.video import MediaError  # noqa: E402


def _write_clip(path, h, w, n, fps, seed=0):
    """A seeded clip, lossless (FFV1); returns its path and its RGB frames."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    assert writer.isOpened()
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    for f in frames:
        writer.write(f)
    writer.release()
    return str(path), frames[..., ::-1]


def _same_indices(got, want):
    clips, all_idx, stamps = got
    jclips, jall, jstamps = want
    assert len(clips) == len(jclips)
    for c, j in zip(clips, jclips):
        assert c.dtype == j.dtype
        np.testing.assert_array_equal(c, j)
    assert all_idx == jall
    assert stamps == jstamps


# (clip_duration, frames_per_clip, total_frames, fps, duration, clip_sampling_ratio)
INDEX_GRID = [
    (1.0, 4, 300, 30.0, 10.0, 1),         # partition_len > clip_len
    (2.0, 4, 3000, 30.0, 100.0, 0.1),     # ratio below 1, partitions
    (2.0, 4, 150, 30.0, 5.0, 0.5),        # ratio below 1, two partitions
    (2.0, 4, 120, 30.0, 4.0, 1),          # partition_len == clip_len
    (2.0, 4, 240, 24.0, 10.0, 1),         # clip_step arithmetic
    (2.0, 4, 244, 24.0, 10.0, 1),         # partition_len == clip_len < clip_step
    (2.0, 4, 299, 29.97, 299 / 29.97, 0.37),
    (2.0, 4, 20, 10.0, 2.0, 1),           # one clip, the whole video
    (2.0, 8, 10, 10.0, 1.0, 1),           # short video: indices padded
    (2.0, 4, 2, 30.0, 2 / 30, 1),         # two frames
    (2.0, 4, 4, 1.0, 4.0, 1),             # low fps: repeated frames
    (2.0, 4, 10, 1.0, 10.0, 1),           # low fps, five clips
    (2.0, 8, 7, 0.5, 14.0, 0.6),          # lower fps, ratio below 1
    (2.0, 16, 30, 3.0, 10.0, 1),          # low fps, 1 / frame_step not whole
    (4.0, 4, 3, 0.25, 12.0, 1),           # clip_len 0
    (2.0, 4, 0, 30.0, 0.0, 1),            # no frame
]


@pytest.mark.parametrize("args", INDEX_GRID, ids=lambda a: "-".join(map(str, a)))
def test_calculate_sample_indices_matches_jax(args):
    *head, ratio = args
    _same_indices(TU.calculate_sample_indices(*head, clip_sampling_ratio=ratio),
                  JU.calculate_sample_indices(*head, clip_sampling_ratio=ratio))


def test_effective_sampling_ratio_matches_jax():
    for kw in ({}, dict(clip_duration=2.0, frames_per_clip=4, num_repeat_token=16,
                        model_max_length=64),
               dict(clip_duration=1.0, num_repeat_token=8, model_max_length=512,
                    clip_sampling_ratio=0.5)):
        t, j = TU.ApolloMMLoader(**kw), JU.ApolloMMLoader(**kw)
        for d in (0.0, 1e-9, 0.5, 2.0, 7.3, 60.0, 1000.0, 3600.0, 1e6):
            assert t.effective_sampling_ratio(d) == j.effective_sampling_ratio(d)


def test_pad_to_center_square_and_split_match_jax():
    rng = np.random.default_rng(0)
    for frames, fill in ((rng.integers(0, 256, (10, 20, 3), dtype=np.uint8), (5, 6, 7)),
                         (rng.integers(0, 256, (3, 21, 8, 3), dtype=np.uint8), (1, 2, 3)),
                         (rng.random((2, 6, 6, 1)).astype(np.float32), (0.5,))):
        got = TU.pad_to_center_square(frames, fill)
        assert got.dtype == frames.dtype
        np.testing.assert_array_equal(got, JU.pad_to_center_square(frames, fill))
    for mod in (TU, JU):
        with pytest.raises(ValueError):
            mod.pad_to_center_square(np.zeros((4, 4), np.uint8), (0,))
    video = np.arange(10 * 2).reshape(10, 2)
    for fpc in (1, 3, 4, 10, 11):
        got, want = TU.split_into_clips(video, fpc), JU.split_into_clips(video, fpc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", range(1, 11))
def test_concatenations_match_jax(n):
    """Frames of mixed sizes, 1 to 10 of them: the vertical strip and the
    grid collage (cv2 Lanczos) bit for bit."""
    rng = np.random.default_rng(n)
    sizes = [(int(rng.integers(8, 90)), int(rng.integers(8, 90))) for _ in range(n)]
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    np.testing.assert_array_equal(TV.concatenate_vertical(frames, dist=3),
                                  JV.concatenate_vertical(frames, dist=3))
    np.testing.assert_array_equal(TV.concatenate_vertical(frames),
                                  JV.concatenate_vertical(frames))
    for kw in ({}, dict(dist=4, output_size=(200, 150))):
        got = TV.concatenate_grid(frames, **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, JV.concatenate_grid(frames, **kw))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Seeded FFV1 clips: 5 s at 30 fps (clips in the full-video branch), 10
    s at 30 fps (the partition branch at 1 s clips) and 10 s at 1 fps (the
    low-fps branch: repeated frames)."""
    d = tmp_path_factory.mktemp("clips")
    return {"30fps": _write_clip(d / "a.avi", 24, 32, 150, 30.0, seed=1),
            "30fps_10s": _write_clip(d / "b.avi", 16, 20, 300, 30.0, seed=2),
            "1fps": _write_clip(d / "c.avi", 20, 16, 10, 1.0, seed=3)}


@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_cv2"])
@pytest.mark.parametrize("clip,kw", [
    ("30fps", dict(clip_duration=2.0, frames_per_clip=4)),
    ("30fps", dict(clip_duration=2.0, frames_per_clip=4, model_max_length=20)),
    ("30fps_10s", dict(clip_duration=1.0, frames_per_clip=4)),
    ("1fps", dict(clip_duration=2.0, frames_per_clip=4)),
])
def test_video_files_match_jax(clips, monkeypatch, clip, kw, native):
    """``video_info``, ``get_video_details``, ``load_frames_from_video``,
    ``opencv_extract_frames`` and ``ApolloMMLoader.load_video``: equal to
    the JAX package's with its libav reader (where built) and with its cv2
    fallback; the loaded frames are the written frames at the indices."""
    path, written = clips[clip]
    if not native:
        monkeypatch.setattr(native_loader, "native_available", lambda: False)
    assert TV.video_info(path) == JV.video_info(path)
    assert TU.get_video_details(path) == JU.get_video_details(path)
    total = TV.video_info(path)["total_frames"]
    assert total == len(written)
    idx = [0, 3, total - 1]
    np.testing.assert_array_equal(TU.load_frames_from_video(path, idx),
                                  JU.load_frames_from_video(path, idx))
    got, want = TU.opencv_extract_frames(path, 5), JU.opencv_extract_frames(path, 5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    (clips_, stamps), (jclips, jstamps) = (TU.ApolloMMLoader(**kw).load_video(path),
                                          JU.ApolloMMLoader(**kw).load_video(path))
    assert stamps == jstamps and len(clips_) == len(jclips) > 0
    details = TU.get_video_details(path)
    ratio = TU.ApolloMMLoader(**kw).effective_sampling_ratio(details[2])
    _, all_idx, _ = TU.calculate_sample_indices(
        kw["clip_duration"], kw["frames_per_clip"], *details, clip_sampling_ratio=ratio)
    for c, j in zip(clips_, jclips):
        assert c.dtype == np.uint8 and c.shape[0] == kw["frames_per_clip"]
        np.testing.assert_array_equal(c, j)
    np.testing.assert_array_equal(np.concatenate(clips_), written[all_idx])


def test_load_video_preprocess_is_applied_per_clip(clips):
    path, _ = clips["30fps"]
    got, _ = TU.ApolloMMLoader(preprocess=lambda c: c.shape).load_video(path)
    want, _ = JU.ApolloMMLoader(preprocess=lambda c: c.shape).load_video(path)
    assert got == want == [(4, 24, 32, 3)] * 3


def test_unreadable_media_raises_media_error(tmp_path, clips):
    """A file that is not a video raises ``MediaError`` (an ``OSError``, as
    the JAX ``IOError``) from every reader; indices that give no frame raise
    it too (a ``ValueError``, as the JAX ``np.stack([])``)."""
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    bad = str(bad)
    for fn in (lambda: TV.video_info(bad), lambda: TU.get_video_details(bad),
               lambda: TU.load_frames_from_video(bad, [0]),
               lambda: TU.opencv_extract_frames(bad, 4),
               lambda: TU.ApolloMMLoader().load_video(bad)):
        with pytest.raises(MediaError, match="bad.mp4"):
            fn()
    with pytest.raises(OSError):
        JV.video_info(bad)
    path, _ = clips["1fps"]
    with pytest.raises(MediaError, match="no readable frame"):
        TU.load_frames_from_video(path, [50, 60])
    with pytest.raises(ValueError):
        TU.load_frames_from_video(path, [50])
