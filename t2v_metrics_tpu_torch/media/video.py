"""Host-side video frames (a copy of ``_open_capture``, ``is_video_path``,
``extract_frames`` and ``concatenate_horizontal`` from
t2v_metrics_tpu/media/video.py, without its native libav reader).

Frames are decoded with OpenCV's position seek, imported only when a video
file is read; where cv2 is missing, a video path raises ImportError. The
direct video models (Qwen2.5-VL, Qwen3-VL, Gemma 3) sample frames through
``open_video``, which also takes a ``DecodedVideo``: a clip decoded
elsewhere, the way in for a machine without a video reader.

Frame index selection: ``step`` mode ``i * (total // n)``; ``linspace``
mode ``round(linspace(0, total-1, n))``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

from ..constants import VIDEO_EXTENSIONS


class MediaError(OSError, ValueError):
    """A media file that cannot be read: a video that does not open or gives
    no frame, an image that cannot be decoded. The readers raise it, and
    only it, for bad media; a score loop that records unreadable samples
    catches it and nothing else."""


def _open_capture(video_path: str):
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise MediaError(f"cannot open video {video_path}")
    return cap, cv2


@dataclasses.dataclass(frozen=True, eq=False)
class DecodedVideo:
    """Every frame of a clip, decoded: RGB uint8 (N, H, W, 3), and its frame
    rate. The video models sample it as they sample a video file."""

    frames: np.ndarray
    fps: float


@contextlib.contextmanager
def open_video(video):
    """Frame access to a video path or a ``DecodedVideo``: yields (total
    frames, frames per second (30.0 where the file gives 0), read), where
    read(i) is RGB uint8 frame i, or None if it cannot be read."""
    if isinstance(video, DecodedVideo):
        frames = video.frames

        def read_decoded(i):
            return frames[i] if 0 <= i < len(frames) else None
        yield len(frames), float(video.fps) or 30.0, read_decoded
        return
    cap, cv2 = _open_capture(video)

    def read(i):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        return frame[:, :, ::-1] if ok else None  # BGR -> RGB
    try:
        yield int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), \
            float(cap.get(cv2.CAP_PROP_FPS)) or 30.0, read
    finally:
        cap.release()


def frame_indices(total: int, num_frames: int, mode: str = "linspace") -> np.ndarray:
    num_frames = min(num_frames, max(total, 1))
    if mode == "step":
        step = max(total // num_frames, 1)
        return np.arange(num_frames) * step
    return np.round(np.linspace(0, max(total - 1, 0), num_frames)).astype(np.int64)


def extract_frames(video_path: str, num_frames: int, mode: str = "step",
                   fps: float | None = None) -> list[np.ndarray]:
    """Decode frames as RGB uint8 HWC arrays.

    fps: if given, overrides num_frames with time-uniform sampling at that
    rate.
    """
    with open_video(video_path) as (total, native_fps, read):
        if fps is not None:
            n = max(int(total / native_fps * fps), 1)
            idx = frame_indices(total, n, "linspace")
        else:
            idx = frame_indices(total, num_frames, mode)
        frames = [f.copy() for f in map(read, idx) if f is not None]
    if not frames:
        raise MediaError(f"no readable frame in video {video_path}")
    return frames


def concatenate_horizontal(frames: list[np.ndarray], dist: int = 10) -> np.ndarray:
    """Concatenate frames left-to-right on black, top-aligned."""
    total_w = sum(f.shape[1] for f in frames) + dist * (len(frames) - 1)
    h = max(f.shape[0] for f in frames)
    out = np.zeros((h, total_w, 3), np.uint8)
    x = 0
    for f in frames:
        fh, fw = f.shape[:2]
        out[:fh, x:x + fw] = f
        x += fw + dist
    return out


def is_video_path(path) -> bool:
    return isinstance(path, str) and os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


def is_video(visual) -> bool:
    """A video path or a ``DecodedVideo``."""
    return isinstance(visual, DecodedVideo) or is_video_path(visual)
