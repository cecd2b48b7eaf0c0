"""Host-side video frames (a copy of ``_open_capture``, ``video_info``,
``is_video_path``, ``extract_frames``, ``concatenate_horizontal``,
``concatenate_vertical`` and ``concatenate_grid`` from
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


def video_info(video_path: str) -> dict:
    """Frame count, frames per second (30.0 where the file gives 0), width
    and height of a video file."""
    cap, cv2 = _open_capture(video_path)
    try:
        return {
            "total_frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "fps": float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()


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


def concatenate_vertical(frames: list[np.ndarray], dist: int = 10) -> np.ndarray:
    """Concatenate frames top-to-bottom on black, left-aligned."""
    w = max(f.shape[1] for f in frames)
    total_h = sum(f.shape[0] for f in frames) + dist * (len(frames) - 1)
    out = np.zeros((total_h, w, 3), np.uint8)
    y = 0
    for f in frames:
        fh, fw = f.shape[:2]
        out[y:y + fh, :fw] = f
        y += fh + dist
    return out


def concatenate_grid(frames: list[np.ndarray], dist: int = 10,
                     output_size: tuple[int, int] = (1024, 1024)) -> np.ndarray:
    """A square grid collage on black, at least 2 x 2: each frame resized
    with cv2's Lanczos to fit its cell with its aspect kept, and centred
    there."""
    import cv2
    from math import ceil, sqrt

    n = len(frames)
    grid = max(2, ceil(sqrt(n)))
    cw = (output_size[0] - dist * (grid - 1)) // grid
    ch = (output_size[1] - dist * (grid - 1)) // grid
    out = np.zeros((output_size[1], output_size[0], 3), np.uint8)
    for i, f in enumerate(frames):
        ratio = f.shape[1] / f.shape[0]
        if ratio > cw / ch:
            nw, nh = cw, int(cw / ratio)
        else:
            nw, nh = int(ch * ratio), ch
        rs = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LANCZOS4)
        row, col = i // grid, i % grid
        x = col * (cw + dist) + (cw - nw) // 2
        y = row * (ch + dist) + (ch - nh) // 2
        out[y:y + nh, x:x + nw] = rs
    return out


def is_video_path(path) -> bool:
    return isinstance(path, str) and os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


def is_video(visual) -> bool:
    """A video path or a ``DecodedVideo``."""
    return isinstance(visual, DecodedVideo) or is_video_path(visual)
