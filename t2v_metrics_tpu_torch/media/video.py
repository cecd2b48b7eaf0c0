"""Host-side video frames for the ``concat`` route of ``Score`` (a copy of
``is_video_path``, ``extract_frames`` and ``concatenate_horizontal`` from
t2v_metrics_tpu/media/video.py, without its native libav reader).

Frames are decoded with OpenCV, imported only when a video is read; where
cv2 is missing, a video path raises ImportError.

Frame index selection: ``step`` mode ``i * (total // n)``; ``linspace``
mode ``round(linspace(0, total-1, n))``.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import VIDEO_EXTENSIONS


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
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise IOError(f"cannot open video {video_path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        native_fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        if fps is not None:
            n = max(int(total / native_fps * fps), 1)
            idx = frame_indices(total, n, "linspace")
        else:
            idx = frame_indices(total, num_frames, mode)
        frames = []
        for i in idx:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if not ok:
                continue
            frames.append(frame[:, :, ::-1].copy())  # BGR -> RGB
        return frames
    finally:
        cap.release()


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
