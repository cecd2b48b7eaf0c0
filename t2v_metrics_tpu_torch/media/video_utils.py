"""Legacy video-loading utilities: the Apollo-era loaders (a copy of
t2v_metrics_tpu/media/video_utils.py, same names and algorithms).

``pad_to_center_square``, ``calculate_sample_indices`` (clip-based frame
indices with timestamps, including the low-fps branch that repeats
frames), ``get_video_details``, ``load_frames_from_video``,
``split_into_clips``, ``opencv_extract_frames`` and the token-budgeted
``ApolloMMLoader``, whose clip sampling ratio scales coverage to a
``model_max_length`` token budget.

Frames are read with OpenCV's position seek only, through ``media/video.py``
(cv2 is imported when a file is read); the JAX package's native libav
branch is left out, as it is for ``extract_frames``. A file that does not
open, or gives no frame, raises ``media.video.MediaError``.
"""

from __future__ import annotations

import math

import numpy as np

from .video import MediaError, open_video, video_info


def pad_to_center_square(frames: np.ndarray, mean_values) -> np.ndarray:
    """Pad (H, W, C) or (N, H, W, C) frames to square with a fill color."""
    if frames.ndim == 3:
        frames = frames[np.newaxis]
    elif frames.ndim != 4:
        raise ValueError("expected (H, W, C) or (N, H, W, C)")
    n, h, w, c = frames.shape
    size = max(h, w)
    out = np.full((n, size, size, c), np.array(mean_values, frames.dtype),
                  dtype=frames.dtype)
    top, left = (size - h) // 2, (size - w) // 2
    out[:, top:top + h, left:left + w] = frames
    return out


def calculate_sample_indices(clip_duration, frames_per_clip, total_frames,
                             original_fps, video_duration,
                             clip_sampling_ratio=1):
    """Clip-based frame-index selection with timestamps: (clip_indices,
    all_indices, timestamps), one (first, last) pair of seconds a clip."""
    sample_video_fps = frames_per_clip / clip_duration
    num_clips = math.ceil((video_duration / clip_duration) * clip_sampling_ratio)
    num_clips = max(num_clips, 1)
    frame_step = original_fps / sample_video_fps
    partition_len = total_frames // num_clips
    all_indices, clip_indices, timestamps = [], [], []
    if frame_step > 0.5:
        frame_step = max(1, int(original_fps / sample_video_fps))
        clip_len = int(frames_per_clip * frame_step)
        sample_len = min(clip_len, total_frames)
        clip_step = ((total_frames - clip_len) // max(1, num_clips - 1)
                     if total_frames > clip_len else 0)
        for i in range(num_clips):
            if partition_len > clip_len:
                start = (partition_len - clip_len) // 2
                indices = np.arange(start, start + clip_len, frame_step)
                indices = np.clip(indices, 0, partition_len - 1).astype(np.int64)
                indices = indices + i * partition_len
            else:
                indices = np.arange(0, sample_len, frame_step)
                if len(indices) < frames_per_clip:
                    indices = np.concatenate(
                        [indices, np.full(frames_per_clip - len(indices),
                                          sample_len)])
                indices = np.clip(indices, 0, sample_len - 1).astype(np.int64)
                indices = indices + i * clip_step
            clip_indices.append(indices)
            all_indices.extend(indices.tolist())
            timestamps.append((indices[0] / original_fps,
                               indices[-1] / original_fps))
    else:
        # source fps too low: repeat frames
        num_sample = int(np.ceil(1 / frame_step))
        clip_len = int(frames_per_clip * frame_step)
        indices = np.repeat(np.arange(max(clip_len, 1)), num_sample)
        clip_len = min(clip_len, len(indices))
        clip_step = ((total_frames - clip_len) // max(1, num_clips - 1)
                     if total_frames > clip_len else 0)
        sample_len = min(clip_len, total_frames)
        if len(indices) < frames_per_clip:
            indices = np.concatenate(
                [indices, np.full(frames_per_clip - len(indices), sample_len)])
        for i in range(num_clips):
            cur = np.clip(indices, 0, max(sample_len - 1, 0)).astype(np.int64)
            cur = cur + i * clip_step
            clip_indices.append(cur)
            all_indices.extend(cur.tolist())
            timestamps.append((cur[0] / original_fps, cur[-1] / original_fps))
    return clip_indices, all_indices, timestamps


def get_video_details(path: str):
    """(total_frames, fps, duration_seconds)."""
    info = video_info(path)
    fps = info["fps"] or 30.0
    total = info["total_frames"]
    return total, fps, total / max(fps, 1e-6)


def load_frames_from_video(path: str, indices) -> np.ndarray:
    """Decode the given frame indices, in their order, as (N, H, W, 3) uint8
    RGB; an index that cannot be read is skipped."""
    with open_video(path) as (_, _, read):
        frames = [f for f in map(read, indices) if f is not None]
    if not frames:
        raise MediaError(f"no readable frame in video {path}")
    return np.stack(frames)


def split_into_clips(video: np.ndarray, frames_per_clip: int):
    nc = len(video) // frames_per_clip
    return [video[i * frames_per_clip:(i + 1) * frames_per_clip]
            for i in range(nc)]


def opencv_extract_frames(path: str, num_frames: int) -> list[np.ndarray]:
    """Evenly-spaced frame extraction."""
    total, fps, _ = get_video_details(path)
    idx = np.linspace(0, max(total - 1, 0), num_frames, dtype=np.int64)
    return [f for f in load_frames_from_video(path, idx)]


class ApolloMMLoader:
    """Token-budgeted clip loader: scales the clip sampling ratio so the
    video's tokens fit ``model_max_length``."""

    def __init__(self, clip_duration=2.0, frames_per_clip=4,
                 num_repeat_token=16, model_max_length=32768,
                 clip_sampling_ratio=1.0, preprocess=None):
        self.clip_duration = clip_duration
        self.frames_per_clip = frames_per_clip
        self.num_repeat_token = num_repeat_token
        self.model_max_length = model_max_length
        self.clip_sampling_ratio = clip_sampling_ratio
        self.preprocess = preprocess

    def effective_sampling_ratio(self, video_duration: float) -> float:
        full = video_duration * self.num_repeat_token / self.clip_duration
        return min(1.0, (self.model_max_length * self.clip_sampling_ratio)
                   / max(full, 1e-6))

    def load_video(self, path: str):
        """(clips, timestamps): the sampled frames split into clips of
        ``frames_per_clip`` (each through ``preprocess`` where given) and
        each clip's (first, last) seconds."""
        total, fps, duration = get_video_details(path)
        ratio = self.effective_sampling_ratio(duration)
        clip_indices, all_indices, timestamps = calculate_sample_indices(
            self.clip_duration, self.frames_per_clip, total, fps, duration,
            clip_sampling_ratio=ratio)
        buffer = load_frames_from_video(path, all_indices)
        clips = split_into_clips(buffer, self.frames_per_clip)
        if self.preprocess is not None:
            clips = [self.preprocess(c) for c in clips]
        return clips, timestamps
