"""The port's scoring facades (a copy of ``Score``, ``VQAScore``,
``CLIPScore`` and ``ITMScore`` from t2v_metrics_tpu/score.py, bound to the
port's registry).

  * ``forward(images, texts, **kwargs) -> (M, N)`` score matrix; singletons
    are promoted to lists;
  * video paths are routed by the adapter's ``video_mode``: ``"concat"``
    models get frames extracted and horizontally concatenated into one
    image, in memory;
  * ``batch_forward(dataset, batch_size) -> (num_samples, M, N)`` over any
    sequence of ``{"images": [...], "texts": [...]}`` samples (the media key
    may be ``"videos"``). Adapters with ``prepare_pairs`` and
    ``forward_device_prepared`` (clip-flant5) take the staged pipeline, a
    prep thread ahead of the device; adapters with ``forward_device``
    (Qwen) the async one.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import tracing
from .media.video import concatenate_horizontal, extract_frames, is_video_path
from .registry import (get_clipscore_model, get_itmscore_model, get_vqascore_model,
                       list_all_clipscore_models, list_all_itmscore_models,
                       list_all_vqascore_models)


class Score:
    """Base facade bound to a registry via subclass hooks.

    ``device``: "cuda" (the default: left out, it is the GPU, and raises
    without one) or "cpu", which runs only when asked for.
    """

    def __init__(self, model: str, device: str | None = None,
                 cache_dir: str | None = None, **kwargs):
        assert model in self.list_all_models() or self._accepts_dynamic(model), \
            f"model {model!r} not found; available: {self.list_all_models()}"
        self.device = device
        self.model = self.prepare_scoremodel(model, device, cache_dir, **kwargs)

    def _accepts_dynamic(self, model: str) -> bool:
        return False

    def prepare_scoremodel(self, model, device, cache_dir, **kwargs):
        raise NotImplementedError

    def list_all_models(self) -> list[str]:
        raise NotImplementedError

    # ------------------------------------------------------------------

    def _preprocess_media(self, images, num_frames: int):
        """Apply the video->concat route for image-only models."""
        if getattr(self.model, "video_mode", "direct") != "concat":
            return images
        out = []
        for image in images:
            if is_video_path(image):
                frames = extract_frames(image, num_frames, mode="step")
                out.append(concatenate_horizontal(frames, dist=10))
            else:
                out.append(image)
        return out

    def forward(self, images, texts, num_frames: int = 8, **kwargs) -> np.ndarray:
        with tracing.span("facade.call", request=True):
            return self._forward(images, texts, num_frames, **kwargs)

    __call__ = forward

    def _forward(self, images, texts, num_frames, **kwargs) -> np.ndarray:
        if isinstance(images, (str, np.ndarray)):
            images = [images]
        if isinstance(texts, str):
            texts = [texts]
        processed = self._preprocess_media(list(images), num_frames)

        if hasattr(self.model, "score_matrix"):
            scores = self.model.score_matrix(processed, list(texts), **kwargs)
        else:
            rows = [np.asarray(self.model.forward([img] * len(texts),
                                                  list(texts), **kwargs))
                    for img in processed]
            scores = np.stack(rows)
        return np.asarray(scores, np.float32)

    def batch_forward(self, dataset, batch_size: int = 16,
                      on_drain=None, **kwargs) -> np.ndarray:
        """dataset: sequence of {"images"|"videos": [...], "texts": [...]}.

        Returns (num_samples, num_media, num_texts) float32. ``batch_size``
        samples are flattened into one batched pairwise adapter call.

        on_drain: optional callable(hi) invoked from the main thread each
        time samples [lo, hi) finish (scores written to the output array).
        """
        with tracing.span("facade.batch", request=True):
            return self._batch_forward(dataset, batch_size, on_drain, **kwargs)

    def _batch_forward(self, dataset, batch_size, on_drain, **kwargs) -> np.ndarray:
        first = dataset[0]
        media_key = "videos" if "videos" in first else "images"
        num_media = len(first[media_key])
        num_texts = len(first["texts"])
        n = len(dataset)
        out = np.zeros((n, num_media, num_texts), np.float32)
        try:
            from tqdm import tqdm
            chunks = tqdm(range(0, n, batch_size), desc="batch_forward")
        except ImportError:  # pragma: no cover
            chunks = range(0, n, batch_size)

        batched = (hasattr(self.model, "forward")
                   and getattr(self.model, "video_mode", "direct") == "direct"
                   or media_key == "images")
        # Pipelined paths: chunk k's host preprocessing runs in a worker
        # thread while the main thread drains chunk k-1's result.
        threading_on = os.environ.get("T2V_PIPELINE_THREAD", "1") == "1"
        use_staged = (batched and threading_on
                      and hasattr(self.model, "prepare_pairs")
                      and hasattr(self.model, "forward_device_prepared"))
        use_async = batched and hasattr(self.model, "forward_device")
        if use_staged:
            return self._batch_forward_staged(dataset, chunks, batch_size,
                                              media_key, out, num_media,
                                              num_texts, on_drain=on_drain,
                                              **kwargs)
        executor = None
        if use_async and threading_on:
            executor = ThreadPoolExecutor(max_workers=1)
        depth = max(1, int(os.environ.get("T2V_PIPELINE_DEPTH", "3")))
        pending = deque()  # (lo, hi, future-or-(dev, cnt))

        def _drain_one():
            plo, phi, res = pending.popleft()
            dev, cnt = res.result() if executor is not None else res
            scores = np.asarray(dev, np.float32)[:cnt]
            out[plo:phi] = scores.reshape(phi - plo, num_media, num_texts)
            if on_drain is not None:
                on_drain(phi)

        try:
            for lo in chunks:
                hi = min(lo + batch_size, n)
                samples = [dataset[i] for i in range(lo, hi)]
                if batched:
                    pair_media, pair_text = self._flatten_pairs(
                        samples, media_key, kwargs.get("num_frames", 8))
                    if use_async:
                        if executor is not None:
                            res = executor.submit(self.model.forward_device,
                                                  pair_media, pair_text,
                                                  **kwargs)
                        else:
                            res = self.model.forward_device(pair_media,
                                                            pair_text,
                                                            **kwargs)
                        pending.append((lo, hi, res))
                        while len(pending) > depth:
                            _drain_one()
                    else:
                        scores = np.asarray(
                            self.model.forward(pair_media, pair_text,
                                               **kwargs),
                            np.float32)
                        out[lo:hi] = scores.reshape(hi - lo, num_media,
                                                    num_texts)
                else:  # pragma: no cover
                    for i, sample in enumerate(samples):
                        out[lo + i] = self.forward(sample[media_key],
                                                   sample["texts"], **kwargs)
            while pending:
                _drain_one()
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        return out

    def _flatten_pairs(self, samples, media_key, num_frames):
        pair_media, pair_text = [], []
        for sample in samples:
            media = self._preprocess_media(list(sample[media_key]),
                                           num_frames)
            for m in media:
                for t in sample["texts"]:
                    pair_media.append(m)
                    pair_text.append(t)
        return pair_media, pair_text

    @staticmethod
    def _chunk_plan(n, batch_size):
        """Chunk boundaries [(lo, hi), ...] covering [0, n).

        The first chunk is optionally split into smaller "ramp" sub-chunks
        (env ``T2V_PIPELINE_RAMP``, comma-separated sizes, default
        "32,32,64" when batch_size >= 128), so the device starts on a
        smaller first chunk."""
        plan = []
        ramp = os.environ.get("T2V_PIPELINE_RAMP",
                              "32,32,64" if batch_size >= 128 else "")
        lo = 0
        if ramp and n > batch_size:
            for part in ramp.split(","):
                size = min(int(part), n - lo)
                if size <= 0:
                    break
                plan.append((lo, lo + size))
                lo += size
        while lo < n:
            hi = min(lo + batch_size, n)
            plan.append((lo, hi))
            lo = hi
        return plan

    def _batch_forward_staged(self, dataset, chunks, batch_size, media_key,
                              out, num_media, num_texts, on_drain=None,
                              **kwargs):
        """Deep-pipelined batch_forward.

        Prep thread: decode/resize pixels + tokenize (pure host), up to
        ``prep_ahead`` chunks ahead of dispatch. Main thread: dispatch (the
        device call returns before the device finishes) and drain, keeping
        up to ``depth`` chunks in flight before blocking on the oldest.

        Staging-ring safety: prep of chunk k uses ring slot k % ring
        (``prepare_pairs(slot=...)``). A slot is reused only after the chunk
        that last used it has been drained: drain order is FIFO and
        ring > depth + prep_ahead + 1.
        """
        n = len(dataset)
        depth = max(1, int(os.environ.get("T2V_PIPELINE_DEPTH", "3")))
        prep_ahead = max(1, int(os.environ.get("T2V_PIPELINE_PREP_AHEAD", "3")))
        ring = depth + prep_ahead + 2
        plan = self._chunk_plan(n, batch_size)
        prep_ex = ThreadPoolExecutor(max_workers=1)
        prep_q = deque()    # (lo, hi, future[prep dict])
        inflight = deque()  # (lo, hi, dev, cnt)

        def _drain_one():
            plo, phi, dev, cnt = inflight.popleft()
            scores = np.asarray(dev, np.float32)[:cnt]
            out[plo:phi] = scores.reshape(phi - plo, num_media, num_texts)
            if on_drain is not None:
                on_drain(phi)

        def _prep(parent, pair_media, pair_text, slot):
            with tracing.span("facade.prep", parent=parent):
                return self.model.prepare_pairs(pair_media, pair_text, slot=slot, **kwargs)

        def _dispatch_one():
            plo, phi, fut = prep_q.popleft()
            with tracing.span("facade.prep_wait"):
                prep = fut.result()
            with tracing.span("facade.dispatch"):
                dev, cnt = self.model.forward_device_prepared(prep)
            inflight.append((plo, phi, dev, cnt))

        # keep the caller-visible progress bar (chunks is a tqdm range)
        progress = iter(chunks)

        try:
            drained = 0
            for idx, (lo, hi) in enumerate(plan):
                # ring-slot reuse guard: chunk idx - ring must be drained
                # before prep of chunk idx may overwrite its slot
                while drained < idx - ring + 1:
                    if not inflight:
                        _dispatch_one()
                    _drain_one()
                    drained += 1
                samples = [dataset[i] for i in range(lo, hi)]
                pair_media, pair_text = self._flatten_pairs(
                    samples, media_key, kwargs.get("num_frames", 8))
                prep_q.append((lo, hi, prep_ex.submit(
                    _prep, tracing.current(), pair_media, pair_text, idx % ring)))
                while len(prep_q) > prep_ahead:
                    _dispatch_one()
                    while len(inflight) > depth:
                        _drain_one()
                        drained += 1
                        next(progress, None)
            while prep_q:
                _dispatch_one()
            while inflight:
                _drain_one()
                drained += 1
                next(progress, None)
        finally:
            prep_ex.shutdown(wait=True)
        return out


class VQAScore(Score):
    """P("Yes") answer-likelihood scoring on PyTorch."""

    def prepare_scoremodel(self, model, device, cache_dir, **kwargs):
        return get_vqascore_model(model, device, cache_dir, **kwargs)

    def list_all_models(self) -> list[str]:
        return list_all_vqascore_models()


class CLIPScore(Score):
    """CLIP cosine-similarity scoring."""

    def prepare_scoremodel(self, model, device, cache_dir, **kwargs):
        return get_clipscore_model(model, device, cache_dir, **kwargs)

    def _accepts_dynamic(self, model: str) -> bool:
        # any OpenCLIP-style "pretrain_tag:Arch" with a known architecture
        from .models.adapters import resolve_clipscore_name

        return resolve_clipscore_name(model) is not None

    def list_all_models(self) -> list[str]:
        return list_all_clipscore_models()


class ITMScore(Score):
    """Image-text-matching scoring (BLIP-2's ITM head)."""

    def prepare_scoremodel(self, model, device, cache_dir, **kwargs):
        return get_itmscore_model(model, device, cache_dir, **kwargs)

    def list_all_models(self) -> list[str]:
        return list_all_itmscore_models()
