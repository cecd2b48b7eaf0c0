"""Gemma 3 VQAScore adapter, image and video scoring (port of the Gemma 3
scoring half of t2v_metrics_tpu/models/gemma_adapters.py).

Contract as the JAX adapter's: the prompt ``<start_of_turn>user\\n`` + the
image block (begin-of-image, 256 image tokens, end-of-image) + the question
+ ``<end_of_turn>\\n<start_of_turn>model\\n``, the answer teacher-forced
behind it, P(answer tokens) with the temperature applied before an fp32
log-softmax, geometric mean over the answer tokens, default question 'Does
this figure show "{}"? Please answer Yes or No.' and answer "Yes"; the
sequence bucketed to ``SEQ_BUCKETS``.

Images arrive as uint8 HWC arrays (paths and PIL images decode with PIL,
imported only for them). The SigLIP preprocess (bicubic to 896 x 896, /255,
normalize with mean and std 0.5) runs on the device with the port's
Pillow-style two-pass uint8 resize (within one uint8 level of Pillow, and
exact where the image already has the tower's size); the JAX adapter
resizes with Pillow on the host. The tower encodes each distinct image once,
one batched call per group of same-shape images, where the JAX adapter
calls it once per pair (the tower is per image, so the numbers are the
same). A video (a path, read with cv2, or a ``media.video.DecodedVideo``)
gives ``num_frames`` frames (default 10) at truncated linspace indices, each
an image block behind its "Frame at {t}s:" text, as in the JAX adapter; each
distinct video's frames go through the tower in one call, and each frame's
block attends bidirectionally within itself.

``generate`` (the JAX adapter's): with more than one visual and no sampling
a batched greedy decode on the device (``CachedLM.greedy_batch``, stopping
at the smallest end-of-turn id, as the JAX batched path does); otherwise one
sequence at a time (``CachedLM.greedy``, stopping at any of them, nucleus
sampling when ``do_sample`` and ``temperature > 0``). The image blocks
attend bidirectionally at the prefill; generated tokens join none.
PaliGemma and Gemma 4 are later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SIGLIP_MEAN, SIGLIP_STD
from ..engine.scoring import _HostScores, encode_by_shape, unique_visuals
from ..media.video import is_video, open_video
from ..ops.image import normalize_flat, resize_uint8_levels_flat
from . import gemma3 as g3
from . import checkpoint as ckpt
from .adapters import VQAScoreModel, default_dtype, load_checkpoint_tree
from .generation import CachedLM, decode_text

DEFAULT_QUESTION = 'Does this figure show "{}"? Please answer Yes or No.'
DEFAULT_ANSWER = "Yes"

SEQ_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n, buckets=SEQ_BUCKETS):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def siglip_preprocess(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 images (N, H, W*3) on the device -> (N, size, size*3) fp32:
    bicubic resize as Pillow does it on uint8, /255, (x - 0.5) / 0.5."""
    x = resize_uint8_levels_flat(pixels.float(), size, size, 3)
    return normalize_flat(x / 255.0, SIGLIP_MEAN, SIGLIP_STD)


class _GemmaBase(VQAScoreModel):
    """What the Gemma family's adapters share: text encoding and frame
    extraction."""

    def _encode_text(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _eos_ids(self) -> set:
        """The tokenizer's eos id and ``<end_of_turn>``'s, where it has them."""
        ids = set()
        t = getattr(self.tokenizer, "eos_token_id", None)
        if t is not None:
            ids.add(int(t))
        conv = getattr(self.tokenizer, "convert_tokens_to_ids", None)
        if conv is not None:
            for tok in ("<end_of_turn>",):
                try:
                    i = conv(tok)
                except Exception:
                    continue
                if isinstance(i, int) and i >= 0:
                    ids.add(i)
        return ids

    @staticmethod
    def _group_ids_np(vis_mask: np.ndarray) -> np.ndarray:
        """(S,) bool -> per-contiguous-block group ids, -1 on text (the host
        mirror of gemma3.image_group_ids)."""
        m = vis_mask.astype(np.int32)
        starts = m * (1 - np.concatenate([[0], m[:-1]]))
        gid = np.cumsum(starts) - 1
        return np.where(vis_mask, gid, -1).astype(np.int32)

    @staticmethod
    def _extract_frames(video, num_frames=10):
        """(timestamp in seconds, RGB uint8 frame) pairs of a video path or
        ``DecodedVideo`` at ``linspace(0, total - 1, num_frames)`` truncated
        to int (the JAX adapter's indices); unreadable frames are left
        out."""
        with open_video(video) as (total, fps, read):
            frames = []
            for i in np.linspace(0, total - 1, num_frames, dtype=int):
                frame = read(i)
                if frame is not None:
                    frames.append((round(i / fps, 2), np.ascontiguousarray(frame)))
        if not frames:
            raise ValueError(f"no readable frame in video {video}")
        return frames


class Gemma3Adapter(_GemmaBase):
    """Gemma 3 VQAScore adapter (images and videos).

    Weights: ``params``; else random with ``init='random'`` (or a model
    without a hub repo); else the pretrained ``hf`` repo's snapshot from the
    local Hugging Face cache, as the JAX adapter loads it (never
    downloaded), or the directory given as ``checkpoint`` (an HF model
    directory or a native tree).

    kwargs: checkpoint, init='random' (random weights on the device from
    ``seed``), params (a ``Gemma3Model``, or a pytree in the JAX package's
    layout with numpy or CPU tensor leaves, carried over by ``bridge.py``),
    config (a ``Gemma3Config``), seed, dtype (default bf16 on CUDA, fp32 on
    CPU), tokenizer (an object or a local directory).
    """

    video_mode = "direct"

    def load_model(self):
        spec = g3.GEMMA3_MODELS[self.model_name]
        cfg: g3.Gemma3Config = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        params = self.kwargs.get("params")
        if params is None:
            path = self.kwargs.get("checkpoint")
            if path is None and self.kwargs.get("init") != "random" \
                    and spec["hf"] is not None:
                path = ckpt.resolve_snapshot(spec["hf"], self.cache_dir)
            if path is not None:
                params = self._load_checkpoint(path, cfg, dtype)
            else:
                params = g3.init_gemma3(cfg, self.kwargs.get("seed", 0), device, dtype)
        if not isinstance(params, g3.Gemma3Model):
            from ..bridge import gemma3_from_numpy

            params = gemma3_from_numpy(params, cfg, device, dtype)
        self.params = params
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)

    def _load_checkpoint(self, path: str, cfg, dtype) -> dict:
        from ..bridge import gemma3_from_numpy

        return load_checkpoint_tree(path, g3.convert_gemma3, gemma3_from_numpy, cfg,
                                    self.model_name, dtype)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    def _image_block_ids(self):
        cfg = self.config
        return ([cfg.boi_token_id] + [cfg.image_token_id] * cfg.mm_tokens_per_image
                + [cfg.eoi_token_id])

    def _assemble(self, question, timestamps=None):
        """Prompt ids of one (visual, question) pair (the JAX adapter's
        ``_assemble``): one image block, or for a video each frame's
        "Frame at {t}s:" and image block."""
        ids = self._encode_text("<start_of_turn>user\n")
        if timestamps is None:
            ids += self._image_block_ids()
        for ts in timestamps or ():
            ids += self._encode_text(f"Frame at {ts}s:") + self._image_block_ids()
        return ids + self._encode_text(question + "<end_of_turn>\n"
                                       "<start_of_turn>model\n")

    def _features(self, px):
        """(N, H, W*3) uint8 pixels on the device -> (N, mm_tokens_per_image,
        d_model) soft tokens."""
        cfg = self.config
        return g3.image_features(self.params, cfg,
                                 siglip_preprocess(px, cfg.vision.image_size))

    @torch.inference_mode()
    def _encode_images(self, visuals):
        """Soft tokens of each image, (mm_tokens_per_image, d_model) on the
        device: one preprocess and tower call per group of same-shape
        images."""
        return encode_by_shape(visuals, self.device, self._features)

    @torch.inference_mode()
    def _encode_visuals(self, visuals, num_frames=10):
        """Soft tokens of each image or video on the device, (frames x
        mm_tokens_per_image, d_model), and its frame timestamps (None for
        an image): each video's frames in one tower call."""
        videos = {i: self._extract_frames(v, num_frames)
                  for i, v in enumerate(visuals) if is_video(v)}
        images = [i for i in range(len(visuals)) if i not in videos]
        out = [None] * len(visuals)
        for i, f in zip(images, self._encode_images([visuals[i] for i in images])):
            out[i] = (f, None)
        for i, frames in videos.items():
            stack = np.stack([f for _, f in frames])
            px = torch.from_numpy(stack.reshape(*stack.shape[:2], -1)).to(self.device)
            out[i] = (self._features(px).flatten(0, 1), [ts for ts, _ in frames])
        return out

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts, num_frames: int = 10,
                       question_template: str = DEFAULT_QUESTION,
                       answer_template: str = DEFAULT_ANSWER,
                       temperature: float = 1.0, **kw):
        """Pairwise scoring -> (scores, count); ``images`` may hold videos,
        ``num_frames`` frames each. The scores stay on the device until
        ``np.asarray`` copies them to the host, so a caller can queue the
        next chunk first (``Score.batch_forward``)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        cfg = self.config
        uniq, inv = unique_visuals(images)
        encoded = self._encode_visuals(uniq, num_frames)
        # each visual's soft tokens padded to the longest, gathered per pair
        t_max = max(f.shape[0] for f, _ in encoded)
        padded = torch.stack([torch.nn.functional.pad(f, (0, 0, 0, t_max - f.shape[0]))
                              for f, _ in encoded])
        feats = padded[torch.as_tensor(inv, device=padded.device)]

        per_pair = [(self._assemble(question_template.format(t), encoded[inv[j]][1]),
                     self._encode_text(answer_template.format(t)))
                    for j, t in enumerate(texts)]
        p = len(per_pair)
        s = _bucket(max(len(i) + len(a) for i, a in per_pair))
        a_max = max(len(a) for _, a in per_pair)
        ids_arr = np.zeros((p, s), np.int64)
        vis_mask = np.zeros((p, s), bool)
        vis_slot = np.zeros((p, s), np.int64)
        attn = np.zeros((p, s), bool)
        ans_ids = np.zeros((p, a_max), np.int64)
        ans_pos = np.zeros((p, a_max), np.int64)
        ans_mask = np.zeros((p, a_max), np.float32)
        for j, (ids, ans) in enumerate(per_pair):
            n = len(ids)
            ids_arr[j, :n] = ids
            ids_arr[j, n:n + len(ans)] = ans
            attn[j, :n + len(ans)] = True
            vm = ids_arr[j] == cfg.image_token_id
            vm[n:] = False
            vis_mask[j] = vm
            vis_slot[j][vm] = np.arange(vm.sum())
            ans_ids[j, : len(ans)] = ans
            ans_pos[j, : len(ans)] = n - 1 + np.arange(len(ans))
            ans_mask[j, : len(ans)] = 1.0
        pos = np.broadcast_to(np.arange(s)[None], (p, s)).copy()
        dev = [torch.from_numpy(a).to(self.device)
               for a in (ids_arr, vis_mask, vis_slot, pos, attn, ans_ids, ans_pos,
                         ans_mask)]
        logp = g3.splice_and_score(self.params, cfg, dev[0], feats, *dev[1:],
                                   temperature=float(temperature))
        return _HostScores(torch.exp(logp.float())), p

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)

    @property
    def _lm(self) -> CachedLM:
        if getattr(self, "_cached_lm", None) is None:
            self._cached_lm = CachedLM(self.config.text,
                                       embed_scale=self.config.text.d_model ** 0.5)
        return self._cached_lm

    @torch.inference_mode()
    def generate(self, images, texts, num_frames: int = 10, fps=None,
                 max_new_tokens: int = 1024, temperature: float = 0.0,
                 do_sample=None, top_p: float = 0.9, **kw) -> list[str]:
        """Free-form continuation (reference gemma3_model.py:244-286): the
        batched greedy decode for more than one visual without sampling,
        else one sequence at a time."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        eos = self._eos_ids()
        if do_sample is None:
            do_sample = temperature > 0
        if len(images) > 1 and not do_sample:
            return self._generate_batched(images, texts, num_frames, max_new_tokens, eos)
        sample = bool(do_sample and temperature > 0)
        outs = []
        for visual, text in zip(images, texts):
            embeds, n_prompts, bidir_full = self._prompt_embeds([visual], [text],
                                                                num_frames, max_new_tokens)
            gen, _ = self._lm.greedy(
                self.params.decoder, embeds, np.arange(embeds.shape[1])[None],
                int(n_prompts[0]), max_new_tokens, eos_ids=eos, bidir_full=bidir_full,
                sample=sample, temperature=temperature if sample else 1.0, top_p=top_p)
            outs.append(decode_text(self.tokenizer, gen, eos))
        return outs

    def _prompt_embeds(self, visuals, texts, num_frames, max_new_tokens):
        """Generation prompts of (visual, text) pairs, padded to one bucket:
        (embeds (B, S, D) on the device, prompt lengths (B,), the
        cache-aligned image-block ids (B, S + max_new_tokens), -1 on text
        and generated slots)."""
        cfg = self.config
        uniq, inv = unique_visuals(visuals)
        encoded = self._encode_visuals(uniq, num_frames)
        prompts = [self._assemble(t, encoded[inv[j]][1]) for j, t in enumerate(texts)]
        b = len(prompts)
        s = _bucket(max(len(p) for p in prompts))
        ids_arr = np.zeros((b, s), np.int64)
        vis_mask = np.zeros((b, s), bool)
        vis_slot = np.zeros((b, s), np.int64)
        n_prompts = np.zeros((b,), np.int32)
        bidir_full = np.full((b, s + max_new_tokens), -1, np.int32)
        for j, ids in enumerate(prompts):
            n = len(ids)
            ids_arr[j, :n] = ids
            vm = ids_arr[j] == cfg.image_token_id
            vm[n:] = False
            vis_mask[j] = vm
            vis_slot[j][vm] = np.arange(vm.sum())
            n_prompts[j] = n
            bidir_full[j, :s] = self._group_ids_np(vm)
        t_max = max(f.shape[0] for f, _ in encoded)
        padded = torch.stack([torch.nn.functional.pad(f, (0, 0, 0, t_max - f.shape[0]))
                              for f, _ in encoded])
        feats = padded[torch.as_tensor(inv, device=padded.device)]
        dev = [torch.from_numpy(a).to(self.device) for a in (ids_arr, vis_mask, vis_slot)]
        return g3.splice_embeds(self.params, cfg, dev[0], feats, *dev[1:]), n_prompts, bidir_full

    def _generate_batched(self, images, texts, num_frames, max_new_tokens, eos) -> list[str]:
        """Batched greedy decode with each row's image blocks; it stops at
        the smallest eos id, as the JAX adapter's batched path does."""
        embeds, n_prompts, bidir_full = self._prompt_embeds(images, texts, num_frames,
                                                            max_new_tokens)
        b, s = embeds.shape[:2]
        tokens, lengths = self._lm.greedy_batch(
            self.params.decoder, embeds, np.broadcast_to(np.arange(s), (b, s)).copy(),
            n_prompts, max_new_tokens, eos_id=min(eos) if eos else None,
            bidir_full=bidir_full)
        return [decode_text(self.tokenizer, tokens[j, : lengths[j]].tolist(), eos)
                for j in range(b)]
