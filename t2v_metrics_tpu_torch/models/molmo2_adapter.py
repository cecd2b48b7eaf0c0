"""Molmo2 VQAScore adapter (port of t2v_metrics_tpu/models/molmo2_adapter.py).

Contract as the JAX adapter's (reference molmo2_model.py): the prompt
``User: `` + the image tokens + ``\\n{question} Assistant:`` bucketed to
``SEQ_BUCKETS``; the score is a greedy rollout (``max_new_tokens=1`` by
default) with the answer scored from its end, one step earlier when the
last generated id is eos, bos or pad (``generation.score_rollout``, the
rule Gemma 4 shares): batched on the device for more than one pair
(``CachedLM.greedy_batch`` with the answer ids' probabilities gathered at
every step), one sequence at a time for one. ``generate`` is the batched
greedy decode, or with sampling one sequence at a time (nucleus, with
``rng``, an ``np.random.Generator``); specials are dropped from the decode.

Images: bicubic straight to 336 x 336 (no crop; on the device with
``ops/image.py:resize_uint8_pillow_flat``, Pillow's fixed-point uint8
resize bit for bit, where the JAX adapter calls Pillow), then the CLIP mean
and std; a video (a path, read with cv2, or a
``media.video.DecodedVideo``) gives ``NATIVE_VIDEO_FRAMES`` frames at
``round(linspace(0, total - 1, 8))``. The tower runs once for each group
of same-shape distinct images and once for each distinct video.

Weights: ``params``; ``checkpoint`` (a native tree, its dims adopted where
they differ from the provisional registry ones); random with
``init='random'`` (or a model without a hub repo). Molmo2 ships only as
``trust_remote_code`` checkpoints, so otherwise it raises, as the JAX
adapter does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CLIP_MEAN, CLIP_STD
from ..engine.scoring import encode_by_shape, image_slot_arrays, pair_features, unique_visuals
from ..media.video import extract_frames, is_video
from ..ops.image import normalize_flat, resize_uint8_pillow_flat
from . import checkpoint as ckpt
from . import molmo2 as m2
from .adapters import VQAScoreModel, default_dtype, family_params
from .generation import CachedLM, decode_text, score_rollout
from .qwen2vl import splice_embeds

DEFAULT_QUESTION = 'Does this figure show "{}"? Please answer Yes or No.'
DEFAULT_ANSWER = "Yes"

SEQ_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n, buckets=SEQ_BUCKETS):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def clip_preprocess(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 images (N, H, W*3) on the device -> (N, size, size*3) fp32:
    bicubic straight to size x size as Pillow does it on uint8, /255, the
    CLIP mean and std."""
    x = resize_uint8_pillow_flat(pixels, size, size, 3)
    return normalize_flat(x / 255.0, CLIP_MEAN, CLIP_STD)


class Molmo2Adapter(VQAScoreModel):
    """Molmo2 VQAScore adapter (images and videos); see the module doc.
    kwargs: checkpoint, init='random', params (a ``Molmo2Model`` or a pytree
    in the JAX package's layout), config, seed, dtype (default bf16 on CUDA,
    fp32 on CPU), tokenizer (an object or a local directory)."""

    video_mode = "direct"

    def load_model(self):
        from ..bridge import molmo2_from_numpy

        spec = m2.MOLMO2_MODELS[self.model_name]
        cfg = self.kwargs.get("config") or spec["config"]
        path = self.kwargs.get("checkpoint")
        if self.kwargs.get("params") is None:
            if path is None and self.kwargs.get("init") != "random" \
                    and spec["hf"] is not None:
                raise RuntimeError(
                    f"no public HF implementation for {self.model_name} (Molmo2 is "
                    "trust_remote_code-only); pass checkpoint=<converted dir> or "
                    "init='random' (see models/molmo2.py)")
            if path is not None:
                dtype = self.kwargs.get("dtype") or default_dtype(self.device)
                tree, cfg = ckpt.load_with_adopted_dims(
                    path, cfg, lambda t, c: molmo2_from_numpy(t, c, "meta", dtype),
                    self.model_name, dtype)
                self.kwargs = dict(self.kwargs, params=tree)
        self.config = cfg
        # no HF layout to convert: a checkpoint is a native tree, loaded above
        self.params = family_params(self, None, cfg, m2.Molmo2Model, m2.init_molmo2, None,
                                    molmo2_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self._lm = CachedLM(cfg.text)

    def load_images(self, images):
        return images  # native video: paths pass straight through

    def _encode_text(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _eos_ids(self) -> set:
        return {getattr(self.tokenizer, "eos_token_id", None)} - {None}

    def _special_ids(self) -> set:
        ids = set()
        for attr in ("eos_token_id", "bos_token_id", "pad_token_id"):
            v = getattr(self.tokenizer, attr, None)
            if v is not None:
                ids.add(int(v))
        return ids

    def _features(self, px: torch.Tensor) -> torch.Tensor:
        """(N, H, W*3) uint8 pixels on the device -> (N, 144, d_model)."""
        cfg = self.config
        return m2.image_features(self.params, cfg, clip_preprocess(px, cfg.vision.image_size))

    @torch.inference_mode()
    def _encode_visuals(self, visuals) -> list:
        """Each visual's image-token features (frames x 144, d_model) on the
        device: same-shape images in one tower call, a video's frames in
        one."""
        out = [None] * len(visuals)
        images = [i for i, v in enumerate(visuals) if not is_video(v)]
        for i, f in zip(images, encode_by_shape([visuals[i] for i in images], self.device,
                                                self._features)):
            out[i] = f
        for i, v in enumerate(visuals):
            if out[i] is None:
                frames = np.stack(extract_frames(v, m2.NATIVE_VIDEO_FRAMES, mode="linspace"))
                px = torch.from_numpy(frames.reshape(*frames.shape[:2], -1)).to(self.device)
                out[i] = self._features(px).flatten(0, 1)
        return out

    def _prompt_embeds(self, visuals, questions):
        """(embeds (B, S, D) on the device in one bucket, prompt lengths
        (B,)) of the ``User: <image tokens>\\n{question} Assistant:`` prompts."""
        cfg = self.config
        uniq, inv = unique_visuals(visuals)
        encoded = self._encode_visuals(uniq)
        prompts = [self._encode_text("User: ") + [cfg.image_token_id] * encoded[inv[j]].shape[0]
                   + self._encode_text("\n" + q + " Assistant:")
                   for j, q in enumerate(questions)]
        s = _bucket(max(len(p) for p in prompts))
        dev = [torch.from_numpy(a).to(self.device)
               for a in image_slot_arrays(prompts, s, cfg.image_token_id)]
        embeds = splice_embeds(self.params, dev[0], pair_features(encoded, inv), *dev[1:])[0]
        return embeds, np.asarray([len(p) for p in prompts], np.int64)

    def _rollout(self, visual, question, max_new_tokens, temperature=1.0, sample=False,
                 top_p=0.9, rng=None):
        """One sequence's greedy (or nucleus) rollout: (generated ids, each
        step's distribution)."""
        embeds, lens = self._prompt_embeds([visual], [question])
        return self._lm.greedy(self.params.decoder, embeds, np.arange(embeds.shape[1])[None],
                               int(lens[0]), max_new_tokens, eos_ids=self._eos_ids(),
                               temperature=temperature, sample=sample, top_p=top_p, rng=rng)

    @torch.inference_mode()
    def forward(self, images, texts, fps=None, question_template: str = DEFAULT_QUESTION,
                answer_template: str = DEFAULT_ANSWER, max_new_tokens: int = 1,
                temperature: float = 1.0, **kw) -> np.ndarray:
        """Rollout scores of the pairs (reference molmo2_model.py:146-214)."""
        if len(images) != len(texts):
            raise ValueError("forward: one image per text")
        questions = [question_template.format(t) for t in texts]
        answers = [self._encode_text(answer_template.format(t)) for t in texts]
        special = self._special_ids()
        if len(images) > 1:
            return self._forward_batched(images, questions, answers, max_new_tokens,
                                         temperature, special)
        probs = []
        for visual, question, ans in zip(images, questions, answers):
            gen, dists = self._rollout(visual, question, max_new_tokens, temperature)
            probs.append(score_rollout(dists, gen, ans, special))
        return np.asarray(probs, np.float32)

    def forward_device(self, images, texts, **kw):
        """(scores, count) for ``Score.batch_forward``: the rollout reads its
        tokens back, so the scores are already on the host."""
        return self.forward(images, texts, **kw), len(texts)

    def _forward_batched(self, images, questions, answers, max_new_tokens, temperature,
                         special) -> np.ndarray:
        """One batched greedy rollout with each step's probabilities of the
        answer ids gathered on the device (it stops at the smallest eos id,
        as the JAX adapter's batched path does)."""
        embeds, lens = self._prompt_embeds(images, questions)
        b, s = embeds.shape[:2]
        gather = np.zeros((b, max(len(a) for a in answers)), np.int64)
        for j, ans in enumerate(answers):
            gather[j, :len(ans)] = ans
        eos = self._eos_ids()
        tokens, lengths, probs = self._lm.greedy_batch(
            self.params.decoder, embeds, np.tile(np.arange(s), (b, 1)), lens,
            max_new_tokens, eos_id=min(eos) if eos else None, gather_ids=gather,
            temperature=temperature)
        out = []
        for j, ans in enumerate(answers):
            length = int(lengths[j])
            # probs[j, t, i] is P(answer id i) at step t: the end-aligned rule
            # over the answer's own indices
            out.append(score_rollout([probs[j, t] for t in range(length)],
                                     tokens[j, :length].tolist(), list(range(len(ans))),
                                     special))
        return np.asarray(out, np.float32)

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)

    @torch.inference_mode()
    def generate(self, images, texts, fps=None, max_new_tokens: int = 1024,
                 temperature: float = 0.0, do_sample=None, top_p: float = 0.9, rng=None,
                 **kw) -> list[str]:
        """Greedy continuation of the prompts in one batched decode, or with
        sampling one sequence at a time (reference molmo2_model.py:220-262)."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        if do_sample is None:
            do_sample = temperature > 0
        special = self._special_ids()
        if not (do_sample and temperature > 0):
            embeds, lens = self._prompt_embeds(images, texts)
            b, s = embeds.shape[:2]
            eos = self._eos_ids()
            tokens, lengths = self._lm.greedy_batch(
                self.params.decoder, embeds, np.tile(np.arange(s), (b, 1)), lens,
                max_new_tokens, eos_id=min(eos) if eos else None)
            return [decode_text(self.tokenizer, tokens[j, :lengths[j]].tolist(), special)
                    for j in range(b)]
        outs = []
        for visual, text in zip(images, texts):
            gen, _ = self._rollout(visual, text, max_new_tokens, temperature, sample=True,
                                   top_p=top_p, rng=rng)
            outs.append(decode_text(self.tokenizer, gen, special))
        return outs
