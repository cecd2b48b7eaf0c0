"""Gemma 3, PaliGemma and Gemma 4 VQAScore adapters (port of
t2v_metrics_tpu/models/gemma_adapters.py). PaliGemma's and Gemma 4's
contracts are stated on their classes; Gemma 3's follows.

Contract as the JAX adapter's: the prompt ``<start_of_turn>user\\n`` + the
image block (begin-of-image, 256 image tokens, end-of-image) + the question
+ ``<end_of_turn>\\n<start_of_turn>model\\n``, the answer teacher-forced
behind it, P(answer tokens) with the temperature applied before an fp32
log-softmax, geometric mean over the answer tokens, default question 'Does
this figure show "{}"? Please answer Yes or No.' and answer "Yes"; the
sequence bucketed to ``SEQ_BUCKETS``.

Images arrive as uint8 HWC arrays (paths and PIL images decode with PIL,
imported only for them). The SigLIP preprocess (bicubic to 896 x 896, /255,
normalize with mean and std 0.5) runs on the device with Pillow's
fixed-point uint8 resize, bit for bit (``ops/image.py:
resize_uint8_pillow_flat``); the JAX adapter resizes with Pillow on the
host. The tower encodes each distinct image once,
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
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SIGLIP_MEAN, SIGLIP_STD
from ..engine.scoring import _HostScores, encode_by_shape, unique_visuals
from ..media.video import MediaError, is_video, open_video
from ..ops.image import normalize_flat, resize_uint8_pillow_flat
from . import checkpoint as ckpt
from . import gemma3 as g3
from . import gemma4 as g4
from . import paligemma as pg
from .adapters import VQAScoreModel, default_dtype, family_params
from .generation import CachedLM, decode_text, score_rollout

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
    bicubic resize as Pillow does it on uint8, bit for bit, /255, (x - 0.5)
    / 0.5."""
    x = resize_uint8_pillow_flat(pixels, size, size, 3)
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
            raise MediaError(f"no readable frame in video {video}")
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
        from ..bridge import gemma3_from_numpy

        spec = g3.GEMMA3_MODELS[self.model_name]
        cfg: g3.Gemma3Config = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, g3.Gemma3Model, g3.init_gemma3,
                                    g3.convert_gemma3, gemma3_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)

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


class PaliGemmaAdapter(_GemmaBase):
    """PaliGemma VQAScore adapter (images; videos reach it as concatenated
    frames through the facade).

    The prompt is the image tokens, BOS, then the question and a newline;
    image and prompt form the prefix-LM's bidirectional group. The score is
    the fp32 probability of the answer's first content id (the first
    non-BOS id of its encoding) at the first generated step, as the JAX
    adapter takes it. ``generate`` decodes the whole output, prompt text
    included, with specials skipped, one sequence at a time.

    Weights and kwargs as ``Gemma3Adapter``'s (params: a ``PaliGemmaModel``
    or a pytree in the JAX package's layout; config: a
    ``PaliGemmaConfig``; checkpoint: an HF PaliGemmaForConditionalGeneration
    directory or a native tree).
    """

    video_mode = "concat"

    def load_model(self):
        from ..bridge import paligemma_from_numpy

        spec = pg.PALIGEMMA_MODELS[self.model_name]
        cfg: pg.PaliGemmaConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, pg.PaliGemmaModel,
                                    pg.init_paligemma, pg.convert_paligemma,
                                    paligemma_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    @torch.inference_mode()
    def _encode_images(self, visuals):
        """Each image's (num_patches, d_model) features on the device: one
        preprocess and tower call per group of same-shape images."""
        cfg = self.config
        return encode_by_shape(visuals, self.device, lambda px: pg.image_features(
            self.params, cfg, siglip_preprocess(px, cfg.vision.image_size)))

    def _prompt_ids(self, text: str) -> list[int]:
        cfg = self.config
        return ([cfg.image_token_id] * cfg.num_image_tokens + [cfg.bos_token_id]
                + self._encode_text(text + "\n"))

    def _first_answer_token(self, answer: str) -> int:
        """The answer's first content id: a tokenizer that puts BOS first
        even without special tokens would otherwise score BOS."""
        bos = getattr(self.tokenizer, "bos_token_id", None)
        return next(i for i in self._encode_text(answer) if i != bos)

    def _prefix_arrays(self, prompts, s):
        """(ids, vis_mask, vis_slot, attn / prefix mask) (B, s) of prompts
        padded to the bucket ``s``."""
        n_vis = self.config.num_image_tokens
        b = len(prompts)
        ids = np.zeros((b, s), np.int64)
        vis_mask = np.zeros((b, s), bool)
        vis_slot = np.zeros((b, s), np.int64)
        prefix = np.zeros((b, s), bool)
        for j, p in enumerate(prompts):
            ids[j, :len(p)] = p
            prefix[j, :len(p)] = True
            vis_mask[j, :n_vis] = True
            vis_slot[j, :n_vis] = np.arange(n_vis)
        return ids, vis_mask, vis_slot, prefix

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts, question_template: str = DEFAULT_QUESTION,
                       answer_template: str = DEFAULT_ANSWER, **kw):
        """Pairwise scoring -> (scores still on the device, count)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        cfg = self.config
        uniq, inv = unique_visuals(images)
        encoded = torch.stack(self._encode_images(uniq))
        feats = encoded[torch.as_tensor(inv, device=encoded.device)]
        prompts = [self._prompt_ids(question_template.format(t)) for t in texts]
        p, s = len(prompts), _bucket(max(len(x) for x in prompts))
        ids, vis_mask, vis_slot, prefix = self._prefix_arrays(prompts, s)
        pos = np.broadcast_to(np.arange(s)[None], (p, s)).copy()
        last = np.asarray([len(x) - 1 for x in prompts], np.int64)
        dev = [torch.from_numpy(a).to(self.device)
               for a in (ids, vis_mask, vis_slot, pos, prefix, prefix, last)]
        dist = pg.first_token_distribution(self.params, cfg, dev[0], feats, *dev[1:])
        ans = torch.as_tensor([self._first_answer_token(answer_template.format(t))
                               for t in texts], device=dist.device)
        return _HostScores(torch.gather(dist, 1, ans[:, None])[:, 0]), p

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
    def generate(self, images, texts, max_new_tokens: int = 2048, **kw) -> list[str]:
        """Greedy continuation, one sequence at a time: image and prompt the
        bidirectional prefix, generated tokens causal; the decode covers the
        prompt text and the generated ids (reference
        paligemma_model.py:117-139)."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        cfg = self.config
        eos = {getattr(self.tokenizer, "eos_token_id", None)} - {None}
        uniq, inv = unique_visuals(images)
        encoded = self._encode_images(uniq)
        outs = []
        for j, text in enumerate(texts):
            prompt = self._prompt_ids(text)
            n, s = len(prompt), _bucket(len(prompt))
            arrays = self._prefix_arrays([prompt], s)
            ids, vis_mask, vis_slot = (torch.from_numpy(a).to(self.device)
                                       for a in arrays[:3])
            embeds = pg.splice_embeds(self.params, cfg, ids, encoded[inv[j]][None],
                                      vis_mask, vis_slot)
            bidir_full = np.full((1, s + max_new_tokens), -1, np.int32)
            bidir_full[0, :n] = 0
            gen, _ = self._lm.greedy(self.params.decoder, embeds, np.arange(s)[None], n,
                                     max_new_tokens, eos_ids=eos, bidir_full=bidir_full)
            text_ids = prompt[cfg.num_image_tokens + 1:]
            outs.append(decode_text(self.tokenizer, text_ids + gen, eos))
        return outs


class Gemma4Adapter(Gemma3Adapter):
    """Gemma 4 VQAScore adapter: Gemma 3's media pipeline and prompts;
    the score is a 5-token greedy rollout scored from its end
    (``generation.score_rollout``: the model may write an empty thinking
    block before the answer), batched for more than one pair, else one
    sequence at a time; ``generate`` keeps the specials in the decode and
    strips the thinking block (``gemma4.parse_response``).

    Weights: ``params``; ``checkpoint`` (a native tree, its dims adopted
    where they differ from the provisional registry ones, or an HF
    directory in the Gemma 3 layout); random with ``init='random'`` (or a
    model without a hub repo). There is no public HF implementation to load
    a snapshot with, so otherwise it raises, as the JAX adapter does.
    """

    def load_model(self):
        from ..bridge import gemma3_from_numpy

        spec = g4.GEMMA4_MODELS[self.model_name]
        cfg = self.kwargs.get("config") or spec["config"]
        path = self.kwargs.get("checkpoint")
        if self.kwargs.get("params") is None:
            if path is None and self.kwargs.get("init") != "random" \
                    and spec["hf"] is not None:
                raise RuntimeError(
                    f"no public HF implementation for {self.model_name}; pass "
                    "checkpoint=<converted dir> or init='random' (see models/gemma4.py)")
            if path is not None and ckpt.is_native_tree(path):
                dtype = self.kwargs.get("dtype") or default_dtype(self.device)
                tree, cfg = ckpt.load_with_adopted_dims(
                    path, cfg, lambda t, c: gemma3_from_numpy(t, c, "meta", dtype),
                    self.model_name, dtype)
                self.kwargs = dict(self.kwargs, params=tree)
        self.config = cfg
        self.params = family_params(self, None, cfg, g3.Gemma3Model, g4.init_gemma4,
                                    g4.convert_gemma4, gemma3_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)

    def _special_ids(self) -> set:
        all_ids = getattr(self.tokenizer, "all_special_ids", None)
        if all_ids:
            return {int(i) for i in all_ids}
        return self._eos_ids()

    def _rollout(self, visual, question, num_frames, max_new_tokens, temperature=1.0,
                 sample=False, top_p=0.9):
        """One sequence's greedy (or nucleus) rollout: (generated ids, each
        step's distribution)."""
        embeds, n_prompts, bidir_full = self._prompt_embeds([visual], [question],
                                                            num_frames, max_new_tokens)
        return self._lm.greedy(self.params.decoder, embeds,
                               np.arange(embeds.shape[1])[None], int(n_prompts[0]),
                               max_new_tokens, eos_ids=self._eos_ids(),
                               temperature=temperature, bidir_full=bidir_full,
                               sample=sample, top_p=top_p)

    @torch.inference_mode()
    def forward(self, images, texts, num_frames: int = 10, fps=None,
                question_template: str = DEFAULT_QUESTION,
                answer_template: str = DEFAULT_ANSWER, max_new_tokens: int = 5,
                temperature: float = 1.0, **kw) -> np.ndarray:
        """Rollout scores of the pairs (reference gemma4_model.py:158-228):
        ``max_new_tokens`` leaves room for an empty thinking block."""
        if len(images) != len(texts):
            raise ValueError("forward: one image per text")
        questions = [question_template.format(t) for t in texts]
        answers = [self._encode_text(answer_template.format(t)) for t in texts]
        special = self._special_ids()
        if len(images) > 1:
            return self._forward_batched(images, questions, answers, num_frames,
                                         max_new_tokens, temperature, special)
        probs = []
        for visual, question, ans in zip(images, questions, answers):
            gen, dists = self._rollout(visual, question, num_frames, max_new_tokens,
                                       temperature)
            probs.append(score_rollout(dists, gen, ans, special))
        return np.asarray(probs, np.float32)

    def forward_device(self, images, texts, **kw):
        """(scores, count) for ``Score.batch_forward``: the rollout reads its
        tokens back, so the scores are already on the host."""
        return self.forward(images, texts, **kw), len(texts)

    def _forward_batched(self, images, questions, answers, num_frames, max_new_tokens,
                         temperature, special) -> np.ndarray:
        """One batched greedy rollout with each step's probabilities of the
        answer ids gathered on the device (the JAX adapter's batched path:
        it stops at the smallest eos id)."""
        embeds, n_prompts, bidir_full = self._prompt_embeds(images, questions, num_frames,
                                                            max_new_tokens)
        b, s = embeds.shape[:2]
        gather = np.zeros((b, max(len(a) for a in answers)), np.int64)
        for j, ans in enumerate(answers):
            gather[j, :len(ans)] = ans
        eos = self._eos_ids()
        tokens, lengths, probs = self._lm.greedy_batch(
            self.params.decoder, embeds, np.broadcast_to(np.arange(s), (b, s)).copy(),
            n_prompts, max_new_tokens, eos_id=min(eos) if eos else None,
            bidir_full=bidir_full, gather_ids=gather, temperature=temperature)
        out = []
        for j, ans in enumerate(answers):
            length = int(lengths[j])
            # probs[j, t, i] is P(answer id i) at step t: the end-aligned rule
            # over the answer's own indices
            out.append(score_rollout([probs[j, t] for t in range(length)],
                                     tokens[j, :length].tolist(), list(range(len(ans))),
                                     special))
        return np.asarray(out, np.float32)

    @torch.inference_mode()
    def generate(self, images, texts, num_frames: int = 10, fps=None,
                 max_new_tokens: int = 1024, temperature: float = 0.0,
                 do_sample=None, top_p: float = 0.9, **kw) -> list[str]:
        """Greedy (or nucleus) continuation one sequence at a time, decoded
        with its specials, the thinking block stripped (reference
        gemma4_model.py:276-281)."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        if do_sample is None:
            do_sample = temperature > 0
        sample = bool(do_sample and temperature > 0)
        eos = self._eos_ids()
        decode = getattr(self.tokenizer, "decode", lambda x: str(x))
        outs = []
        for visual, text in zip(images, texts):
            gen, _ = self._rollout(visual, text, num_frames, max_new_tokens,
                                   temperature if sample else 1.0, sample=sample,
                                   top_p=top_p)
            outs.append(g4.parse_response(decode([i for i in gen if i not in eos])))
        return outs
