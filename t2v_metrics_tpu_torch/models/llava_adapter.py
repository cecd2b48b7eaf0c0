"""LLaVA-1.5 VQAScore adapter (port of t2v_metrics_tpu/models/llava_adapter.py).

Contract as the JAX adapter's: the vicuna_v1 conversation ``{SYSTEM_MSG}
USER: <image>\\n{question} ASSISTANT:``, spliced as the reference's
``tokenizer_image_token`` does (``tokenization.splice_image_tokens``: BOS
once, each ``<image>`` one run of the 576 image slots); the answer
tokenized behind a space (as it follows "ASSISTANT:") and teacher-forced;
score = exp(mean log P(answer tokens)); prompts bucketed to ``SEQ_BUCKETS``,
pairs to ``PAIR_BUCKETS`` and images to ``IMG_BUCKETS`` by repeating the
last row. Videos reach it as concatenated frames through the facade.

Images: pad mode, expand2square with the CLIP-mean fill then Pillow's
uint8 bicubic to 336, bit for bit, on the adapter's device
(``engine/scoring.py:pillow_resize_batch``: the JAX adapter resizes every
image with Pillow, where CLIP-FlanT5's engines resize small images in fp32
on the device), then the CLIP mean and std (``clip_pixels``); each distinct
image goes through the tower once. ``generate`` is one batched greedy decode
(``CachedLM.greedy_batch``), the tokens read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (DEFAULT_ANSWER_TEMPLATE, DEFAULT_QUESTION_TEMPLATE,
                         IMAGE_TOKEN_INDEX, SYSTEM_MSG)
from ..engine.scoring import (_HostScores, clip_pixels, pad_rows_to, pillow_resize_batch,
                               unique_visuals)
from ..tokenization import SimpleT5Tokenizer, splice_image_tokens
from . import llava as lv
from .adapters import VQAScoreModel, family_params
from .generation import CachedLM


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 63) // 64) * 64


SEQ_BUCKETS = (640, 704, 768, 1024, 1536, 2048)
PAIR_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
IMG_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class LlavaAdapter(VQAScoreModel):
    """LLaVA-1.5 VQAScore adapter (llava-v1.5-7b / 13b).

    Weights: ``params`` (an ``LlavaModel``, or a pytree in the JAX package's
    layout carried over by ``bridge.py``); ``checkpoint`` (an HF
    LlavaForConditionalGeneration directory or a native tree); random from
    ``seed`` with ``init='random'`` (or a model without a hub repo); else the
    hub repo's snapshot from the local cache (never downloaded). kwargs also
    config, dtype (default bf16 on CUDA, fp32 on CPU), tokenizer (an object
    or a local directory; else SimpleT5Tokenizer, with a warning).
    """

    video_mode = "concat"

    def load_model(self):
        from ..bridge import llava_from_numpy

        spec = lv.LLAVA_MODELS[self.model_name]
        cfg: lv.LlavaConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, lv.LlavaModel, lv.init_llava,
                                    lv.convert_llava, llava_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self.eos_token_id = getattr(self.tokenizer, "eos_token_id", None)
        self._lm = CachedLM(cfg.text)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    @staticmethod
    def _prompt(question: str) -> str:
        """The vicuna_v1 conversation (the reference's SYSTEM_MSG, " "
        between turns)."""
        return f"{SYSTEM_MSG} USER: <image>\n{question} ASSISTANT:"

    def _answer_ids(self, answer: str) -> list[int]:
        tok = self.tokenizer
        text = answer if isinstance(tok, SimpleT5Tokenizer) else " " + answer
        return tok.encode(text, add_special_tokens=False)

    @torch.inference_mode()
    def _encode_images(self, images) -> torch.Tensor:
        """(M, 576, d_model) features of M images on the device, the rows
        padded to ``IMG_BUCKETS`` through the tower and dropped after it.
        Every image is padded and resized to uint8 as the JAX adapter's
        Pillow pipeline does at any size, bit for bit, on the device."""
        cfg = self.config
        size, pad = cfg.vision.image_size, cfg.image_aspect_ratio == "pad"
        pixels = pillow_resize_batch(images, size, pad, self.device)
        pixels = pad_rows_to(pixels, _bucket(len(images), IMG_BUCKETS))
        x = clip_pixels(pixels, size, pad)
        return lv.image_features(self.params, cfg, x)[:len(images)]

    def _splice(self, spliced, s: int, answers=None):
        """(ids, vis_mask, vis_slot, attn) (B, s) of spliced prompts (and
        their answers behind them), each prompt's length."""
        t_img = self.config.num_image_tokens
        b = len(spliced)
        ids = np.zeros((b, s), np.int64)
        vis_mask = np.zeros((b, s), bool)
        vis_slot = np.zeros((b, s), np.int64)
        attn = np.zeros((b, s), bool)
        lens = []
        for j, sp in enumerate(spliced):
            pos = 0
            for x in sp:
                if x == IMAGE_TOKEN_INDEX:
                    vis_mask[j, pos:pos + t_img] = True
                    vis_slot[j, pos:pos + t_img] = np.arange(t_img)
                    pos += t_img
                else:
                    ids[j, pos] = x
                    pos += 1
            lens.append(pos)
            a = [] if answers is None else answers[j]
            ids[j, pos:pos + len(a)] = a
            attn[j, :pos + len(a)] = True
        return (ids, vis_mask, vis_slot, attn), lens

    def _length(self, sp) -> int:
        t_img = self.config.num_image_tokens
        return sum(t_img if x == IMAGE_TOKEN_INDEX else 1 for x in sp)

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts,
                       question_template: str = DEFAULT_QUESTION_TEMPLATE,
                       answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                       temperature: float = 1.0, **kw):
        """Pairwise scoring -> (scores still on the device, count)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        uniq, inv = unique_visuals(images)
        feats = self._encode_images(uniq)                       # (M, T, D)
        spliced = [splice_image_tokens(self._prompt(question_template.format(t)),
                                       self.tokenizer) for t in texts]
        answers = [self._answer_ids(answer_template.format(t)) for t in texts]
        p = len(texts)
        pb = _bucket(p, PAIR_BUCKETS)
        s = _bucket(max(self._length(sp) + len(a) for sp, a in zip(spliced, answers)),
                    SEQ_BUCKETS)
        a_max = max(len(a) for a in answers)
        arrays, lens = self._splice(spliced, s, answers)
        ans_ids = np.zeros((p, a_max), np.int64)
        ans_pos = np.zeros((p, a_max), np.int64)
        ans_mask = np.zeros((p, a_max), np.float32)
        for j, (n, a) in enumerate(zip(lens, answers)):
            ans_ids[j, :len(a)] = a
            ans_pos[j, :len(a)] = n - 1 + np.arange(len(a))
            ans_mask[j, :len(a)] = 1.0
        pos = np.tile(np.arange(s), (p, 1))
        ids, vis_mask, vis_slot, attn = arrays
        rows = [ids, vis_mask, vis_slot, pos, attn, ans_ids, ans_pos, ans_mask,
                np.asarray(inv, np.int64)]
        # pad rows repeat the last real row
        dev = [torch.from_numpy(np.concatenate([a, np.repeat(a[-1:], pb - p, axis=0)]))
               .to(self.device) for a in rows]
        logp = lv.splice_and_score(self.params, self.config, dev[0], feats[dev[8]],
                                   *dev[1:8], temperature=float(temperature))
        return _HostScores(torch.exp(logp)), p

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)

    @torch.inference_mode()
    def generate(self, images, texts, max_new_tokens: int = 128, **kw) -> list[str]:
        """Greedy continuation of each (image, text) prompt: one batched
        decode, the tokens read back once; eos and specials dropped."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        uniq, inv = unique_visuals(images)
        feats = self._encode_images(uniq)
        spliced = [splice_image_tokens(self._prompt(t), self.tokenizer) for t in texts]
        b = len(texts)
        s = _bucket(max(self._length(sp) for sp in spliced), SEQ_BUCKETS)
        (ids, vis_mask, vis_slot, _), lens = self._splice(spliced, s)
        ids, vis_mask, vis_slot = (torch.from_numpy(a).to(self.device)
                                   for a in (ids, vis_mask, vis_slot))
        embeds = lv.splice_embeds(self.params, ids,
                                  feats[torch.as_tensor(inv, device=self.device)],
                                  vis_mask, vis_slot)[0]
        tokens, lengths = self._lm.greedy_batch(
            self.params.decoder, embeds, np.tile(np.arange(s), (b, 1)),
            np.asarray(lens, np.int64), max_new_tokens, eos_id=self.eos_token_id)
        outs = []
        for j in range(b):
            seq = [int(t) for t in tokens[j, :lengths[j]] if t != self.eos_token_id]
            try:
                outs.append(self.tokenizer.decode(seq, skip_special_tokens=True).strip())
            except TypeError:
                outs.append(self.tokenizer.decode(seq).strip())
        return outs
