"""InstructBLIP VQAScore adapter (port of
t2v_metrics_tpu/models/instructblip_adapter.py).

Contract as the JAX adapter's: the question is used twice, as HF
InstructBlipProcessor uses it: tokenized by the Q-Former's own tokenizer as
the instruction, and by the T5 tokenizer as the language model's prompt;
the answer (with ``</s>``) is scored teacher-forced from the T5 decoder;
score = exp(mean log P(answer tokens)). Texts are padded to the longest.
Videos reach it as concatenated frames through the facade.

The image preprocess is BlipImageProcessor's: bicubic straight to 224, /255,
the CLIP mean and std. The JAX adapter resizes with Pillow on the host;
here the resize runs on the device with Pillow's fixed-point uint8 resize,
bit for bit (``itm_adapter.itm_preprocess``, as ITMScore does), since the
card machine has no Pillow. The EVA tower encodes each distinct
image once; the Q-Former and T5 run per pair. ``generate`` is T5's batched
greedy decode over the cached ``t5.decode_step``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import DEFAULT_ANSWER_TEMPLATE, DEFAULT_QUESTION_TEMPLATE
from ..engine.scoring import _HostScores, encode_by_shape, unique_visuals
from ..tokenization import SimpleT5Tokenizer, load_hf_tokenizer
from . import blip2_itm as bitm
from . import checkpoint as ckpt
from . import instructblip as ib
from . import t5 as tt5
from .adapters import VQAScoreModel, cached_tokenizer, family_params, tokenizer_arg
from .itm_adapter import itm_preprocess


def _pad(encoded) -> tuple[np.ndarray, np.ndarray]:
    """(ids, mask) (B, longest) of token lists, zero-padded."""
    t_max = max(len(e) for e in encoded)
    ids = np.zeros((len(encoded), t_max), np.int64)
    mask = np.zeros((len(encoded), t_max), bool)
    for j, e in enumerate(encoded):
        ids[j, :len(e)] = e
        mask[j, :len(e)] = True
    return ids, mask


class InstructBlipAdapter(VQAScoreModel):
    """InstructBLIP VQAScore adapter (instructblip-flant5-xl / xxl).

    Weights: ``params`` (an ``InstructBlipModel``, or a pytree in the JAX
    package's layout carried over by ``bridge.py``); ``checkpoint`` (an HF
    InstructBlipForConditionalGeneration directory or a native tree); random
    from ``seed`` with ``init='random'`` (or a model without a hub repo); else
    the hub repo's snapshot from the local cache (never downloaded). kwargs
    also config, dtype, tokenizer (T5's: an object or a local directory; else
    the local snapshot of the registry's T5 tokenizer; else
    SimpleT5Tokenizer) and qf_tokenizer (the Q-Former's: an object or a local
    directory; else the snapshot's ``qformer_tokenizer``; else
    SimpleT5Tokenizer).
    """

    video_mode = "concat"

    def load_model(self):
        from ..bridge import instructblip_from_numpy

        spec = ib.INSTRUCTBLIP_MODELS[self.model_name]
        cfg: ib.InstructBlipConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, ib.InstructBlipModel,
                                    ib.init_instructblip, ib.convert_instructblip,
                                    instructblip_from_numpy)
        self.tokenizer = cached_tokenizer(self.kwargs, spec["tokenizer"], cfg.t5.vocab_size,
                                          self.cache_dir)
        self.qf_tokenizer = self._qformer_tokenizer(spec["hf"], cfg.qformer.vocab_size)

    def _qformer_tokenizer(self, hf_repo, vocab_size: int):
        tok = tokenizer_arg(self.kwargs.get("qf_tokenizer"))
        if tok is None and hf_repo is not None:
            try:
                snap = ckpt.resolve_snapshot(hf_repo, self.cache_dir)
                tok = load_hf_tokenizer(os.path.join(snap, "qformer_tokenizer"))
            except (ckpt.CheckpointError, ImportError, OSError, ValueError):
                tok = None
        return tok if tok is not None else SimpleT5Tokenizer(vocab_size)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    @torch.inference_mode()
    def _image_embeds(self, images) -> torch.Tensor:
        """The tower's (1+P, width) output of each image, stacked on the
        device (one tower call per group of same-shape distinct images)."""
        cfg = self.config.vision
        uniq, inv = unique_visuals(images)
        out = torch.stack(encode_by_shape(uniq, self.device, lambda px: bitm.vision_tower(
            self.params.vision, cfg, itm_preprocess(px, cfg.image_size))))
        return out[torch.as_tensor(inv, device=out.device)]

    def _query_features(self, images, questions):
        """(B, nq, d_model) projected queries of each pair and the T5
        prompt's (ids, mask) on the device."""
        qf_ids, qf_mask = (torch.from_numpy(a).to(self.device) for a in _pad(
            [self.qf_tokenizer(q).input_ids for q in questions]))
        q_feats = ib.query_features_from_embeds(self.params, self.config,
                                                self._image_embeds(images), qf_ids, qf_mask)
        ids, enc_mask = (torch.from_numpy(a).to(self.device) for a in _pad(
            [self.tokenizer(q).input_ids for q in questions]))
        return q_feats, ids, enc_mask

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts,
                       question_template: str = DEFAULT_QUESTION_TEMPLATE,
                       answer_template: str = DEFAULT_ANSWER_TEMPLATE, **kw):
        """Pairwise scoring -> (scores still on the device, count)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        q_feats, ids, enc_mask = self._query_features(
            images, [question_template.format(t) for t in texts])
        ans = [self.tokenizer(answer_template.format(t)).input_ids for t in texts]
        ans_ids, ans_mask = (torch.from_numpy(a).to(self.device) for a in _pad(ans))
        logp = ib.score_from_queries(self.params, self.config, q_feats, ids, enc_mask,
                                     ans_ids, ans_mask.float())
        return _HostScores(torch.exp(logp)), len(texts)

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)

    @torch.inference_mode()
    def generate(self, images, texts, max_new_tokens: int = 64, **kw) -> list[str]:
        """Greedy T5 continuation conditioned on [queries] + prompt: one
        encoder pass, cached decode steps, the tokens read back once."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        cfg = self.config
        q_feats, ids, enc_mask = self._query_features(images, texts)
        enc_in, mask = ib.encoder_inputs(self.params, cfg, q_feats, ids, enc_mask)
        enc_hidden = tt5.encode(self.params.t5, cfg.t5, enc_in, mask)
        eos = getattr(self.tokenizer, "eos_token_id", 1) or 1
        tokens = tt5.greedy_decode(self.params.t5, cfg.t5, enc_hidden, mask,
                                   max_new_tokens, eos).cpu().numpy()
        outs = []
        for row in tokens:
            gen = [int(t) for t in row if t not in (0, eos)]
            try:
                outs.append(self.tokenizer.decode(gen, skip_special_tokens=True).strip())
            except TypeError:
                outs.append(self.tokenizer.decode(gen).strip())
        return outs
