"""ITMScore adapter: BLIP-2 image-text matching (port of
t2v_metrics_tpu/models/itm_adapter.py).

``forward(images, texts)`` gives each pair's P(match) from the Q-Former's
itm_head (softmax class 1); ``score_matrix`` the (M, N) matrix. The image
preprocess is Blip2ImageProcessor's: bicubic straight to size x size, /255,
the CLIP mean and std. The JAX adapter resizes with Pillow on the host; here
the resize runs on the device with Pillow's fixed-point uint8 resize
(``ops/image.py:resize_uint8_pillow_flat``: equal to Pillow bit for bit),
since the card machine has no Pillow. The EVA tower encodes each distinct image once, one
batched call per group of same-shape images, where the JAX adapter runs it
once per pair (the tower is per image, so the numbers are the same); the
Q-Former runs per pair. Texts are tokenized with special tokens and padded
to the longest, as the JAX adapter does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CLIP_MEAN, CLIP_STD
from ..engine.scoring import _HostScores, encode_by_shape, unique_visuals
from ..ops.image import normalize_flat, resize_uint8_pillow_flat
from . import blip2_itm as bitm
from .adapters import ScoreModel, cached_tokenizer, family_params


def itm_preprocess(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 images (N, H, W*3) on the device -> (N, size, size*3) fp32:
    bicubic resize as Pillow does it on uint8, bit for bit, /255, the CLIP
    mean and std."""
    x = resize_uint8_pillow_flat(pixels, size, size, 3)
    return normalize_flat(x / 255.0, CLIP_MEAN, CLIP_STD)


class Blip2ITMAdapter(ScoreModel):
    """BLIP-2 ITMScore adapter.

    Weights, in this order: ``params``; ``checkpoint``; random with
    ``init='random'`` (or a model without a repo); else the ``hf`` repo's
    snapshot from the local Hugging Face cache (never downloaded).

    kwargs: checkpoint (a local directory: HF Blip2ForImageTextRetrieval
    shards, safetensors or ``*.bin``, or a native tree), init='random',
    params (a ``Blip2ITMModel``, or a pytree in the JAX package's layout),
    config (a ``Blip2ITMConfig``), seed (default 0), dtype (default bf16 on
    CUDA, fp32 on CPU), tokenizer (an object or a local directory; else the
    snapshot's, else SimpleT5Tokenizer).
    """

    video_mode = "concat"

    def load_model(self):
        from ..bridge import blip2_itm_from_numpy

        spec = bitm.BLIP2_ITM_MODELS[self.model_name]
        cfg: bitm.Blip2ITMConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, bitm.Blip2ITMModel,
                                    bitm.init_blip2_itm, bitm.convert_blip2_itm,
                                    blip2_itm_from_numpy)
        self.tokenizer = cached_tokenizer(self.kwargs, spec["hf"], cfg.qformer.vocab_size,
                                          self.cache_dir)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    @torch.inference_mode()
    def _encode_images(self, visuals) -> list[torch.Tensor]:
        """The tower's (1+P, width) output of each image, on the device: one
        preprocess and tower call per group of same-shape images."""
        cfg = self.config.vision
        return encode_by_shape(visuals, self.device, lambda px: bitm.vision_tower(
            self.params.vision, cfg, itm_preprocess(px, cfg.image_size)))

    def _tokenize(self, texts) -> tuple[np.ndarray, np.ndarray]:
        """(ids, mask), (P, longest) each, with special tokens, zero-padded."""
        tok = self.tokenizer
        encoded = [tok.encode(t, add_special_tokens=True) if hasattr(tok, "encode")
                   else tok(t).input_ids for t in texts]
        t_max = max(len(e) for e in encoded)
        ids = np.zeros((len(texts), t_max), np.int64)
        mask = np.zeros((len(texts), t_max), bool)
        for j, e in enumerate(encoded):
            ids[j, : len(e)] = e
            mask[j, : len(e)] = True
        return ids, mask

    @torch.inference_mode()
    def forward_device(self, images, texts, **kw):
        """Pairwise P(match) -> (scores, count). The scores stay on the device
        until ``np.asarray`` copies them to the host, so a caller can queue
        the next chunk first (``Score.batch_forward``)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        uniq, inv = unique_visuals(images)
        encoded = torch.stack(self._encode_images(uniq))          # (U, 1+P, width)
        embeds = encoded[torch.as_tensor(inv, device=encoded.device)]
        ids, mask = (torch.from_numpy(a).to(self.device) for a in self._tokenize(texts))
        scores = bitm.itm_from_embeds(self.params, self.config, embeds, ids, mask)
        return _HostScores(scores), len(texts)

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)
