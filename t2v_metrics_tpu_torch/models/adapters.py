"""Model adapters behind VQAScore (port of the CLIP-FlanT5 part of
t2v_metrics_tpu/models/adapters.py).

The adapter contract is the JAX package's: ``load_model`` builds the engine,
``forward`` scores pairs, ``score_matrix`` scores M images x N texts, and
``prepare_pairs`` / ``forward_device_prepared`` split host and device work
for the shared ``Score.batch_forward`` pipeline.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from t2v_metrics_tpu.constants import (DEFAULT_ANSWER_TEMPLATE,
                                       DEFAULT_QUESTION_TEMPLATE)
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer, load_hf_tokenizer

from ..engine.scoring import CLIPT5Engine
from . import clip as tclip
from . import clip_flant5 as tcft5
from . import t5 as tt5


def resolve_device(device) -> torch.device:
    """``None`` picks the GPU when there is one and the CPU otherwise. An
    explicit CUDA device without a GPU raises."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the GPU, fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class ScoreModel:
    """Abstract adapter."""

    video_mode = "direct"  # how Score routes video paths

    def __init__(self, model_name: str, device=None, cache_dir: str | None = None,
                 **kwargs):
        # cache_dir is part of the facade's call; nothing is loaded from disk yet
        self.model_name = model_name
        self.device = resolve_device(device)
        self.kwargs = kwargs
        self.load_model()

    def load_model(self):
        raise NotImplementedError

    def load_images(self, images):
        raise NotImplementedError

    def forward(self, images, texts, **kwargs):
        raise NotImplementedError


class VQAScoreModel(ScoreModel):
    """Adds the question/answer template contract."""

    def forward(self, images, texts,
                question_template: str = DEFAULT_QUESTION_TEMPLATE,
                answer_template: str = DEFAULT_ANSWER_TEMPLATE, **kwargs):
        raise NotImplementedError


# Tiny configs for tests and smoke runs.
_TEST_T5 = tt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                        num_heads=4, enc_layers=2, dec_layers=2)
_TEST_VISION = tclip.CLIPVisionConfig(image_size=56, patch_size=14, width=32,
                                      layers=2, heads=4, mlp_dim=64, proj_dim=32)

CLIP_T5_MODELS = {
    "clip-flant5-xxl": {
        "config": tcft5.CLIP_T5_CONFIGS["clip-flant5-xxl"],
        "hf_repo": "zhiqiulin/clip-flant5-xxl",
        "tokenizer": "google/flan-t5-xxl",
    },
    "clip-flant5-xl": {
        "config": tcft5.CLIP_T5_CONFIGS["clip-flant5-xl"],
        "hf_repo": "zhiqiulin/clip-flant5-xl",
        "tokenizer": "google/flan-t5-xl",
    },
    "clip-flant5-test": {
        "config": tcft5.CLIPT5Config(t5=_TEST_T5, vision=_TEST_VISION,
                                     num_image_tokens=16),
        "hf_repo": None,
        "tokenizer": None,
    },
}


class CLIPT5Adapter(VQAScoreModel):
    """CLIP-FlanT5 VQAScore adapter.

    kwargs:
      init: 'random' builds random weights on the device from ``seed``
      params: a ``CLIPT5Model``, or a numpy pytree in the JAX package's
        layout (carried over by ``bridge.py``)
      seed: random-init seed (default 0)
      dtype: parameter dtype (default bf16 on CUDA, fp32 on CPU)
      tokenizer: a tokenizer object or a local tokenizer directory
    Checkpoint loading and the int8 modes are not ported yet and raise.
    """

    video_mode = "concat"

    def load_model(self):
        spec = CLIP_T5_MODELS[self.model_name]
        cfg: tcft5.CLIPT5Config = spec["config"]
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        if self.kwargs.get("quant"):
            raise NotImplementedError("quantized (W8A8) scoring is not ported yet")
        if self.kwargs.get("checkpoint"):
            raise NotImplementedError("checkpoint loading is not ported yet; "
                                      "pass init='random' or params=")

        params = self.kwargs.get("params")
        if params is None:
            if self.kwargs.get("init") != "random" and spec["hf_repo"] is not None:
                raise NotImplementedError(
                    f"pretrained weights for {self.model_name} are not ported "
                    "yet; pass init='random' or params=")
            params = tcft5.init_clip_t5(cfg, self.kwargs.get("seed", 0), device,
                                        dtype)
        elif not isinstance(params, tcft5.CLIPT5Model):
            from ..bridge import clip_t5_from_numpy

            params = clip_t5_from_numpy(params, cfg, device, dtype)

        tokenizer = self.kwargs.get("tokenizer")
        if isinstance(tokenizer, str):
            if not os.path.isdir(tokenizer):
                raise ValueError(f"tokenizer {tokenizer!r} is not a local directory")
            tokenizer = load_hf_tokenizer(tokenizer)
        if tokenizer is None:
            if spec["tokenizer"]:
                warnings.warn(
                    f"no local tokenizer for {spec['tokenizer']}; using "
                    "SimpleT5Tokenizer, so scores will NOT match pretrained "
                    "weights (pass tokenizer=<local dir>)")
            tokenizer = SimpleT5Tokenizer(cfg.t5.vocab_size)

        self.engine = CLIPT5Engine(params, cfg, tokenizer, device)

    def load_images(self, images):
        return images  # the engine decodes and preprocesses in batches

    def forward(self, images, texts,
                question_template: str = DEFAULT_QUESTION_TEMPLATE,
                answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                **kwargs) -> np.ndarray:
        """Pairwise scores, len(images) == len(texts) -> (P,)."""
        return self.engine.forward_pairwise(images, texts, question_template,
                                            answer_template)

    def prepare_pairs(self, images, texts,
                      question_template: str = DEFAULT_QUESTION_TEMPLATE,
                      answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                      slot: int | None = None, **kwargs):
        """Host-only stage of pairwise scoring (feeds forward_device_prepared).
        ``slot`` is the facade's staging-ring index; every call here builds
        its own arrays, so it is not needed."""
        return self.engine.prepare_pairs(images, texts, question_template,
                                         answer_template)

    def forward_device_prepared(self, prep):
        """Device stage for a prepare_pairs dict."""
        return self.engine.forward_device_prepared(prep)

    def score_matrix(self, images, texts,
                     question_template: str = DEFAULT_QUESTION_TEMPLATE,
                     answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                     **kwargs) -> np.ndarray:
        """(M, N) matrix with one vision encode per image."""
        return self.engine.score_matrix(images, texts, question_template,
                                        answer_template)
