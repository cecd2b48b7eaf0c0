"""CLIP-FlanT5, the VQAScore flagship, in PyTorch (port of
t2v_metrics_tpu/models/clip_flant5.py).

CLIP ViT-L/14-336 -> second-to-last-block patch features (576 tokens, CLS
dropped) -> 2-layer exact-GELU projector to d_model -> spliced into the
FlanT5 encoder embeddings at the ``<image>`` slots -> the answer scored from
the teacher-forced decoder. Score = exp(mean log P(answer tokens)).
Image features are computed once per unique image and gathered per pair.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from t2v_metrics_tpu.constants import DEFAULT_IMAGE_TOKEN, SYSTEM_MSG

from ..ops import layers as L
from ..ops import quant as Q
from . import clip as tclip
from . import t5 as tt5


@dataclasses.dataclass(frozen=True)
class CLIPT5Config:
    t5: tt5.T5Config
    vision: tclip.CLIPVisionConfig
    num_image_tokens: int = 576
    conversation: str = "t5_chat"
    image_aspect_ratio: str = "pad"  # expand2square with CLIP-mean fill

    @property
    def d_model(self) -> int:
        return self.t5.d_model


CLIP_T5_CONFIGS = {
    "clip-flant5-xxl": CLIPT5Config(t5=tt5.T5_CONFIGS["flan-t5-xxl"],
                                    vision=tclip.CLIP_ARCHS["ViT-L-14-336"]),
    "clip-flant5-xl": CLIPT5Config(t5=tt5.T5_CONFIGS["flan-t5-xl"],
                                   vision=tclip.CLIP_ARCHS["ViT-L-14-336"]),
}


def format_question(question: str, conversation_style: str = "t5_chat") -> str:
    """LLaVA-style prompt formatting for CLIP-FlanT5."""
    if conversation_style in ("plain", "t5_plain"):
        return DEFAULT_IMAGE_TOKEN + question
    if conversation_style == "t5_chat":
        return (SYSTEM_MSG + " USER: " + DEFAULT_IMAGE_TOKEN + "\n"
                + question + " ASSISTANT: ")
    if conversation_style == "t5_chat_no_system":
        return "USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question + " ASSISTANT: "
    raise NotImplementedError(conversation_style)


def format_answer(answer: str, conversation_style: str = "t5_chat") -> str:
    if conversation_style in ("plain", "t5_plain"):
        return answer + "\n"
    return answer


class Projector(nn.Module):
    def __init__(self, vision_width: int, d_model: int, device, dtype):
        super().__init__()
        self.fc1 = Q.Linear.empty(vision_width, d_model, True, device, dtype)
        self.fc2 = Q.Linear.empty(d_model, d_model, True, device, dtype)


class CLIPT5Model(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``projector``, ``t5``."""

    def __init__(self, cfg: CLIPT5Config, device, dtype):
        super().__init__()
        self.vision = tclip.VisionTower(cfg.vision, device, dtype)
        self.projector = Projector(cfg.vision.width, cfg.d_model, device, dtype)
        self.t5 = tt5.T5Model(cfg.t5, device, dtype)


@torch.no_grad()
def init_clip_t5(cfg: CLIPT5Config, seed: int, device,
                 dtype=torch.float32) -> CLIPT5Model:
    """Random parameters made directly on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_clip_t5's
    distributions (the numbers differ from the JAX package's)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = CLIPT5Model(cfg, device, dtype)
    tclip.init_vision(model.vision, gen)
    for leaf in (model.projector.fc1, model.projector.fc2):
        tclip.normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    tt5.init_t5(model.t5, gen)
    return model


def image_features(params: CLIPT5Model, cfg: CLIPT5Config,
                   pixels: torch.Tensor) -> torch.Tensor:
    """(M, H, W*3) normalized pixels -> (M, num_image_tokens, d_model)."""
    feats = tclip.vision_tower(params.vision, cfg.vision, pixels, feature_layer=-2)
    h = L.ACT_FNS["gelu"](Q.linear(feats, params.projector.fc1))
    return Q.linear(h, params.projector.fc2)


def _pair_embeds(params, feats, ids, img_mask, img_slot, pair_image, pair_text):
    """Per-pair encoder embeddings: token embeddings with the image
    features of each pair's image written into its image slots.

    feats: (M, T, D); ids/img_mask/img_slot: (N, S); pair_image/pair_text:
    (P,) index maps into the images and texts.
    """
    tok = params.t5.shared_emb[ids[pair_text]]                 # (P, S, D)
    slot = img_slot[pair_text].long()[..., None].expand(-1, -1, feats.shape[-1])
    img = torch.gather(feats[pair_image], 1, slot)
    return torch.where(img_mask[pair_text][..., None], img.to(tok.dtype), tok)


def score_pairs(params: CLIPT5Model, cfg: CLIPT5Config,
                feats: torch.Tensor,       # (M, T, D) from image_features()
                ids: torch.Tensor,         # (N, S) token ids, 0 at image slots/pad
                img_mask: torch.Tensor,    # (N, S) bool: position is an image slot
                img_slot: torch.Tensor,    # (N, S) int: which of the T features
                enc_mask: torch.Tensor,    # (N, S) bool: valid position
                ans_ids: torch.Tensor,     # (N, A)
                ans_mask: torch.Tensor,    # (N, A) float
                pair_image: torch.Tensor,  # (P,)
                pair_text: torch.Tensor,   # (P,)
                ) -> torch.Tensor:
    """(P,) mean answer-token log-probs."""
    embeds = _pair_embeds(params, feats, ids, img_mask, img_slot,
                          pair_image, pair_text)
    return tt5.answer_log_probs(params.t5, cfg.t5, embeds, enc_mask[pair_text],
                                ans_ids[pair_text], ans_mask[pair_text])
