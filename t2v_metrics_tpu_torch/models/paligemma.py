"""PaliGemma scorer in PyTorch (port of t2v_metrics_tpu/models/paligemma.py).

HF PaliGemmaForConditionalGeneration semantics (the JAX package's, but for
the one departure below):
  * the SigLIP tower (224, 448 or 896 px, patch 14), a linear projector
    with bias, the features divided by sqrt(d_model);
  * the Gemma-2B decoder (``models/decoder.py``): MQA (8 query heads, one kv
    head, head dim 256), GeGLU, (1 + w) RMSNorm multiplied in fp32,
    sqrt(d_model)-scaled embeddings rounded to the weight dtype, the tied
    head;
  * the prefix-LM: image tokens and prompt form one bidirectional group
    (the ``bidir_ids`` overlay, 0 on every prefix row, -1 elsewhere), later
    tokens are causal.

The score is the fp32 probability of the first answer token at the first
generated step (``first_token_distribution``); no geometric mean.

One departure from the JAX package, where it departs from HF: HF splices the
image features (already over sqrt(d_model)) into the token embeddings and
then multiplies every row by sqrt(d_model) (GemmaModel's normalizer), so an
image row enters the decoder as the projector's output. The JAX package
scales only the token rows, and its image rows enter sqrt(d_model) times too
small (0.012 nats on paligemma-test's first-token log-probs against HF).
The port follows HF (``splice_embeds``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import quant as Q
from . import decoder as dec
from . import qwen2vl, siglip
from .clip import Norm, normal_
from .gemma3 import hf_prefixes


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    vision: siglip.SiglipVisionConfig
    text: dec.DecoderConfig
    image_token_id: int = 257152
    bos_token_id: int = 2

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches


def _gemma2b_text(vocab=257216):
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=2048, layers=18, heads=8, kv_heads=1,
        head_dim=256, d_ff=16384, act="gelu_pytorch_tanh",
        rope_theta=10_000.0, mrope_section=None, qkv_bias=False,
        tie_embeddings=True, rms_offset=1.0, rms_cast_weight=False)


def _siglip(size):
    return siglip.SiglipVisionConfig(image_size=size, patch_size=14,
                                     width=1152, layers=27, heads=16,
                                     mlp_dim=4304)


PALIGEMMA_MODELS = {
    "paligemma-3b-mix-224": {
        "hf": "google/paligemma-3b-mix-224",
        "config": PaliGemmaConfig(vision=_siglip(224), text=_gemma2b_text()),
    },
    "paligemma-3b-mix-448": {
        "hf": "google/paligemma-3b-mix-448",
        "config": PaliGemmaConfig(vision=_siglip(448), text=_gemma2b_text()),
    },
    "paligemma-3b-mix-896": {
        "hf": "google/paligemma-3b-mix-896",
        "config": PaliGemmaConfig(vision=_siglip(896), text=_gemma2b_text()),
    },
    "paligemma-test": {
        "hf": None,
        "config": PaliGemmaConfig(
            vision=siglip.SiglipVisionConfig(image_size=28, patch_size=14,
                                             width=32, layers=2, heads=4,
                                             mlp_dim=64),
            text=dec.DecoderConfig(
                vocab_size=512, d_model=48, layers=2, heads=4, kv_heads=1,
                head_dim=16, d_ff=96, act="gelu_pytorch_tanh",
                rope_theta=10_000.0, mrope_section=None, qkv_bias=False,
                tie_embeddings=True, rms_offset=1.0, rms_cast_weight=False),
            image_token_id=500, bos_token_id=2),
    },
}


class PaliGemmaModel(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``projector`` (a leaf
    (width, d_model) with bias) and ``decoder``."""

    def __init__(self, cfg: PaliGemmaConfig, device, dtype):
        super().__init__()
        self.vision = siglip.SiglipVisionTower(cfg.vision, device, dtype)
        self.projector = Q.Linear.empty(cfg.vision.width, cfg.text.d_model, True,
                                        device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_paligemma(cfg: PaliGemmaConfig, seed: int, device,
                   dtype=torch.float32) -> PaliGemmaModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_paligemma's
    distributions (the numbers differ from the JAX package's): the SigLIP and
    decoder inits, the projector N(0, 1/width) with a zero bias, and every
    decoder RMSNorm scale zero (the identity under the (1 + w) offset)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = PaliGemmaModel(cfg, device, dtype)
    siglip.init_siglip(model.vision, gen)
    normal_(model.projector.w, cfg.vision.width ** -0.5, gen)
    model.projector.b.zero_()
    dec.init_decoder(model.decoder, gen)
    for norm in model.decoder.modules():
        if isinstance(norm, Norm):
            norm.scale.zero_()
    return model


def image_features(params: PaliGemmaModel, cfg: PaliGemmaConfig,
                   pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (B, H, W*3) pixels -> (B, num_patches, d_model), divided by
    sqrt(d_model) in the activation dtype."""
    feats = Q.linear(siglip.vision_tower(params.vision, cfg.vision, pixels),
                     params.projector)
    return feats / torch.tensor(cfg.text.d_model ** 0.5, dtype=feats.dtype,
                                device=feats.device)


def splice_embeds(params: PaliGemmaModel, cfg: PaliGemmaConfig, ids, vis_feats, vis_mask,
                  vis_slot) -> torch.Tensor:
    """Slot ``vis_slot`` of the image features ``vis_feats`` (B, T, D)
    written into the token embeddings at ``vis_mask``, then every row times
    sqrt(d_model) rounded to the weight dtype, in HF's order."""
    x = qwen2vl.splice_embeds(params, ids, vis_feats, vis_mask, vis_slot)[0]
    return x * torch.tensor(cfg.text.d_model ** 0.5, dtype=x.dtype, device=x.device)


def prefix_groups(prefix_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool image + prompt rows -> the overlay's group ids: 0 on the
    prefix (one bidirectional group), -1 elsewhere."""
    return torch.where(prefix_mask, 0, -1).to(torch.int32)


def first_token_distribution(params: PaliGemmaModel, cfg: PaliGemmaConfig,
                             ids, vis_feats, vis_mask, vis_slot,
                             position_ids, attn_mask, prefix_mask,
                             logit_pos) -> torch.Tensor:
    """(B, vocab) fp32 softmax at the first generated step.

    prefix_mask: (B, S) True on the image + prompt rows (the bidirectional
    prefix-LM block); logit_pos: (B,) row of each sequence's last prompt
    token."""
    embeds = splice_embeds(params, cfg, ids, vis_feats, vis_mask, vis_slot)
    logits = dec.forward(params.decoder, cfg.text, embeds, position_ids, attn_mask,
                         logit_positions=logit_pos[:, None],
                         bidir_ids=prefix_groups(prefix_mask))      # (B, 1, V)
    return torch.softmax(logits[:, 0].float(), dim=-1)


def convert_paligemma(sd, cfg: PaliGemmaConfig):
    """HF PaliGemmaForConditionalGeneration state dict (the ``model.*``
    layout of transformers 4.52+ or the older one) -> tree of CPU tensor
    views in the JAX layout (port of the JAX ``convert_paligemma``)."""
    from .convert import t2np

    def lin(name):
        return {"w": t2np(sd[f"{name}.weight"]).t(), "b": None}

    def rms(name):
        return {"scale": t2np(sd[f"{name}.weight"])}

    vp, tp, mp = hf_prefixes(sd)
    blocks = []
    for i in range(cfg.text.layers):
        b = f"{tp}.layers.{i}"
        blocks.append({
            "ln1": rms(f"{b}.input_layernorm"),
            "ln2": rms(f"{b}.post_attention_layernorm"),
            "attn": {k: lin(f"{b}.self_attn.{k}_proj") for k in "qkvo"},
            "mlp": {k: lin(f"{b}.mlp.{k}_proj") for k in ("gate", "up", "down")},
        })
    return {
        "vision": siglip.convert_siglip(sd, cfg.vision.layers, prefix=vp),
        "projector": {"w": t2np(sd[f"{mp}.linear.weight"]).t(),
                      "b": t2np(sd[f"{mp}.linear.bias"])},
        "decoder": {"embed": t2np(sd[f"{tp}.embed_tokens.weight"]), "blocks": blocks,
                    "ln_final": rms(f"{tp}.norm")},
    }
