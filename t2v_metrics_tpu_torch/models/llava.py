"""LLaVA-1.5 scorer in PyTorch (port of t2v_metrics_tpu/models/llava.py).

HF llava-hf/llava-1.5-*-hf semantics, as in the JAX package:
  * the CLIP ViT-L/14-336 tower's second-to-last-block patch features with
    the CLS row dropped (576 tokens; the CLIP-FlanT5 tower and tap);
  * the 2-layer exact-GELU projector (1024 -> d_model -> d_model);
  * the Vicuna / Llama decoder (``models/decoder.py``): MHA at head dim
    128, SwiGLU, RMSNorm eps 1e-5, RoPE theta 10k, the untied head over
    32000 ids;
  * the answer teacher-forced behind the spliced prompt, score = exp(mean
    log P(answer tokens)).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from . import clip as tclip
from . import decoder as dec
from .clip_flant5 import Projector
from .qwen2vl import splice_embeds

_CLIP_L_336 = tclip.CLIP_ARCHS["ViT-L-14-336"][0]


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: tclip.CLIPVisionConfig
    text: dec.DecoderConfig
    image_aspect_ratio: str = "pad"   # expand2square with the CLIP-mean fill

    @property
    def num_image_tokens(self) -> int:
        return (self.vision.image_size // self.vision.patch_size) ** 2


def _llama_text(d_model, layers, heads, d_ff, vocab=32000):
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=heads, head_dim=d_model // heads, d_ff=d_ff,
        rms_eps=1e-5, rope_theta=10_000.0, mrope_section=None,
        qkv_bias=False, tie_embeddings=False)


LLAVA_MODELS = {
    "llava-v1.5-7b": {
        "hf": "llava-hf/llava-1.5-7b-hf",
        "config": LlavaConfig(_CLIP_L_336, _llama_text(4096, 32, 32, 11008)),
    },
    "llava-v1.5-13b": {
        "hf": "llava-hf/llava-1.5-13b-hf",
        "config": LlavaConfig(_CLIP_L_336, _llama_text(5120, 40, 40, 13824)),
    },
    "llava-test": {
        "hf": None,
        "config": LlavaConfig(
            tclip.CLIPVisionConfig(image_size=28, patch_size=14, width=32,
                                   layers=2, heads=4, mlp_dim=64, proj_dim=24),
            _llama_text(48, 2, 4, 96, vocab=512)),
    },
}


class LlavaModel(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``projector`` (fc1, fc2)
    and ``decoder``. The patch features read no ``vision.proj`` (an HF
    checkpoint has none; the loader drops it)."""

    def __init__(self, cfg: LlavaConfig, device, dtype):
        super().__init__()
        self.vision = tclip.VisionTower(cfg.vision, device, dtype)
        self.projector = Projector(cfg.vision.width, cfg.text.d_model, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_llava(cfg: LlavaConfig, seed: int, device, dtype=torch.float32) -> LlavaModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_llava's distributions
    (the numbers differ from the JAX package's): the CLIP tower's init, the
    projector's linears N(0, 1/d_in) with zero biases, the decoder's init."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LlavaModel(cfg, device, dtype)
    tclip.init_vision(model.vision, gen)
    for leaf in (model.projector.fc1, model.projector.fc2):
        tclip.normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    dec.init_decoder(model.decoder, gen)
    return model


def image_features(params: LlavaModel, cfg: LlavaConfig,
                   pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (M, H, W*3) pixels -> (M, num_image_tokens, d_model)."""
    feats = tclip.vision_tower(params.vision, cfg.vision, pixels, feature_layer=-2)
    h = L.ACT_FNS["gelu"](Q.linear(feats, params.projector.fc1))
    return Q.linear(h, params.projector.fc2)


def splice_and_score(params: LlavaModel, cfg: LlavaConfig, ids, vis_feats, vis_mask,
                     vis_slot, position_ids, attn_mask, ans_ids, ans_pos, ans_mask,
                     temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced mean log P(answer tokens) per sequence (B,) fp32.

    ids: (B, S) token ids (0 at the image slots); vis_feats (B, T, D);
    vis_mask / vis_slot (B, S); ans_pos: the row predicting each answer
    token (prompt length - 1 + i); the untied head runs only there."""
    embeds = splice_embeds(params, ids, vis_feats, vis_mask, vis_slot)[0]
    logits = dec.forward(params.decoder, cfg.text, embeds, position_ids, attn_mask,
                         logit_positions=ans_pos)                   # (B, A, V) fp32
    logp = L.log_softmax_fp32(logits / temperature)
    ans = ans_ids.long().clamp(0, logp.shape[-1] - 1)
    tok_logp = torch.gather(logp, -1, ans[..., None])[..., 0] * ans_mask
    return tok_logp.sum(-1) / ans_mask.sum(-1).clamp(min=1)


def _find_prefix(sd, cands) -> str:
    for c in cands:
        if any(k.startswith(c + ".") for k in sd):
            return c
    raise KeyError(f"none of {cands} found in the state dict")


def convert_llava(sd, cfg: LlavaConfig):
    """HF LlavaForConditionalGeneration state dict -> tree of CPU tensor
    views in the JAX layout (port of the JAX ``convert_llava``). Keys:
    ``vision_tower.vision_model.*``, ``multi_modal_projector.linear_{1,2}``,
    ``language_model.model.*`` and ``language_model.lm_head`` (transformers
    4.52+ nests them under ``model.``; both are read)."""
    from .convert import convert_clip_vision, t2np

    vt = _find_prefix(sd, ["vision_tower.vision_model", "model.vision_tower.vision_model"])
    proj = _find_prefix(sd, ["multi_modal_projector", "model.multi_modal_projector"])
    lm = _find_prefix(sd, ["language_model.model", "model.language_model", "language_model"])
    head = next((k for k in ("lm_head.weight", "language_model.lm_head.weight",
                             "model.lm_head.weight") if k in sd), "lm_head.weight")

    def lin(name, bias=False):
        return {"w": t2np(sd[f"{name}.weight"]).t(),
                "b": t2np(sd[f"{name}.bias"]) if bias else None}

    def rms(name):
        return {"scale": t2np(sd[f"{name}.weight"])}

    blocks = []
    for i in range(cfg.text.layers):
        b = f"{lm}.layers.{i}"
        blocks.append({
            "ln1": rms(f"{b}.input_layernorm"),
            "attn": {k: lin(f"{b}.self_attn.{k}_proj") for k in "qkvo"},
            "ln2": rms(f"{b}.post_attention_layernorm"),
            "mlp": {k: lin(f"{b}.mlp.{k}_proj") for k in ("gate", "up", "down")},
        })
    vision = convert_clip_vision(sd, cfg.vision.layers, prefix=vt)
    vision["proj"] = None       # the patch features read no projection
    return {
        "vision": vision,
        "projector": {"fc1": lin(f"{proj}.linear_1", True),
                      "fc2": lin(f"{proj}.linear_2", True)},
        "decoder": {"embed": t2np(sd[f"{lm}.embed_tokens.weight"]), "blocks": blocks,
                    "ln_final": rms(f"{lm}.norm"), "lm_head": t2np(sd[head]).t()},
    }
