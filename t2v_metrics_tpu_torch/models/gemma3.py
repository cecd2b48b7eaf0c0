"""Gemma 3 multimodal scorer in PyTorch (port of t2v_metrics_tpu/models/gemma3.py).

HF Gemma3ForConditionalGeneration semantics, as in the JAX package:
  * the SigLIP-400M tower at 896 px (patch 14, 4096 patches), a 4x4 average
    pool to 256 soft tokens, an RMSNorm ((1 + w), multiplied in fp32) and a
    linear projection into the LLM width;
  * the Gemma 3 decoder (``models/decoder.py``): sandwich norms, qk-norm,
    ``query_pre_attn_scalar`` scaling, the 5-local : 1-global pattern
    (window 1024, local RoPE theta 10k, global 1M with linear scaling 8),
    sqrt(d_model)-scaled embeddings rounded to the weight dtype, the tied
    lm head;
  * each image block attends bidirectionally within itself, over the
    causal mask and the window.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from . import decoder as dec
from . import siglip
from .clip import Norm, normal_


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    vision: siglip.SiglipVisionConfig
    text: dec.DecoderConfig
    mm_tokens_per_image: int = 256
    image_token_id: int = 262144
    boi_token_id: int = 255999
    eoi_token_id: int = 256000


def _gemma3_text(d_model, layers, heads, kv_heads, head_dim, d_ff,
                 q_scalar, vocab=262208):
    pattern = tuple("full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                    for i in range(layers))
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=head_dim, d_ff=d_ff,
        act="gelu_pytorch_tanh", rope_theta=1_000_000.0,
        mrope_section=None, qkv_bias=False, tie_embeddings=True,
        qk_norm=True, q_scale=q_scalar ** -0.5, sandwich_norms=True,
        rms_offset=1.0, rms_cast_weight=False, sliding_window=1024,
        layer_types=pattern, local_rope_theta=10_000.0,
        rope_scaling_factor=8.0)


_SIGLIP_896 = siglip.SiglipVisionConfig(image_size=896, patch_size=14,
                                        width=1152, layers=27, heads=16,
                                        mlp_dim=4304)

GEMMA3_MODELS = {
    # reference registry gemma3_model.py:9-34 (bf16, sdpa)
    "gemma-3-4b-it": {
        "hf": "google/gemma-3-4b-it",
        "config": Gemma3Config(
            vision=_SIGLIP_896,
            text=_gemma3_text(2560, 34, 8, 4, 256, 10240, q_scalar=256)),
    },
    "gemma-3-12b-it": {
        "hf": "google/gemma-3-12b-it",
        "config": Gemma3Config(
            vision=_SIGLIP_896,
            text=_gemma3_text(3840, 48, 16, 8, 256, 15360, q_scalar=256)),
    },
    "gemma-3-27b-it": {
        "hf": "google/gemma-3-27b-it",
        "config": Gemma3Config(
            vision=_SIGLIP_896,
            text=_gemma3_text(5376, 62, 32, 16, 128, 21504, q_scalar=168)),
    },
    "gemma-3-test": {
        "hf": None,
        "config": Gemma3Config(
            vision=siglip.SiglipVisionConfig(image_size=28, patch_size=14,
                                             width=32, layers=2, heads=4,
                                             mlp_dim=64),
            text=dec.DecoderConfig(
                vocab_size=512, d_model=48, layers=3, heads=4, kv_heads=2,
                head_dim=16, d_ff=96, act="gelu_pytorch_tanh",
                rope_theta=1_000_000.0, mrope_section=None, qkv_bias=False,
                tie_embeddings=True, qk_norm=True, q_scale=16 ** -0.5,
                sandwich_norms=True, rms_offset=1.0, rms_cast_weight=False,
                sliding_window=8,
                layer_types=("sliding_attention", "full_attention",
                             "sliding_attention"),
                local_rope_theta=10_000.0, rope_scaling_factor=8.0),
            mm_tokens_per_image=1, image_token_id=501, boi_token_id=502,
            eoi_token_id=503),
    },
}


class Projector(nn.Module):
    """``norm`` (the soft-token RMSNorm) and ``proj`` (width, d_model)."""

    def __init__(self, width: int, d_model: int, device, dtype):
        super().__init__()
        self.norm = Norm(width, False, device, dtype)
        self.proj = nn.Parameter(torch.empty((width, d_model), device=device,
                                             dtype=dtype), requires_grad=False)


class Gemma3Model(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``projector``, ``decoder``."""

    def __init__(self, cfg: Gemma3Config, device, dtype):
        super().__init__()
        self.vision = siglip.SiglipVisionTower(cfg.vision, device, dtype)
        self.projector = Projector(cfg.vision.width, cfg.text.d_model, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_gemma3(cfg: Gemma3Config, seed: int, device,
                dtype=torch.float32) -> Gemma3Model:
    """Random parameters made directly on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_gemma3's
    distributions (the numbers differ from the JAX package's): the SigLIP
    and decoder inits, the projection N(0, 1/width), and every Gemma RMSNorm
    scale zero (the (1 + w) convention makes that the identity scale)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Gemma3Model(cfg, device, dtype)
    siglip.init_siglip(model.vision, gen)
    normal_(model.projector.proj, cfg.vision.width ** -0.5, gen)
    dec.init_decoder(model.decoder, gen)
    model.projector.norm.scale.zero_()
    for norm in model.decoder.modules():
        if isinstance(norm, Norm):
            norm.scale.zero_()
    return model


def image_features(params: Gemma3Model, cfg: Gemma3Config,
                   pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (B, H, W*3) pixels -> (B, mm_tokens_per_image, d_model)."""
    feats = siglip.vision_tower(params.vision, cfg.vision, pixels)
    b, _, w = feats.shape
    pp = cfg.vision.image_size // cfg.vision.patch_size
    tps = int(cfg.mm_tokens_per_image ** 0.5)
    k = pp // tps
    # k x k average pool over the patch grid (HF Gemma3MultiModalProjector)
    x = feats.reshape(b, pp // k, k, pp // k, k, w).mean(dim=(2, 4))
    x = L.rms_norm(x.reshape(b, tps * tps, w), params.projector.norm.scale,
                   cfg.vision.ln_eps, offset=1.0, cast_weight_dtype=False)
    return x @ params.projector.proj


def image_group_ids(vis_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool image-token mask -> (B, S) int32 id of each contiguous
    block, -1 on text: HF Gemma 3 restricts bidirectional attention to the
    same image block."""
    m = vis_mask.to(torch.int32)
    prev = torch.nn.functional.pad(m, (1, 0))[:, :-1]
    gid = torch.cumsum(m * (1 - prev), dim=1) - 1
    return torch.where(vis_mask, gid, -1).to(torch.int32)


def splice_embeds(params: Gemma3Model, cfg: Gemma3Config, ids, vis_feats, vis_mask,
                  vis_slot) -> torch.Tensor:
    """Token embeddings times sqrt(d_model) (the scale rounded to the weight
    dtype first), with slot ``vis_slot`` of the image features ``vis_feats``
    (B, T, D) written at ``vis_mask``."""
    embed = params.decoder.embed
    scale = torch.tensor(cfg.text.d_model ** 0.5, dtype=embed.dtype,
                         device=embed.device)
    tok = embed[ids] * scale
    slot = vis_slot.long().clamp(0, vis_feats.shape[1] - 1)
    vis = torch.gather(vis_feats, 1, slot[..., None].expand(-1, -1, vis_feats.shape[-1]))
    return torch.where(vis_mask[..., None], vis.to(tok.dtype), tok)


def splice_and_score(params: Gemma3Model, cfg: Gemma3Config, ids, vis_feats,
                     vis_mask, vis_slot, position_ids, attn_mask, ans_ids,
                     ans_pos, ans_mask, temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced mean log P(answer tokens) per sequence: token
    embeddings times sqrt(d_model) rounded to the weight dtype, the image
    features spliced in at ``vis_mask`` (slot ``vis_slot`` of ``vis_feats``
    (B, T, D)), each image block bidirectional, the tied head at
    ``ans_pos`` only."""
    embeds = splice_embeds(params, cfg, ids, vis_feats, vis_mask, vis_slot)
    logits = dec.forward(params.decoder, cfg.text, embeds, position_ids,
                         attn_mask, logit_positions=ans_pos,
                         bidir_ids=image_group_ids(vis_mask))   # (B, A, V) fp32
    logp = L.log_softmax_fp32(logits / temperature)
    ans = ans_ids.long().clamp(0, logp.shape[-1] - 1)
    tok_logp = torch.gather(logp, -1, ans[..., None])[..., 0] * ans_mask
    return tok_logp.sum(-1) / ans_mask.sum(-1).clamp(min=1)


def hf_prefixes(sd) -> tuple[str, str, str]:
    """(vision, text, projector) key prefixes of a Gemma 3 state dict: the
    ``model.*`` layout of transformers 4.52+ or the older one."""
    vp = ("model.vision_tower.vision_model"
          if any(k.startswith("model.vision_tower.") for k in sd)
          else "vision_tower.vision_model")
    tp = ("model.language_model"
          if any(k.startswith("model.language_model.layers.") for k in sd)
          else "language_model.model")
    mp = ("model.multi_modal_projector"
          if any(k.startswith("model.multi_modal_projector.") for k in sd)
          else "multi_modal_projector")
    return vp, tp, mp


def convert_gemma3(sd, cfg: Gemma3Config):
    """HF Gemma3ForConditionalGeneration state dict -> tree of CPU tensor
    views in the JAX layout (port of the JAX ``convert_gemma3``; ``ln2``
    repeats ``post_attention_layernorm`` as there, and is not read)."""
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
            "ln1_post": rms(f"{b}.post_attention_layernorm"),
            "ln_ff_pre": rms(f"{b}.pre_feedforward_layernorm"),
            "ln_ff_post": rms(f"{b}.post_feedforward_layernorm"),
            "ln2": rms(f"{b}.post_attention_layernorm"),
            "attn": {**{k: lin(f"{b}.self_attn.{k}_proj") for k in "qkvo"},
                     "q_norm": rms(f"{b}.self_attn.q_norm"),
                     "k_norm": rms(f"{b}.self_attn.k_norm")},
            "mlp": {k: lin(f"{b}.mlp.{k}_proj") for k in ("gate", "up", "down")},
        })
    return {
        "vision": siglip.convert_siglip(sd, cfg.vision.layers, prefix=vp),
        "projector": {"norm": rms(f"{mp}.mm_soft_emb_norm"),
                      "proj": t2np(sd[f"{mp}.mm_input_projection_weight"])},
        "decoder": {"embed": t2np(sd[f"{tp}.embed_tokens.weight"]), "blocks": blocks,
                    "ln_final": rms(f"{tp}.norm")},
    }
