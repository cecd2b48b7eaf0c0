"""InternVL 3/3.5 in PyTorch (port of t2v_metrics_tpu/models/internvl.py).

HF InternVLForConditionalGeneration semantics, as in the JAX package:
  * tiles: ``dynamic_preprocess``'s grid (up to ``max_tiles`` 448-px tiles
    matching the image's aspect, the larger grid winning a tie when the image
    covers more than half of it, plus a thumbnail when there is more than one
    tile), cut from a bicubic resize on the device (``tile_pixels``:
    ``ops/image.py:resize_uint8_pillow_flat``, Pillow's fixed-point uint8
    resize bit for bit, where the JAX package calls Pillow), ImageNet mean
    and std;
  * InternViT: the conv patch embedding (with bias) as a matmul, a CLS row,
    absolute position rows, pre-norm blocks (LayerNorm eps 1e-6 for the
    300M tower, RMSNorm for the 6B tower) with layer-scale residuals ``x +
    lambda_1 * a`` and ``x + lambda_2 * h``. The 300M tower projects q|k|v
    in one packed leaf read in place by the flat attention; the 6B tower
    projects q, k and v separately and RMS-normalizes q and k over the whole
    flattened width (3200, not per head) before the flat attention. The
    layer scale is formed first and the residual add folded into the next
    norm (``add_layer_norm``, ``add_rms_norm``);
  * features: the last hidden state, CLS dropped, ``pixel_shuffle`` 0.5 (HF's
    two transposes), LayerNorm eps 1e-5 over the shuffled width, GELU MLP
    into the LLM width;
  * LLM: ``models/decoder.py`` (Qwen2.5 with qkv bias for InternVL3,
    Qwen3 with qk-norm, dense or MoE, for InternVL3.5);
  * scoring: P(first answer token), teacher-forced (``splice_and_score``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat, attention_flat_packed
from ..ops.image import normalize_flat, patch_perm, patchify_flat, resize_uint8_pillow_flat
from . import decoder as dec
from .clip import Norm, init_norm_, normal_
from .llava import splice_and_score as llava_splice_and_score

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class InternVisionConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    ln_eps: float = 1e-6
    # InternViT-6B options (38b/78b/241b-a28b towers): RMSNorm block norms
    # and q/k RMS normalization over the flattened projection dim
    qk_norm: bool = False
    norm_type: str = "layer"  # "layer" | "rms"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    vision: InternVisionConfig
    text: dec.DecoderConfig
    downsample_ratio: float = 0.5
    image_token_id: int = 151667  # <IMG_CONTEXT>
    img_start_token: str = "<img>"
    img_end_token: str = "</img>"
    max_tiles: int = 12

    @property
    def tokens_per_tile(self) -> int:
        g = int(self.vision.grid * self.downsample_ratio)
        return g * g


def _qwen25_text(d_model, layers, heads, kv_heads, d_ff, vocab=151936):
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=d_model // heads, d_ff=d_ff,
        rope_theta=1_000_000.0, mrope_section=None, qkv_bias=True)


def _qwen3_text(d_model, layers, heads, kv_heads, d_ff, vocab=151936,
                moe=None):
    """Qwen3 backbone (InternVL3.5): no qkv bias, per-head qk RMSNorm,
    fixed head_dim 128. moe=(num_experts, top_k, moe_d_ff)."""
    cfg = dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=128, d_ff=d_ff,
        rope_theta=1_000_000.0, mrope_section=None, qkv_bias=False,
        qk_norm=True)
    if moe:
        cfg = dataclasses.replace(cfg, num_experts=moe[0],
                                  experts_per_tok=moe[1], moe_d_ff=moe[2],
                                  d_ff=0, moe_dispatch=True)
    return cfg


# InternViT-300M (default) / InternViT-6B towers
_VIT_300M = InternVisionConfig()
_VIT_6B = InternVisionConfig(width=3200, layers=45, heads=25, mlp_dim=12800,
                             qk_norm=True, norm_type="rms")

_TEST_VIT = InternVisionConfig(image_size=28, patch_size=14, width=32, layers=2, heads=4,
                               mlp_dim=64)


def _test_text(head_dim, qkv_bias, qk_norm, d_ff=96):
    return dec.DecoderConfig(vocab_size=512, d_model=48, layers=2, heads=4, kv_heads=2,
                             head_dim=head_dim, d_ff=d_ff, rope_theta=1_000_000.0,
                             mrope_section=None, qkv_bias=qkv_bias, qk_norm=qk_norm)


# The JAX package's registry, name for name (reference internvl_model.py:
# 20-187)
INTERNVL_MODELS = {
    # ---- InternVL3 (Qwen2.5 backbones)
    "internvl3-1b": {"hf": "OpenGVLab/InternVL3-1B-hf",
                     "config": InternVLConfig(_VIT_300M, _qwen25_text(896, 24, 14, 2, 4864))},
    "internvl3-2b": {"hf": "OpenGVLab/InternVL3-2B-hf",
                     "config": InternVLConfig(_VIT_300M,
                                              _qwen25_text(1536, 28, 12, 2, 8960))},
    "internvl3-8b": {"hf": "OpenGVLab/InternVL3-8B-hf",
                     "config": InternVLConfig(_VIT_300M, _qwen25_text(3584, 28, 28, 4, 18944,
                                                                      vocab=152064))},
    "internvl3-14b": {"hf": "OpenGVLab/InternVL3-14B-hf",
                      "config": InternVLConfig(_VIT_300M,
                                               _qwen25_text(5120, 48, 40, 8, 13824,
                                                            vocab=152064))},
    "internvl3-78b": {"hf": "OpenGVLab/InternVL3-78B-hf",
                      "config": InternVLConfig(_VIT_6B, _qwen25_text(8192, 80, 64, 8, 29568,
                                                                     vocab=152064))},
    # ---- InternVL3.5 (Qwen3 backbones)
    "internvl3.5-1b": {"hf": "OpenGVLab/InternVL3_5-1B-hf",
                       "config": InternVLConfig(_VIT_300M, _qwen3_text(1024, 28, 16, 8, 3072))},
    "internvl3.5-2b": {"hf": "OpenGVLab/InternVL3_5-2B-hf",
                       "config": InternVLConfig(_VIT_300M, _qwen3_text(2048, 28, 16, 8, 6144))},
    "internvl3.5-4b": {"hf": "OpenGVLab/InternVL3_5-4B-hf",
                       "config": InternVLConfig(_VIT_300M, _qwen3_text(2560, 36, 32, 8, 9728))},
    "internvl3.5-8b": {"hf": "OpenGVLab/InternVL3_5-8B-hf",
                       "config": InternVLConfig(_VIT_300M,
                                                _qwen3_text(4096, 36, 32, 8, 12288))},
    "internvl3.5-14b": {"hf": "OpenGVLab/InternVL3_5-14B-hf",
                        "config": InternVLConfig(_VIT_300M,
                                                 _qwen3_text(5120, 40, 40, 8, 17408))},
    "internvl3.5-38b": {"hf": "OpenGVLab/InternVL3_5-38B-hf",
                        "config": InternVLConfig(_VIT_6B, _qwen3_text(5120, 64, 64, 8, 25600))},
    "internvl3.5-30b-a3b": {"hf": "OpenGVLab/InternVL3_5-30B-A3B-hf",
                            "config": InternVLConfig(_VIT_300M,
                                                     _qwen3_text(2048, 48, 32, 4, 0,
                                                                 moe=(128, 8, 768)))},
    "internvl3.5-241b-a28b": {"hf": "OpenGVLab/InternVL3_5-241B-A28B-hf",
                              "config": InternVLConfig(_VIT_6B,
                                                       _qwen3_text(4096, 94, 64, 4, 0,
                                                                   moe=(128, 8, 1536)))},
    "internvl3-test": {"hf": None,
                       "config": InternVLConfig(_TEST_VIT, _test_text(12, True, False),
                                                image_token_id=500, max_tiles=4)},
    # the Qwen3 backbone
    "internvl3.5-test": {"hf": None,
                         "config": InternVLConfig(_TEST_VIT, _test_text(16, False, True),
                                                  image_token_id=500, max_tiles=4)},
    # the 6B-style tower (RMSNorm blocks, flattened qk-norm) and a MoE backbone
    "internvl3.5-moe-test": {"hf": None,
                             "config": InternVLConfig(
                                 dataclasses.replace(_TEST_VIT, qk_norm=True, norm_type="rms"),
                                 dataclasses.replace(_test_text(16, False, True, d_ff=0),
                                                     num_experts=4, experts_per_tok=2,
                                                     moe_d_ff=32),
                                 image_token_id=500, max_tiles=4)},
}


# ---------------------------------------------------------------------------
# Tiles (reference internvl_model.py:227-292)
# ---------------------------------------------------------------------------

def find_closest_aspect_ratio(aspect_ratio, target_ratios, width, height, image_size):
    """The (cols, rows) grid whose aspect is nearest the image's; on an equal
    difference the later (larger) grid wins when the image's area exceeds
    half of that grid's, as the reference's (so a square image takes 3x3 at
    1024 px, not 1x1)."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def tile_grid(h: int, w: int, min_num: int = 1, max_num: int = 12,
              image_size: int = 448) -> tuple[int, int]:
    """``dynamic_preprocess``'s (cols, rows) for an h x w image."""
    target_ratios = sorted(
        {(i, j) for n in range(min_num, max_num + 1)
         for i in range(1, n + 1) for j in range(1, n + 1)
         if min_num <= i * j <= max_num},
        key=lambda r: r[0] * r[1])
    return find_closest_aspect_ratio(w / h, target_ratios, w, h, image_size)


def tile_pixels(img: torch.Tensor, max_num: int = 12, image_size: int = 448,
                use_thumbnail: bool = True) -> torch.Tensor:
    """One uint8 image (H, W*3) on the device (as floats or uint8) -> its
    tiles (n, image_size, image_size*3) as uint8 levels in fp32:
    ``dynamic_preprocess`` with Pillow's uint8 bicubic resize to the grid,
    cut row by row, and the thumbnail (the whole image resized to one tile)
    behind them when there is more than one."""
    h, w = img.shape[0], img.shape[1] // 3
    cols, rows = tile_grid(h, w, max_num=max_num, image_size=image_size)
    resized = resize_uint8_pillow_flat(img, rows * image_size, cols * image_size, 3)
    tiles = (resized.reshape(rows, image_size, cols, image_size * 3)
             .permute(0, 2, 1, 3).reshape(rows * cols, image_size, image_size * 3))
    if use_thumbnail and rows * cols != 1:
        thumb = resize_uint8_pillow_flat(img, image_size, image_size, 3)
        tiles = torch.cat([tiles, thumb[None]])
    return tiles


def preprocess_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """uint8 levels (n, H, W*3) -> ImageNet-normalized fp32 (n, H, W*3)."""
    return normalize_flat(tiles.float() / 255.0, IMAGENET_MEAN, IMAGENET_STD)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class InternViTBlock(nn.Module):
    """``ln1``, the packed ``qkv`` (300M) or ``q``, ``k``, ``v`` with
    ``q_norm`` / ``k_norm`` over the whole width (6B, the others None), ``o``,
    ``ln2``, ``fc1``, ``fc2`` and the layer scales ``lambda_1`` /
    ``lambda_2``. A tower without q|k|v biases drops them at load."""

    def __init__(self, cfg: InternVisionConfig, device, dtype):
        super().__init__()
        w = cfg.width
        ln = cfg.norm_type == "layer"
        self.ln1 = Norm(w, ln, device, dtype)
        self.ln2 = Norm(w, ln, device, dtype)
        split = cfg.qk_norm
        self.qkv = None if split else Q.Linear.empty(w, 3 * w, True, device, dtype)
        for name in ("q", "k", "v"):
            setattr(self, name, Q.Linear.empty(w, w, True, device, dtype) if split else None)
        self.q_norm = Norm(w, False, device, dtype) if split else None
        self.k_norm = Norm(w, False, device, dtype) if split else None
        self.o = Q.Linear.empty(w, w, True, device, dtype)
        self.fc1 = Q.Linear.empty(w, cfg.mlp_dim, True, device, dtype)
        self.fc2 = Q.Linear.empty(cfg.mlp_dim, w, True, device, dtype)
        self.lambda_1 = nn.Parameter(torch.empty(w, device=device, dtype=dtype),
                                     requires_grad=False)
        self.lambda_2 = nn.Parameter(torch.empty(w, device=device, dtype=dtype),
                                     requires_grad=False)


class InternVisionTower(nn.Module):
    def __init__(self, cfg: InternVisionConfig, device, dtype):
        super().__init__()
        w = cfg.width

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.cls = param(w)
        self.patch_w = param(3 * cfg.patch_size ** 2, w)
        self.patch_b = param(w)
        self.pos_emb = param(cfg.grid ** 2 + 1, w)
        self.blocks = nn.ModuleList(InternViTBlock(cfg, device, dtype)
                                    for _ in range(cfg.layers))


class InternVLProjector(nn.Module):
    """LayerNorm over the shuffled width, then ``fc1`` -> GELU -> ``fc2``."""

    def __init__(self, cfg: InternVLConfig, device, dtype):
        super().__init__()
        shuffle = int(cfg.vision.width / cfg.downsample_ratio ** 2)
        self.ln = Norm(shuffle, True, device, dtype)
        self.fc1 = Q.Linear.empty(shuffle, cfg.text.d_model, True, device, dtype)
        self.fc2 = Q.Linear.empty(cfg.text.d_model, cfg.text.d_model, True, device, dtype)


class InternVLModel(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``projector``, ``decoder``."""

    def __init__(self, cfg: InternVLConfig, device, dtype):
        super().__init__()
        self.vision = InternVisionTower(cfg.vision, device, dtype)
        self.projector = InternVLProjector(cfg, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_internvl(cfg: InternVLConfig, seed: int, device,
                  dtype=torch.float32) -> InternVLModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_internvl's
    distributions (the numbers differ from the JAX package's): linears N(0,
    1/d_in) with zero biases, norms ones / zeros (the flattened qk-norm
    ones), layer scales 0.1, a zero CLS row, the patch matrix N(0,
    1/patch_dim), positions N(0, 0.02^2); the decoder's init."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = InternVLModel(cfg, device, dtype)
    v = model.vision
    v.cls.zero_()
    normal_(v.patch_w, v.patch_w.shape[0] ** -0.5, gen)
    v.patch_b.zero_()
    normal_(v.pos_emb, 0.02, gen)
    for blk in v.blocks:
        for norm in (blk.ln1, blk.ln2, blk.q_norm, blk.k_norm):
            if norm is not None:
                init_norm_(norm)
        for leaf in (blk.qkv, blk.q, blk.k, blk.v, blk.o, blk.fc1, blk.fc2):
            if leaf is not None:
                normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
                leaf.b.zero_()
        blk.lambda_1.fill_(0.1)
        blk.lambda_2.fill_(0.1)
    pr = model.projector
    init_norm_(pr.ln)
    for leaf in (pr.fc1, pr.fc2):
        normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    dec.init_decoder(model.decoder, gen)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _add_norm(cfg: InternVisionConfig, x, r, norm: Norm):
    """(x + r, norm(x + r)); ``r`` None adds nothing. Both towers fold the
    add into the norm's kernel."""
    if cfg.norm_type == "layer":
        return L.add_layer_norm(x, r, norm.scale, norm.bias, cfg.ln_eps)
    return L.add_rms_norm(x, r, norm.scale, cfg.ln_eps)


def vision_tower(p: InternVisionTower, cfg: InternVisionConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """Normalized channel-flattened (B, H, W*3) -> (B, 1 + P, width), the
    last hidden state (no final norm). The 1 + P rows run unpadded: the flat
    kernel masks its own ragged last tile."""
    if pixels.dim() != 3:
        raise ValueError("vision_tower takes channel-flattened (B, H, W*3) pixels")
    b = pixels.shape[0]
    pixels = pixels.to(p.patch_w.dtype)
    perm = torch.from_numpy(patch_perm(cfg.patch_size, 3)).to(pixels.device)
    x = patchify_flat(pixels, cfg.patch_size, 3) @ p.patch_w[perm] + p.patch_b
    cls = p.cls.to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + p.pos_emb[: x.shape[1]]
    branch = None
    for blk in p.blocks:
        x, h = _add_norm(cfg, x, branch, blk.ln1)
        if blk.qkv is not None:
            a = attention_flat_packed(Q.linear(h, blk.qkv), cfg.heads)
        else:
            # InternViT-6B: RMS over the flattened heads*head_dim width, so q
            # and k are rewritten after their projections and stay separate
            q = L.rms_norm(Q.linear(h, blk.q), blk.q_norm.scale, cfg.ln_eps)
            k = L.rms_norm(Q.linear(h, blk.k), blk.k_norm.scale, cfg.ln_eps)
            a = attention_flat(q, k, Q.linear(h, blk.v), cfg.heads)
        x, h = _add_norm(cfg, x, blk.lambda_1 * Q.linear(a, blk.o), blk.ln2)
        h = Q.linear(L.ACT_FNS["gelu"](Q.linear(h, blk.fc1)), blk.fc2)
        branch = blk.lambda_2 * h
    return x if branch is None else x + branch


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """(B, W, H, C) -> (B, W*s, H*s, C/s^2), HF InternVL semantics."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * scale), int(c / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * scale), int(w * scale), int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3)


def image_features(params: InternVLModel, cfg: InternVLConfig,
                   pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (B tiles, H, W*3) -> (B, tokens_per_tile, d_model)."""
    feats = vision_tower(params.vision, cfg.vision, pixels)[:, 1:]
    b, n, c = feats.shape
    f = math.isqrt(n)
    feats = pixel_shuffle(feats.reshape(b, f, f, c), cfg.downsample_ratio)
    feats = feats.reshape(b, -1, feats.shape[-1])
    p = params.projector
    h = L.layer_norm(feats, p.ln.scale, p.ln.bias, 1e-5)
    h = L.ACT_FNS["gelu"](Q.linear(h, p.fc1))
    return Q.linear(h, p.fc2)


# Teacher-forced mean log P(answer tokens) per sequence (B,) fp32, the image
# features spliced into the token embeddings: the same computation as LLaVA's
splice_and_score = llava_splice_and_score


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def _prefix(sd, new: str, old: str) -> str:
    return new if any(k.startswith(new + ".") for k in sd) else old


def convert_internvl(sd, cfg: InternVLConfig):
    """HF InternVLForConditionalGeneration state dict -> tree of CPU tensor
    views in the JAX layout (port of the JAX ``convert_internvl``): both key
    prefixes (``model.vision_tower`` / ``vision_tower``, ``model.language_model``
    / ``language_model.model``), and both MoE layouts (packed
    ``experts.gate_up_proj`` or per-expert modules, stacked here)."""
    from .convert import patch_matrix, t2np

    def lin(prefix):
        return {"w": t2np(sd[f"{prefix}.weight"]).t(),
                "b": t2np(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd else None}

    def ln(prefix):
        out = {"scale": t2np(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            out["bias"] = t2np(sd[f"{prefix}.bias"])
        return out

    vp = _prefix(sd, "model.vision_tower", "vision_tower")
    tp = _prefix(sd, "model.language_model", "language_model.model")
    mp = _prefix(sd, "model.multi_modal_projector", "multi_modal_projector")
    v = cfg.vision
    blocks = []
    for i in range(v.layers):
        b = f"{vp}.encoder.layer.{i}"
        attn = {"q": lin(f"{b}.attention.q_proj"), "k": lin(f"{b}.attention.k_proj"),
                "v": lin(f"{b}.attention.v_proj"),
                "o": lin(f"{b}.attention.projection_layer")}
        if v.qk_norm:
            attn["q_norm"] = ln(f"{b}.attention.q_norm")
            attn["k_norm"] = ln(f"{b}.attention.k_norm")
        blocks.append({"ln1": ln(f"{b}.layernorm_before"), "attn": attn,
                       "ln2": ln(f"{b}.layernorm_after"),
                       "mlp": {"fc1": lin(f"{b}.mlp.fc1"), "fc2": lin(f"{b}.mlp.fc2")},
                       "lambda_1": t2np(sd[f"{b}.lambda_1"]),
                       "lambda_2": t2np(sd[f"{b}.lambda_2"])})
    vision = {
        "cls": t2np(sd[f"{vp}.embeddings.cls_token"]).reshape(-1),
        "patch_w": patch_matrix(sd[f"{vp}.embeddings.patch_embeddings.projection.weight"]),
        "patch_b": t2np(sd[f"{vp}.embeddings.patch_embeddings.projection.bias"]),
        "pos_emb": t2np(sd[f"{vp}.embeddings.position_embeddings"])[0],
        "blocks": blocks,
    }

    def plain(name):
        return {"w": t2np(sd[f"{name}.weight"]).t(), "b": None}

    text = cfg.text
    dec_blocks = []
    for i in range(text.layers):
        b = f"{tp}.layers.{i}"
        if text.num_experts:
            router = {"w": t2np(sd[f"{b}.mlp.gate.weight"]).t()}
            if f"{b}.mlp.experts.gate_up_proj" in sd:
                gate_up = t2np(sd[f"{b}.mlp.experts.gate_up_proj"])
                down = t2np(sd[f"{b}.mlp.experts.down_proj"])
            else:
                ex = [f"{b}.mlp.experts.{e}" for e in range(text.num_experts)]
                gate_up = torch.stack([torch.cat([t2np(sd[f"{e}.gate_proj.weight"]).t(),
                                                  t2np(sd[f"{e}.up_proj.weight"]).t()], dim=1)
                                       for e in ex])
                down = torch.stack([t2np(sd[f"{e}.down_proj.weight"]).t() for e in ex])
            mlp = {"moe": {"router": router, "gate_up": gate_up, "down": down}}
        else:
            mlp = {k: plain(f"{b}.mlp.{k}_proj") for k in ("gate", "up", "down")}
        attn = {k: lin(f"{b}.self_attn.{k}_proj") for k in "qkv"}
        attn["o"] = plain(f"{b}.self_attn.o_proj")
        if text.qk_norm:
            attn["q_norm"] = {"scale": t2np(sd[f"{b}.self_attn.q_norm.weight"])}
            attn["k_norm"] = {"scale": t2np(sd[f"{b}.self_attn.k_norm.weight"])}
        dec_blocks.append({"ln1": {"scale": t2np(sd[f"{b}.input_layernorm.weight"])},
                           "attn": attn,
                           "ln2": {"scale": t2np(sd[f"{b}.post_attention_layernorm.weight"])},
                           "mlp": mlp})
    decoder = {"embed": t2np(sd[f"{tp}.embed_tokens.weight"]), "blocks": dec_blocks,
               "ln_final": {"scale": t2np(sd[f"{tp}.norm.weight"])}}
    if not text.tie_embeddings:
        head = next((k for k in ("lm_head.weight", "language_model.lm_head.weight")
                     if k in sd), "lm_head.weight")
        decoder["lm_head"] = t2np(sd[head]).t()
    return {"vision": vision,
            "projector": {"ln": ln(f"{mp}.layer_norm"), "fc1": lin(f"{mp}.linear_1"),
                          "fc2": lin(f"{mp}.linear_2")},
            "decoder": decoder}
