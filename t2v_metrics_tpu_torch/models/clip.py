"""CLIP vision tower in PyTorch (port of t2v_metrics_tpu/models/clip.py).

The tower is an ``nn.Module`` holding its parameters in the JAX package's
layouts (linear weights (in, out), the patch embedding as a
(3*p*p, width) matrix in conv (c, ph, pw) row order); ``vision_tower`` is
the forward. The q|k|v projection of each block is packed into one
(width, 3*width) leaf at load, so attention reads it in place. The text
tower comes with the CLIPScore slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.image import patch_perm, patchify_flat


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    proj_dim: int = 512
    act: str = "quick_gelu"
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# Vision configs of the OpenCLIP architectures the JAX package registers.
CLIP_ARCHS = {
    "ViT-B-32": CLIPVisionConfig(224, 32, 768, 12, 12, 3072, 512),
    "ViT-B-16": CLIPVisionConfig(224, 16, 768, 12, 12, 3072, 512),
    "ViT-L-14": CLIPVisionConfig(224, 14, 1024, 24, 16, 4096, 768),
    "ViT-L-14-336": CLIPVisionConfig(336, 14, 1024, 24, 16, 4096, 768),
}


class Norm(nn.Module):
    """Norm parameters: ``scale`` and an optional ``bias``."""

    def __init__(self, width: int, bias: bool, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(width, device=device, dtype=dtype),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(width, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)


class VisionBlock(nn.Module):
    def __init__(self, width: int, mlp_dim: int, device, dtype):
        super().__init__()
        self.ln1 = Norm(width, True, device, dtype)
        self.qkv = Q.Linear.empty(width, 3 * width, True, device, dtype)
        self.o = Q.Linear.empty(width, width, True, device, dtype)
        self.ln2 = Norm(width, True, device, dtype)
        self.fc1 = Q.Linear.empty(width, mlp_dim, True, device, dtype)
        self.fc2 = Q.Linear.empty(mlp_dim, width, True, device, dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device, dtype):
        super().__init__()
        w = cfg.width

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.class_emb = param(w)
        self.patch_w = param(3 * cfg.patch_size ** 2, w)
        self.pos_emb = param(cfg.num_patches + 1, w)
        self.ln_pre = Norm(w, True, device, dtype)
        self.blocks = nn.ModuleList(VisionBlock(w, cfg.mlp_dim, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_post = Norm(w, True, device, dtype)
        self.proj = param(w, cfg.proj_dim)


@torch.no_grad()
def init_vision(p: VisionTower, gen: torch.Generator) -> VisionTower:
    """Fill a tower in place with init_vision's distributions: linears
    N(0, 1/d_in), embeddings N(0, 0.02^2), norms ones/zeros, biases zeros."""
    normal_(p.class_emb, 0.02, gen)
    normal_(p.patch_w, p.patch_w.shape[0] ** -0.5, gen)
    normal_(p.pos_emb, 0.02, gen)
    normal_(p.proj, p.proj.shape[0] ** -0.5, gen)
    for norm in (p.ln_pre, p.ln_post):
        init_norm_(norm)
    for blk in p.blocks:
        init_norm_(blk.ln1)
        init_norm_(blk.ln2)
        for leaf in (blk.qkv, blk.o, blk.fc1, blk.fc2):
            normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
            leaf.b.zero_()
    return p


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill ``t`` in place with N(0, std^2) draws made in fp32 on its device."""
    t.copy_(torch.randn(t.shape, generator=gen, device=t.device).mul_(std))


def init_norm_(norm: Norm) -> None:
    norm.scale.fill_(1.0)
    if norm.bias is not None:
        norm.bias.zero_()


def _block(p: VisionBlock, x: torch.Tensor, heads: int, eps: float, act: str,
           causal: bool = False, kv_mask=None) -> torch.Tensor:
    h = L.layer_norm(x, p.ln1.scale, p.ln1.bias, eps)
    a = attention_flat_packed(Q.linear(h, p.qkv), heads, causal=causal,
                              kv_mask=kv_mask)
    x = x + Q.linear(a, p.o)
    h = L.layer_norm(x, p.ln2.scale, p.ln2.bias, eps)
    h = L.ACT_FNS[act](Q.linear(h, p.fc1))
    return x + Q.linear(h, p.fc2)


def vision_tower(p: VisionTower, cfg: CLIPVisionConfig, pixels: torch.Tensor,
                 feature_layer: int | None = None) -> torch.Tensor:
    """Run the ViT on normalized channel-flattened pixels (B, H, W*3).

    feature_layer=None: pooled projected CLS embedding (B, proj_dim).
    feature_layer=-2: LLaVA-style patch features of the second-to-last
      block, no post-LN, CLS dropped -> (B, num_patches, width).
    """
    if pixels.dim() != 3:
        raise ValueError("vision_tower takes channel-flattened (B, H, W*3) pixels")
    b = pixels.shape[0]
    pixels = pixels.to(p.patch_w.dtype)
    perm = torch.from_numpy(patch_perm(cfg.patch_size, 3)).to(pixels.device)
    x = patchify_flat(pixels, cfg.patch_size, 3) @ p.patch_w[perm]
    cls = p.class_emb.to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + p.pos_emb
    x = L.layer_norm(x, p.ln_pre.scale, p.ln_pre.bias, cfg.ln_eps)

    # Pad the tokens once to a multiple of 128 (577 -> 640 for ViT-L/336)
    # and mask the pad keys; padded query rows flow through and are dropped.
    t = x.shape[1]
    t_pad = -(-t // 128) * 128
    kv_mask = None
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
        kv_mask = (torch.arange(t_pad, device=x.device) < t).expand(b, t_pad)

    n_blocks = (len(p.blocks) if feature_layer is None
                else len(p.blocks) + 1 + feature_layer)
    for blk in p.blocks[:n_blocks]:
        x = _block(blk, x, cfg.heads, cfg.ln_eps, cfg.act, kv_mask=kv_mask)

    if feature_layer is not None:
        return x[:, 1:t, :]
    cls_out = L.layer_norm(x[:, 0], p.ln_post.scale, p.ln_post.bias, cfg.ln_eps)
    return cls_out @ p.proj
