"""SigLIP vision tower in PyTorch (port of t2v_metrics_tpu/models/siglip.py).

HF SiglipVisionModel: a conv patch embedding with bias (as a patchify
matmul, like the CLIP tower), learned position embeddings, no class token,
pre-LN blocks with LayerNorm, a gelu_pytorch_tanh MLP and a final
post-LayerNorm. Gemma 3 runs it at 896 px (4096 patches); PaliGemma at
224/448/896.

Attention routing follows the JAX package. Its flat kernel takes a layer
only up to ``FLAT_MAX_KEYS`` rows; past that (the 896 tower) it transposes
to (B, H, S, D) and runs ``attention()``, the per-head kernel. Here a tower
up to that size runs ``attention_flat_packed`` on the packed q|k|v
projection, and a longer one runs the per-head ``attention()`` on (B, H, S,
D) views of the same projection (strided, nothing is copied), whose output
comes back head-interleaved, so merging the heads is free.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import (attention, attention_flat_packed, merge_heads,
                             packed_heads)
from ..ops.image import patch_perm, patchify_flat
from ..parallel.mesh import gather_cols
from .clip import Norm, fan_in, init_norm_, normal_

# The row count up to which the JAX package's flat kernel takes a layer:
# t2v_metrics_tpu/ops/attention.py:904 (128 <= sq <= 2048, packed) and :858
# (128 <= sk <= 2048); longer towers go through attention() :923.
FLAT_MAX_KEYS = 2048


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    ln_eps: float = 1e-6
    act: str = "gelu_pytorch_tanh"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class SiglipBlock(nn.Module):
    """``ln1``, ``qkv`` (q|k|v packed, with biases), ``o``, ``ln2``, ``fc1``,
    ``fc2``."""

    def __init__(self, width: int, mlp_dim: int, heads: int, device, dtype):
        super().__init__()
        self.ln1 = Norm(width, True, device, dtype)
        self.qkv = Q.Linear.empty(width, 3 * width, True, device, dtype)
        self.qkv.parts = tuple((f"{n} heads", heads, width // heads) for n in "qkv")
        self.o = Q.Linear.empty(width, width, True, device, dtype)
        self.ln2 = Norm(width, True, device, dtype)
        self.fc1 = Q.Linear.empty(width, mlp_dim, True, device, dtype)
        self.fc2 = Q.Linear.empty(mlp_dim, width, True, device, dtype)


class SiglipVisionTower(nn.Module):
    """``patch_w`` (3*p*p, width) in conv (c, ph, pw) row order, ``patch_b``,
    ``pos_emb`` (num_patches, width), ``blocks`` and ``ln_post``."""

    def __init__(self, cfg: SiglipVisionConfig, device, dtype):
        super().__init__()
        w = cfg.width

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.patch_w = param(3 * cfg.patch_size ** 2, w)
        self.patch_b = param(w)
        self.pos_emb = param(cfg.num_patches, w)
        self.blocks = nn.ModuleList(SiglipBlock(w, cfg.mlp_dim, cfg.heads, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_post = Norm(w, True, device, dtype)


@torch.no_grad()
def init_siglip(p: SiglipVisionTower, gen: torch.Generator) -> SiglipVisionTower:
    """Fill a tower in place with init_siglip's distributions: linears and
    the patch embedding N(0, 1/d_in), biases zero, ``pos_emb`` N(0, 0.02^2),
    LayerNorms ones/zeros."""
    normal_(p.patch_w, p.patch_w.shape[0] ** -0.5, gen)
    p.patch_b.zero_()
    normal_(p.pos_emb, 0.02, gen)
    init_norm_(p.ln_post)
    for blk in p.blocks:
        init_norm_(blk.ln1)
        init_norm_(blk.ln2)
        for leaf in (blk.qkv, blk.o, blk.fc1, blk.fc2):
            normal_(leaf.w, fan_in(leaf.w) ** -0.5, gen)
            leaf.b.zero_()
    return p


def _self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Self-attention over a packed (B, S, 3*H*D) projection -> (B, S, H*D)."""
    if qkv.shape[1] <= FLAT_MAX_KEYS:
        return attention_flat_packed(qkv, heads)
    return merge_heads(attention(*packed_heads(qkv, heads)))


def vision_tower(p: SiglipVisionTower, cfg: SiglipVisionConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """Normalized channel-flattened pixels (B, H, W*3) -> (B, num_patches,
    width)."""
    if pixels.dim() != 3:
        raise ValueError("vision_tower takes channel-flattened (B, H, W*3) pixels")
    pixels = pixels.to(p.patch_w.dtype)
    perm = torch.from_numpy(patch_perm(cfg.patch_size, 3)).to(pixels.device)
    x = gather_cols(patchify_flat(pixels, cfg.patch_size, 3) @ p.patch_w[perm],
                    p.patch_w) + p.patch_b
    x = x + p.pos_emb
    # each residual add is folded into the LayerNorm that reads its sum
    # (L.add_layer_norm); ``branch`` is the last block's MLP output, not yet added
    branch = None
    for blk in p.blocks:
        x, h = L.add_layer_norm(x, branch, blk.ln1.scale, blk.ln1.bias, cfg.ln_eps)
        heads = cfg.heads * blk.qkv.d_out // (3 * cfg.width)   # this rank's under TP
        a = Q.linear(_self_attention(Q.linear(h, blk.qkv), heads), blk.o)
        x, h = L.add_layer_norm(x, a, blk.ln2.scale, blk.ln2.bias, cfg.ln_eps)
        branch = Q.linear(L.ACT_FNS[cfg.act](Q.linear(h, blk.fc1)), blk.fc2)
    return L.add_layer_norm(x, branch, p.ln_post.scale, p.ln_post.bias, cfg.ln_eps)[1]


def convert_siglip(sd, num_layers: int, prefix="vision_model"):
    """HF SiglipVisionModel state dict -> tree of CPU tensor views in the
    JAX layout (port of the JAX ``convert_siglip``)."""
    from .convert import _clip_block, _ln, patch_matrix, t2np

    return {
        "patch_w": patch_matrix(sd[f"{prefix}.embeddings.patch_embedding.weight"]),
        "patch_b": t2np(sd[f"{prefix}.embeddings.patch_embedding.bias"]),
        "pos_emb": t2np(sd[f"{prefix}.embeddings.position_embedding.weight"]),
        "blocks": [_clip_block(sd, f"{prefix}.encoder.layers.{i}")
                   for i in range(num_layers)],
        "ln_post": _ln(sd, f"{prefix}.post_layernorm"),
    }
