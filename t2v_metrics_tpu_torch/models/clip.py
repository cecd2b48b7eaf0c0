"""CLIP in PyTorch (port of t2v_metrics_tpu/models/clip.py): the vision
tower (CLIP-FlanT5's and CLIPScore's) and the text tower (CLIPScore's).

Each tower is an ``nn.Module`` holding its parameters in the JAX package's
layouts (linear weights (in, out), the patch embedding as a (3*p*p, width)
matrix in conv (c, ph, pw) row order); ``vision_tower`` and ``text_tower``
are the forwards, ``encode_image`` / ``encode_text`` normalise their
embeddings in fp32 and ``clip_scores`` is the raw cosine matrix (no
``logit_scale``), as the reference's CLIPScore returns it. The q|k|v
projection of each block is packed into one (width, 3*width) leaf at load,
so attention reads it in place; under ``int8+vit``
(``ops/quant.quantize_clip_vision_``) the vision q|k|v, o, fc1 and fc2
leaves are int8 and their biases carried through. The text tower's causal
attention over its 77 tokens runs in the flat kernel (the JAX package sends
it to XLA: 77 rows are under its flat kernel's 128-row gate).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.image import patch_perm, patchify_flat
from ..parallel.mesh import build_sharded, full_shape, gather_cols
from .. import tracing


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


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_dim: int = 2048
    proj_dim: int = 512
    act: str = "quick_gelu"
    ln_eps: float = 1e-5


# (vision, text) configs of the OpenCLIP architectures the JAX package
# registers (``openai:ViT-B-32`` is CLIPScore's default; ViT-L-14-336 is the
# CLIP-FlanT5 tower)
CLIP_ARCHS = {
    "ViT-B-32": (CLIPVisionConfig(224, 32, 768, 12, 12, 3072, 512),
                 CLIPTextConfig(49408, 77, 512, 12, 8, 2048, 512)),
    "ViT-B-16": (CLIPVisionConfig(224, 16, 768, 12, 12, 3072, 512),
                 CLIPTextConfig(49408, 77, 512, 12, 8, 2048, 512)),
    "ViT-L-14": (CLIPVisionConfig(224, 14, 1024, 24, 16, 4096, 768),
                 CLIPTextConfig(49408, 77, 768, 12, 12, 3072, 768)),
    "ViT-L-14-336": (CLIPVisionConfig(336, 14, 1024, 24, 16, 4096, 768),
                     CLIPTextConfig(49408, 77, 768, 12, 12, 3072, 768)),
}


class Norm(nn.Module):
    """Norm parameters: ``scale`` and an optional ``bias``."""

    def __init__(self, width: int, bias: bool, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(width, device=device, dtype=dtype),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(width, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)


class Block(nn.Module):
    """A pre-LN transformer block of either tower (``heads``: the q|k|v
    parts' head count, which tensor parallelism divides)."""

    def __init__(self, width: int, mlp_dim: int, heads: int, device, dtype):
        super().__init__()
        self.ln1 = Norm(width, True, device, dtype)
        self.qkv = Q.Linear.empty(width, 3 * width, True, device, dtype)
        self.qkv.parts = tuple((f"{n} heads", heads, width // heads) for n in "qkv")
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
        self.blocks = nn.ModuleList(Block(w, cfg.mlp_dim, cfg.heads, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_post = Norm(w, True, device, dtype)
        self.proj = param(w, cfg.proj_dim)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device, dtype):
        super().__init__()
        w = cfg.width

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.tok_emb = param(cfg.vocab_size, w)
        self.pos_emb = param(cfg.context_length, w)
        self.blocks = nn.ModuleList(Block(w, cfg.mlp_dim, cfg.heads, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_final = Norm(w, True, device, dtype)
        self.proj = param(w, cfg.proj_dim)


class CLIPModel(nn.Module):
    """CLIPScore's parameters: ``vision``, ``text`` and the fp32
    ``logit_scale`` (kept from the checkpoint; the score does not use it)."""

    def __init__(self, vcfg: CLIPVisionConfig, tcfg: CLIPTextConfig, device, dtype):
        super().__init__()
        self.vision = VisionTower(vcfg, device, dtype)
        self.text = TextTower(tcfg, device, dtype)
        self.logit_scale = nn.Parameter(torch.empty((), device=device,
                                                    dtype=torch.float32),
                                        requires_grad=False)


def init_blocks_(blocks, gen: torch.Generator) -> None:
    for blk in blocks:
        init_norm_(blk.ln1)
        init_norm_(blk.ln2)
        for leaf in (blk.qkv, blk.o, blk.fc1, blk.fc2):
            normal_(leaf.w, fan_in(leaf.w) ** -0.5, gen)
            leaf.b.zero_()


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
    init_blocks_(p.blocks, gen)
    return p


@torch.no_grad()
def init_text(p: TextTower, gen: torch.Generator) -> TextTower:
    """Fill a text tower in place with init_text's distributions: token
    embedding N(0, 0.02^2), positions N(0, 0.01^2), linears N(0, 1/d_in)."""
    normal_(p.tok_emb, 0.02, gen)
    normal_(p.pos_emb, 0.01, gen)
    normal_(p.proj, p.proj.shape[0] ** -0.5, gen)
    init_norm_(p.ln_final)
    init_blocks_(p.blocks, gen)
    return p


@torch.no_grad()
def init_clip(vcfg: CLIPVisionConfig, tcfg: CLIPTextConfig, seed: int, device,
              dtype=torch.float32, mesh=None) -> CLIPModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_clip's distributions
    and ``logit_scale`` log(1/0.07) (the numbers differ from the JAX
    package's). ``mesh``: each rank holds its share of the same weights."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_sharded(CLIPModel, (vcfg, tcfg), device, dtype, mesh)
    init_vision(model.vision, gen)
    init_text(model.text, gen)
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill ``t`` in place with N(0, std^2) draws made in fp32 on its device.
    A rank's shard (``parallel/mesh.py:shard_params``) draws the whole
    tensor and keeps its slice, so every rank holds slices of the same
    weights as one unsharded draw from the same seed."""
    shard = getattr(t, "shard", None)
    if shard is None:
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device).mul_(std))
    else:
        full = torch.randn(shard.full_shape, generator=gen, device=t.device)
        t.copy_(shard.take(full).mul_(std))


def fan_in(w: torch.Tensor) -> int:
    """The input width of a weight (K, N), the whole tensor's for a shard."""
    return full_shape(w)[0]


def init_norm_(norm: Norm) -> None:
    norm.scale.fill_(1.0)
    if norm.bias is not None:
        norm.bias.zero_()


def pre_ln_block(p: Block, x: torch.Tensor, branch: torch.Tensor | None, heads: int,
           eps: float, act: str, causal: bool = False,
           kv_mask=None, segment_ids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN block on the residual stream ``x + branch`` (``branch``:
    the previous block's MLP output, not yet added, or None). Each residual
    add is folded into the LayerNorm that reads its sum. Returns (the stream
    after the attention half, this block's MLP output, not yet added).
    ``heads``: the tower's; under tensor parallelism the block runs the
    share its q|k|v leaf holds."""
    x, h = L.add_layer_norm(x, branch, p.ln1.scale, p.ln1.bias, eps)
    heads = heads * p.qkv.d_out // (3 * x.shape[-1])
    a = attention_flat_packed(Q.linear(h, p.qkv), heads, causal=causal,
                              kv_mask=kv_mask, segment_ids=segment_ids)
    x, h = L.add_layer_norm(x, Q.linear(a, p.o), p.ln2.scale, p.ln2.bias, eps)
    h = L.ACT_FNS[act](Q.linear(h, p.fc1))
    return x, Q.linear(h, p.fc2)


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
    perm = tracing.to_device(patch_perm(cfg.patch_size, 3), pixels.device)
    x = gather_cols(patchify_flat(pixels, cfg.patch_size, 3) @ p.patch_w[perm], p.patch_w)
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
    branch = None
    for blk in p.blocks[:n_blocks]:
        x, branch = pre_ln_block(blk, x, branch, cfg.heads, cfg.ln_eps, cfg.act,
                           kv_mask=kv_mask)

    if feature_layer is not None:
        # no LayerNorm reads the last block's sum: a plain add of the rows kept
        feats = x[:, 1:t, :]
        return feats if branch is None else feats + branch[:, 1:t, :]
    # ln_post reads only the CLS row of the sum
    cls_out = L.add_layer_norm(x[:, 0], None if branch is None else branch[:, 0],
                               p.ln_post.scale, p.ln_post.bias, cfg.ln_eps)[1]
    return cls_out @ p.proj


def text_tower(p: TextTower, cfg: CLIPTextConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids: (B, S) integer, padded with zeros after EOT. Returns the projected
    EOT embedding (B, proj_dim); the EOT position is argmax of the ids (CLIP
    BPE's EOT has the highest id), as open_clip and HF CLIPTextModel pool.
    The blocks run causally; ln_final reads only the EOT row of the last
    residual sum (a LayerNorm is per row, so the numbers are those of the
    whole sequence's)."""
    x = p.tok_emb[ids] + p.pos_emb[: ids.shape[1]]
    branch = None
    for blk in p.blocks:
        x, branch = pre_ln_block(blk, x, branch, cfg.heads, cfg.ln_eps, cfg.act, causal=True)
    rows = torch.arange(ids.shape[0], device=ids.device)
    eot = ids.argmax(dim=-1)
    pooled = L.add_layer_norm(x[rows, eot], None if branch is None else branch[rows, eot],
                              p.ln_final.scale, p.ln_final.bias, cfg.ln_eps)[1]
    return pooled @ p.proj


def _unit(f: torch.Tensor) -> torch.Tensor:
    """Rows over their fp32 norms (fp32 out, as the JAX division promotes)."""
    return f / torch.linalg.vector_norm(f.float(), dim=-1, keepdim=True)


def encode_image(params: CLIPModel, vcfg: CLIPVisionConfig, pixels: torch.Tensor,
                 normalize: bool = True) -> torch.Tensor:
    f = vision_tower(params.vision, vcfg, pixels)
    return _unit(f) if normalize else f


def encode_text(params: CLIPModel, tcfg: CLIPTextConfig, ids: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
    f = text_tower(params.text, tcfg, ids)
    return _unit(f) if normalize else f


def clip_scores(params: CLIPModel, vcfg: CLIPVisionConfig, tcfg: CLIPTextConfig,
                pixels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(M images, N texts) -> (M, N) cosine-similarity matrix in fp32 (the
    reference's CLIPScore returns the raw cosine of each pair)."""
    img = encode_image(params, vcfg, pixels).float()
    txt = encode_text(params, tcfg, ids).float()
    return img @ txt.T
