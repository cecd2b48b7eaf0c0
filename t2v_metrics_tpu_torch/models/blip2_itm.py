"""BLIP-2 ITM in PyTorch (port of t2v_metrics_tpu/models/blip2_itm.py): the
ITMScore family.

  EVA ViT-g (class token, q|k|v packed with the [q, 0, v] bias, post-LN over
  every token) -> 32 learned query tokens + the text, a post-LN BERT
  Q-Former with cross-attention from the queries to the image every
  ``cross_attention_frequency`` layers and separate query and text FFNs ->
  the 2-class ``itm_head`` averaged over the query positions -> P(match) =
  softmax(...)[1].

Parameters are ``nn.Module``s in the JAX package's layouts (linear weights
(in, out), the patch embedding a (3*p*p, width) matrix in conv (c, ph, pw)
row order). At load the tower's and the self-attention's q|k|v and the
cross-attention's k|v are packed into one leaf each, so attention reads them
in place. Every attention site runs in the flat kernel: the EVA tower (257
unmasked keys at head dim 88, which the kernel pads to 96 columns), the
Q-Former self-attention under the text's key mask and the cross-attention
(32 queries over the image rows); the JAX package sends all of them to XLA
(its flat kernel's row, tiling and size gates). Every LayerNorm that reads a
residual sum (the tower's blocks and post-LN, the Q-Former's post-LN
``LN(out + x)`` with eps 1e-12) takes the sum in the same pass
(``add_layer_norm``).

HF weight layout: Blip2ForImageTextRetrieval (Salesforce/blip2-itm-vit-g,
blip2-itm-vit-g-coco).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat, attention_flat_packed
from ..ops.image import patch_perm, patchify_flat
from . import clip as tclip
from .convert import patch_matrix, t2np


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 39
    heads: int = 16
    mlp_dim: int = 6144
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30523
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    cross_attention_frequency: int = 2
    max_position_embeddings: int = 512
    ln_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class Blip2ITMConfig:
    vision: Blip2VisionConfig
    qformer: QFormerConfig
    num_query_tokens: int = 32


BLIP2_ITM_MODELS = {
    # the v3.0 ITMScore registry names -> HF retrieval checkpoints
    "blip2-itm": {"hf": "Salesforce/blip2-itm-vit-g",
                  "config": Blip2ITMConfig(Blip2VisionConfig(), QFormerConfig())},
    "blip2-itm-coco": {"hf": "Salesforce/blip2-itm-vit-g-coco",
                       "config": Blip2ITMConfig(Blip2VisionConfig(image_size=364),
                                                QFormerConfig())},
    "blip2-itm-test": {"hf": None,
                       "config": Blip2ITMConfig(
                           Blip2VisionConfig(image_size=28, patch_size=14,
                                             width=32, layers=2, heads=4,
                                             mlp_dim=64),
                           QFormerConfig(vocab_size=256, hidden=32, layers=2,
                                         heads=4, mlp_dim=64,
                                         cross_attention_frequency=2,
                                         max_position_embeddings=64),
                           num_query_tokens=4)},
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param(device, dtype, *shape):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class VisionTower(nn.Module):
    """EVA ViT-g: the CLIP tower's pre-LN blocks, a patch bias, no ln_pre, a
    post-LN over every token and no projection."""

    def __init__(self, cfg: Blip2VisionConfig, device, dtype):
        super().__init__()
        w = cfg.width
        self.class_emb = _param(device, dtype, w)
        self.patch_w = _param(device, dtype, 3 * cfg.patch_size ** 2, w)
        self.patch_b = _param(device, dtype, w)
        self.pos_emb = _param(device, dtype, cfg.num_patches + 1, w)
        self.blocks = nn.ModuleList(tclip.Block(w, cfg.mlp_dim, cfg.heads, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_post = tclip.Norm(w, True, device, dtype)


class BertAttention(nn.Module):
    """Self-attention (q|k|v packed in ``qkv``) or cross-attention (``q``
    apart, k|v packed in ``kv`` over the image width), then the output
    projection and the post-LN."""

    def __init__(self, hidden: int, kv_dim: int | None, device, dtype):
        super().__init__()
        if kv_dim is None:
            self.qkv = Q.Linear.empty(hidden, 3 * hidden, True, device, dtype)
            self.q = self.kv = None
        else:
            self.qkv = None
            self.q = Q.Linear.empty(hidden, hidden, True, device, dtype)
            self.kv = Q.Linear.empty(kv_dim, 2 * hidden, True, device, dtype)
        self.o = Q.Linear.empty(hidden, hidden, True, device, dtype)
        self.ln = tclip.Norm(hidden, True, device, dtype)


class BertFFN(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, device, dtype):
        super().__init__()
        self.fc1 = Q.Linear.empty(hidden, mlp_dim, True, device, dtype)
        self.fc2 = Q.Linear.empty(mlp_dim, hidden, True, device, dtype)
        self.ln = tclip.Norm(hidden, True, device, dtype)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, vision_width: int, cross: bool, device, dtype):
        super().__init__()
        h = cfg.hidden
        self.self_attn = BertAttention(h, None, device, dtype)
        self.cross = BertAttention(h, vision_width, device, dtype) if cross else None
        self.ffn_query = BertFFN(h, cfg.mlp_dim, device, dtype)
        self.ffn_text = BertFFN(h, cfg.mlp_dim, device, dtype)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, vision_width: int, device, dtype):
        super().__init__()
        self.word_emb = _param(device, dtype, cfg.vocab_size, cfg.hidden)
        self.pos_emb = _param(device, dtype, cfg.max_position_embeddings, cfg.hidden)
        self.ln_emb = tclip.Norm(cfg.hidden, True, device, dtype)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, vision_width, i % cfg.cross_attention_frequency == 0,
                         device, dtype)
            for i in range(cfg.layers))


class Blip2ITMModel(nn.Module):
    """The scorer's parameters: ``vision``, ``qformer``, ``query_tokens``
    and ``itm_head``."""

    def __init__(self, cfg: Blip2ITMConfig, device, dtype):
        super().__init__()
        self.vision = VisionTower(cfg.vision, device, dtype)
        self.qformer = QFormer(cfg.qformer, cfg.vision.width, device, dtype)
        self.query_tokens = _param(device, dtype, cfg.num_query_tokens, cfg.qformer.hidden)
        self.itm_head = Q.Linear.empty(cfg.qformer.hidden, 2, True, device, dtype)


@torch.no_grad()
def init_blip2_itm(cfg: Blip2ITMConfig, seed: int, device,
                   dtype=torch.float32) -> Blip2ITMModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_blip2_itm's
    distributions (linears N(0, 1/d_in) with zero biases, embeddings and
    query tokens N(0, 0.02^2), norms ones/zeros; the numbers differ from the
    JAX package's)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Blip2ITMModel(cfg, device, dtype)
    init_tower_qformer_(model, gen)
    init_linear_(gen, model.itm_head)
    return model


def init_linear_(gen: torch.Generator, *leaves) -> None:
    """Linears N(0, 1/d_in) with zero biases, in place."""
    for leaf in leaves:
        tclip.normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()


def init_tower_qformer_(model: nn.Module, gen: torch.Generator) -> None:
    """Fill ``model.vision``, ``model.qformer`` and ``model.query_tokens`` in
    place with init_blip2_itm's distributions (InstructBLIP shares them)."""
    v = model.vision
    tclip.normal_(v.class_emb, 0.02, gen)
    tclip.normal_(v.patch_w, v.patch_w.shape[0] ** -0.5, gen)
    v.patch_b.zero_()
    tclip.normal_(v.pos_emb, 0.02, gen)
    tclip.init_blocks_(v.blocks, gen)
    tclip.init_norm_(v.ln_post)
    qf = model.qformer
    tclip.normal_(qf.word_emb, 0.02, gen)
    tclip.normal_(qf.pos_emb, 0.02, gen)
    tclip.init_norm_(qf.ln_emb)
    for layer in qf.layers:
        for attn in (layer.self_attn, layer.cross):
            if attn is not None:
                init_linear_(gen, *(x for x in (attn.qkv, attn.q, attn.kv, attn.o)
                                    if x is not None))
                tclip.init_norm_(attn.ln)
        for ffn in (layer.ffn_query, layer.ffn_text):
            init_linear_(gen, ffn.fc1, ffn.fc2)
            tclip.init_norm_(ffn.ln)
    tclip.normal_(model.query_tokens, 0.02, gen)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def vision_tower(p: VisionTower, cfg: Blip2VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized channel-flattened pixels (B, H, W*3) -> (B, 1+P, width),
    post-LN. The 1+P rows (257 at 224 px) go to the flat kernel as they are:
    it masks its own ragged key edge."""
    if pixels.dim() != 3:
        raise ValueError("vision_tower takes channel-flattened (B, H, W*3) pixels")
    b = pixels.shape[0]
    pixels = pixels.to(p.patch_w.dtype)
    perm = torch.from_numpy(patch_perm(cfg.patch_size, 3)).to(pixels.device)
    x = patchify_flat(pixels, cfg.patch_size, 3) @ p.patch_w[perm] + p.patch_b
    cls = p.class_emb.to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + p.pos_emb[: x.shape[1] + 1]
    branch = None
    for blk in p.blocks:
        x, branch = tclip.pre_ln_block(blk, x, branch, cfg.heads, cfg.ln_eps, "gelu")
    return L.add_layer_norm(x, branch, p.ln_post.scale, p.ln_post.bias, cfg.ln_eps)[1]


def _bert_attn(p: BertAttention, cfg: QFormerConfig, x: torch.Tensor,
               kv: torch.Tensor | None, mask: torch.Tensor | None) -> torch.Tensor:
    """LN(o(attention) + x): self-attention over ``x`` under the key
    ``mask`` (kv None), or cross-attention from ``x`` to ``kv``."""
    if kv is None:
        a = attention_flat_packed(Q.linear(x, p.qkv), cfg.heads, kv_mask=mask)
    else:
        kvp = Q.linear(kv, p.kv)
        h = cfg.hidden
        a = attention_flat(Q.linear(x, p.q), kvp[..., :h], kvp[..., h:], cfg.heads,
                           kv_mask=mask)
    return L.add_layer_norm(x, Q.linear(a, p.o), p.ln.scale, p.ln.bias, cfg.ln_eps)[1]


def _bert_ffn(p: BertFFN, cfg: QFormerConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.ACT_FNS["gelu"](Q.linear(x, p.fc1))
    return L.add_layer_norm(x, Q.linear(h, p.fc2), p.ln.scale, p.ln.bias, cfg.ln_eps)[1]


def qformer(p: QFormer, cfg: QFormerConfig, embeds: torch.Tensor, attn_mask: torch.Tensor,
            image_embeds: torch.Tensor, query_length: int) -> torch.Tensor:
    """Post-LN BERT encoder with query-only cross-attention and split FFNs.

    embeds: (B, Q+T, H), already layer-normed; attn_mask (B, Q+T) bool;
    image_embeds (B, S_img, width)."""
    x = embeds
    for layer in p.layers:
        x = _bert_attn(layer.self_attn, cfg, x, None, attn_mask)
        xq, xt = x[:, :query_length], x[:, query_length:]
        if layer.cross is not None:
            xq = _bert_attn(layer.cross, cfg, xq, image_embeds, None)
        xq = _bert_ffn(layer.ffn_query, cfg, xq)
        if xt.shape[1]:
            xt = _bert_ffn(layer.ffn_text, cfg, xt)
        x = torch.cat([xq, xt], dim=1)
    return x


def itm_from_embeds(params: Blip2ITMModel, cfg: Blip2ITMConfig, image_embeds: torch.Tensor,
                    ids: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
    """(B image embeddings paired with B texts) -> (B,) fp32 P(match).

    image_embeds: (B, 1+P, width), the tower's output of each pair's image;
    ids (B, T) integer; text_mask (B, T) bool."""
    qf = cfg.qformer
    b, t = ids.shape
    nq = cfg.num_query_tokens
    q = params.qformer
    text = q.word_emb[ids] + q.pos_emb[:t]
    query = params.query_tokens.to(text.dtype).expand(b, nq, qf.hidden)
    embeds = L.layer_norm(torch.cat([query, text], dim=1), q.ln_emb.scale, q.ln_emb.bias,
                          qf.ln_eps)
    mask = torch.cat([torch.ones((b, nq), dtype=torch.bool, device=ids.device),
                      text_mask.bool()], dim=1)
    out = qformer(q, qf, embeds, mask, image_embeds, nq)
    logits = Q.linear(out[:, :nq], params.itm_head).mean(dim=1)   # (B, 2)
    return torch.softmax(logits.float(), dim=-1)[:, 1]


def itm_scores(params: Blip2ITMModel, cfg: Blip2ITMConfig, pixels: torch.Tensor,
               ids: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
    """(B images paired with B texts) -> (B,) P(match); pixels (B, H, W*3)."""
    return itm_from_embeds(params, cfg, vision_tower(params.vision, cfg.vision, pixels),
                           ids, text_mask)


# ---------------------------------------------------------------------------
# HF checkpoint -> tree
# ---------------------------------------------------------------------------

def convert_blip2_itm(sd, cfg: Blip2ITMConfig) -> dict:
    """HF Blip2ForImageTextRetrieval state dict -> the JAX package's tree, with
    CPU tensor views in the stored dtype (the bridge casts on the device).
    The tower's packed qkv (3W, W) is split into its q, k and v views."""
    def lin(prefix):
        return {"w": t2np(sd[f"{prefix}.weight"]).t(), "b": t2np(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"scale": t2np(sd[f"{prefix}.weight"]), "bias": t2np(sd[f"{prefix}.bias"])}

    blocks = []
    for i in range(cfg.vision.layers):
        b = f"vision_model.encoder.layers.{i}"
        qkv_w = t2np(sd[f"{b}.self_attn.qkv.weight"])    # (3W, W)
        qkv_b = t2np(sd[f"{b}.self_attn.qkv.bias"])      # [q, 0, v]
        w = qkv_w.shape[0] // 3
        attn = {name: {"w": qkv_w[j * w:(j + 1) * w].t(), "b": qkv_b[j * w:(j + 1) * w]}
                for j, name in enumerate("qkv")}
        attn["o"] = lin(f"{b}.self_attn.projection")
        blocks.append({"ln1": ln(f"{b}.layer_norm1"), "attn": attn,
                       "ln2": ln(f"{b}.layer_norm2"),
                       "mlp": {"fc1": lin(f"{b}.mlp.fc1"), "fc2": lin(f"{b}.mlp.fc2")}})
    vision = {
        "class_emb": t2np(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "patch_w": patch_matrix(sd["vision_model.embeddings.patch_embedding.weight"]),
        "patch_b": t2np(sd["vision_model.embeddings.patch_embedding.bias"]),
        "pos_emb": t2np(sd["vision_model.embeddings.position_embedding"])[0],
        "blocks": blocks,
        "ln_post": ln("vision_model.post_layernorm"),
    }

    def bert_attn(prefix):
        return {"q": lin(f"{prefix}.attention.query"), "k": lin(f"{prefix}.attention.key"),
                "v": lin(f"{prefix}.attention.value"), "o": lin(f"{prefix}.output.dense"),
                "ln": ln(f"{prefix}.output.LayerNorm")}

    layers = []
    for i in range(cfg.qformer.layers):
        b = f"qformer.encoder.layer.{i}"
        layers.append({
            "self": bert_attn(f"{b}.attention"),
            "cross": (bert_attn(f"{b}.crossattention")
                      if f"{b}.crossattention.attention.query.weight" in sd else None),
            "ffn_query": {"fc1": lin(f"{b}.intermediate_query.dense"),
                          "fc2": lin(f"{b}.output_query.dense"),
                          "ln": ln(f"{b}.output_query.LayerNorm")},
            "ffn_text": {"fc1": lin(f"{b}.intermediate.dense"),
                         "fc2": lin(f"{b}.output.dense"),
                         "ln": ln(f"{b}.output.LayerNorm")},
        })
    return {
        "vision": vision,
        "qformer": {"word_emb": t2np(sd["embeddings.word_embeddings.weight"]),
                    "pos_emb": t2np(sd["embeddings.position_embeddings.weight"]),
                    "ln_emb": ln("qformer.layernorm"),
                    "layers": layers},
        "query_tokens": t2np(sd["query_tokens"])[0],
        "itm_head": lin("itm_head"),
    }
