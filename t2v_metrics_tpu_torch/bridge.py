"""Carry the JAX package's parameters into the port.

Input: a parameter pytree in t2v_metrics_tpu's layout (nested dicts and
lists) with numpy arrays as leaves, e.g. ``jax.tree.map(np.asarray,
params)``. Output: the port's modules on ``device`` in ``dtype``, computing
the same function. Int8 leaves of the JAX W8A8 mode (``{"w_q": int8 (K, N),
"scale": f32 (N,)}``, plus ``"b"``) become the port's int8 leaves, with the
gated T5 MLP's wi_0|wi_1 packed into ``wi_01``. The self-attention q|k|v
weights (and biases) are packed once here, in the order ``ops/quant.pack``
and the JAX package's ``mm_packed`` use, so no forward pass concatenates weights (the JAX Qwen
code concatenates them on every call; eagerly that would copy ~50 MB per
Qwen2.5-VL-7B decoder layer per forward).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models import clip as tclip
from .models import clip_flant5 as tcft5
from .models import decoder as tdec
from .models import gemma3 as tgemma3
from .models import qwen2vl as tqwen
from .models import qwen3vl as tqwen3
from .models import siglip as tsiglip
from .models import t5 as tt5
from .ops import quant as Q


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _copy_int8(dst: Q.Linear, w_q, scale) -> None:
    """Make ``dst`` an int8 leaf holding the JAX leaf's (K, N) ``w_q`` and
    (N,) ``scale``, stored as the port's (N, K) ``w_qt``."""
    w_q, scale = np.asarray(w_q), np.array(scale, np.float32)
    dense = dst.w if dst.w is not None else dst.w_q
    if w_q.dtype != np.int8 or w_q.shape != tuple(dense.shape) or scale.shape != w_q.shape[1:]:
        raise ValueError(f"int8 leaf {w_q.dtype} {w_q.shape} / {scale.shape} does not "
                         f"fit {tuple(dense.shape)}")
    dev = dense.device
    dst.w = None
    dst.w_qt = nn.Parameter(torch.from_numpy(np.ascontiguousarray(w_q.T)).to(dev),
                            requires_grad=False)
    dst.scale = nn.Parameter(torch.from_numpy(scale).to(dev), requires_grad=False)


def _leaf(dst: Q.Linear, src: dict) -> None:
    if "w_q" in src:
        _copy_int8(dst, src["w_q"], src["scale"])
    else:
        _copy(dst.w, src["w"])
    if dst.b is not None:
        _copy(dst.b, src["b"])


def _packed_leaf(dst: Q.Linear, srcs: list[dict]) -> None:
    if "w_q" in srcs[0]:
        _copy_int8(dst, np.concatenate([s["w_q"] for s in srcs], axis=1),
                   np.concatenate([s["scale"] for s in srcs]))
    else:
        _copy(dst.w, np.concatenate([s["w"] for s in srcs], axis=1))
    if dst.b is not None:
        _copy(dst.b, np.concatenate([s["b"] for s in srcs]))
    elif any(s.get("b") is not None for s in srcs):
        raise ValueError("packed leaf: the source has biases, the model none")


def _norm(dst: tclip.Norm, src: dict) -> None:
    _copy(dst.scale, src["scale"])
    if dst.bias is not None:
        _copy(dst.bias, src["bias"])


@torch.no_grad()
def vision_from_numpy(tree: dict, cfg: tclip.CLIPVisionConfig, device,
                      dtype) -> tclip.VisionTower:
    return _load_vision(tclip.VisionTower(cfg, device, dtype), tree)


def _load_vision(p: tclip.VisionTower, tree: dict) -> tclip.VisionTower:
    for name in ("class_emb", "patch_w", "pos_emb", "proj"):
        _copy(getattr(p, name), tree[name])
    _norm(p.ln_pre, tree["ln_pre"])
    _norm(p.ln_post, tree["ln_post"])
    for dst, src in zip(p.blocks, tree["blocks"], strict=True):
        _norm(dst.ln1, src["ln1"])
        _norm(dst.ln2, src["ln2"])
        attn = src["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, src["mlp"]["fc1"])
        _leaf(dst.fc2, src["mlp"]["fc2"])
    return p


@torch.no_grad()
def t5_from_numpy(tree: dict, cfg: tt5.T5Config, device, dtype) -> tt5.T5Model:
    return _load_t5(tt5.T5Model(cfg, device, dtype), tree)


def _load_t5(p: tt5.T5Model, tree: dict) -> tt5.T5Model:
    _copy(p.shared_emb, tree["shared_emb"])
    if p.lm_head is not None:
        _copy(p.lm_head, tree["lm_head"])
    for side in ("encoder", "decoder"):
        stack, src_stack = getattr(p, side), tree[side]
        _norm(stack.ln_final, src_stack["ln_final"])
        for dst, src in zip(stack.blocks, src_stack["blocks"], strict=True):
            _norm(dst.ln1, src["ln1"])
            _norm(dst.ln2, src["ln2"])
            attn = src["attn"]
            _packed_leaf(dst.attn.qkv, [attn["q"], attn["k"], attn["v"]])
            _leaf(dst.attn.o, attn["o"])
            if dst.attn.rel_bias is not None:
                _copy(dst.attn.rel_bias, attn["rel_bias"])
            if side == "decoder":
                _norm(dst.ln_cross, src["ln_cross"])
                for name in ("q", "k", "v", "o"):
                    _leaf(getattr(dst.cross, name), src["cross"][name])
            for name, leaf in dst.mlp.named_children():
                _leaf(leaf, src["mlp"][name])
            Q.pack_gated_mlp_(dst.mlp)
    return p


@torch.no_grad()
def clip_t5_from_numpy(tree: dict, cfg: tcft5.CLIPT5Config, device,
                       dtype) -> tcft5.CLIPT5Model:
    model = tcft5.CLIPT5Model(cfg, device, dtype)
    _load_vision(model.vision, tree["vision"])
    _load_t5(model.t5, tree["t5"])
    _leaf(model.projector.fc1, tree["projector"]["fc1"])
    _leaf(model.projector.fc2, tree["projector"]["fc2"])
    return model


def _load_decoder(p: tdec.Decoder, tree: dict) -> tdec.Decoder:
    _copy(p.embed, tree["embed"])
    if p.lm_head is not None:
        _copy(p.lm_head, tree["lm_head"])
    _norm(p.ln_final, tree["ln_final"])
    for dst, src in zip(p.blocks, tree["blocks"], strict=True):
        _norm(dst.ln1, src["ln1"])
        _norm(dst.ln2, src["ln2"])
        attn = src["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        if dst.q_norm is not None:
            _norm(dst.q_norm, attn["q_norm"])
            _norm(dst.k_norm, attn["k_norm"])
        for name in ("ln1_post", "ln_ff_pre", "ln_ff_post"):   # sandwich norms
            if getattr(dst, name) is not None:
                _norm(getattr(dst, name), src[name])
        if dst.moe is not None:
            moe = src["mlp"]["moe"]
            _leaf(dst.moe.router, moe["router"])
            _copy(dst.moe.gate_up, moe["gate_up"])
            _copy(dst.moe.down, moe["down"])
        else:
            for name in ("gate", "up", "down"):
                _leaf(getattr(dst, name), src["mlp"][name])
    return p


@torch.no_grad()
def qwen2vl_from_numpy(tree: dict, cfg: tqwen.Qwen2VLConfig, device,
                       dtype) -> tqwen.Qwen2VLModel:
    model = tqwen.Qwen2VLModel(cfg, device, dtype)
    v, src = model.vision, tree["vision"]
    _copy(v.patch_w, src["patch_w"])
    for dst, blk in zip(v.blocks, src["blocks"], strict=True):
        _norm(dst.ln1, blk["ln1"])
        _norm(dst.ln2, blk["ln2"])
        attn = blk["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        for name in ("gate", "up", "down"):
            _leaf(getattr(dst, name), blk["mlp"][name])
    _norm(v.merger.ln_q, src["merger"]["ln_q"])
    _leaf(v.merger.fc1, src["merger"]["fc1"])
    _leaf(v.merger.fc2, src["merger"]["fc2"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


@torch.no_grad()
def qwen3vl_from_numpy(tree: dict, cfg: tqwen3.Qwen3VLConfig, device,
                       dtype) -> tqwen3.Qwen3VLModel:
    model = tqwen3.Qwen3VLModel(cfg, device, dtype)
    v, src = model.vision, tree["vision"]
    for name in ("patch_w", "patch_b", "pos_emb"):
        _copy(getattr(v, name), src[name])
    for dst, blk in zip(v.blocks, src["blocks"], strict=True):
        _norm(dst.ln1, blk["ln1"])
        _norm(dst.ln2, blk["ln2"])
        attn = blk["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, blk["mlp"]["fc1"])
        _leaf(dst.fc2, blk["mlp"]["fc2"])
    for dst, m in zip([v.merger, *v.deepstack], [src["merger"], *src["deepstack"]],
                      strict=True):
        _norm(dst.norm, m["norm"])
        _leaf(dst.fc1, m["fc1"])
        _leaf(dst.fc2, m["fc2"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


def _load_siglip(p: tsiglip.SiglipVisionTower, tree: dict) -> tsiglip.SiglipVisionTower:
    for name in ("patch_w", "patch_b", "pos_emb"):
        _copy(getattr(p, name), tree[name])
    _norm(p.ln_post, tree["ln_post"])
    for dst, src in zip(p.blocks, tree["blocks"], strict=True):
        _norm(dst.ln1, src["ln1"])
        _norm(dst.ln2, src["ln2"])
        attn = src["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, src["mlp"]["fc1"])
        _leaf(dst.fc2, src["mlp"]["fc2"])
    return p


@torch.no_grad()
def gemma3_from_numpy(tree: dict, cfg: tgemma3.Gemma3Config, device,
                      dtype) -> tgemma3.Gemma3Model:
    model = tgemma3.Gemma3Model(cfg, device, dtype)
    _load_siglip(model.vision, tree["vision"])
    _norm(model.projector.norm, tree["projector"]["norm"])
    _copy(model.projector.proj, tree["projector"]["proj"])
    _load_decoder(model.decoder, tree["decoder"])
    return model
