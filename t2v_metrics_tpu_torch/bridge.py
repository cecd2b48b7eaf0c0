"""Carry parameter trees into the port, and out of it.

Input: a parameter tree in t2v_metrics_tpu's layout (nested dicts and
lists) whose leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray,
params)``, bf16 as ml_dtypes or as raw 2-byte records) or CPU tensors (the
views ``models/convert.py`` makes of a checkpoint, or a native tree from
``checkpoint.load_params``). Output: the port's modules on ``device`` in
``dtype``, computing the same function. Each leaf goes to the device in its
own dtype and is cast there: no host copy of a tensor leaf (a transposed
view travels as its dense bytes and is transposed on the device), and bf16
stays bitwise bf16. Views of a mapped checkpoint shard give their pages
back once copied (``checkpoint.release_pages``). Int8 leaves of the JAX
W8A8 mode (``{"w_q": int8 (K, N), "scale": f32 (N,)}``, plus ``"b"``)
become the port's int8 leaves, with the gated T5 MLP's wi_0|wi_1 packed
into ``wi_01``. The self-attention q|k|v weights (and biases) are written
side by side into the packed leaf, in the order ``ops/quant.pack`` and the
JAX package's ``mm_packed`` use, so no forward pass concatenates weights.

``shape_problems`` runs a loader over a tree onto a model built on
``torch.device("meta")`` with every check collected instead of raised: each
leaf that is missing, does not fit, or is never read, by its path in the
tree. That is the checkpoint shape check (``checkpoint.validate_params_dims``);
the loaders are the one statement of each family's layout.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
from torch import nn

from .models import blip2_itm as tbitm
from .models import clip as tclip
from .models import clip_flant5 as tcft5
from .models import decoder as tdec
from .models import gemma3 as tgemma3
from .models import instructblip as tib
from .models import internvl as tivl
from .models import llava as tllava
from .models import molmo2 as tm2
from .models import paligemma as tpg
from .models import qwen2vl as tqwen
from .models import qwen3omni as tomni
from .models import qwen3omni_talker as ttalk
from .models import qwen3vl as tqwen3
from .models import siglip as tsiglip
from .models import t5 as tt5
from .models.checkpoint import _flatten, release_pages
from .ops import quant as Q
from .parallel.mesh import build_sharded


def _as_tensor(src) -> torch.Tensor:
    """A leaf as a CPU tensor without a copy where one is not needed: bf16
    numpy bits through an int16 view, float64 as float32 (as the JAX
    package holds it)."""
    if isinstance(src, torch.Tensor):
        return src.detach()
    a = np.asarray(src)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    with warnings.catch_warnings():  # read-only arrays: the tensor is only read
        warnings.simplefilter("ignore", UserWarning)
        # (ascontiguousarray makes a 0-d array 1-d: logit_scale keeps its shape)
        return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)


def _copy(dst: torch.Tensor, src) -> None:
    if _AUDIT is not None:
        _AUDIT.fit(dst.shape, src)
        return
    t = _as_tensor(src)
    shard = getattr(dst, "shard", None)
    if shard is not None:   # a rank's share (parallel/mesh.py): slice the source
        t = shard.take(t)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit {tuple(dst.shape)}")
    if t.dtype == dst.dtype and t.stride() == dst.stride():
        dst.copy_(t)                 # one host-to-device copy into place
    else:
        dst.copy_(t.to(dst.device))  # the leaf's bytes as they are, then cast/transpose
    release_pages(t)


def _copy_int8(dst: Q.Linear, w_q, scale) -> None:
    """Make ``dst`` an int8 leaf holding the JAX leaf's (K, N) ``w_q`` and
    (N,) ``scale``, stored as the port's (N, K) ``w_qt``."""
    dense = dst.w if dst.w is not None else dst.w_q
    if _AUDIT is not None:
        _AUDIT.fit(dense.shape, w_q)
        _AUDIT.fit(dense.shape[1:], scale)
        return
    w_q, scale = _as_tensor(w_q), _as_tensor(scale).float()
    shard = getattr(dense, "shard", None)
    if shard is not None:   # a rank's share: the scale follows the output columns
        w_q = shard.take(w_q)
        if shard.dim == 1:
            scale = dataclasses.replace(shard, full_shape=shard.full_shape[1:],
                                        dim=0).take(scale)
    if (w_q.dtype != torch.int8 or tuple(w_q.shape) != tuple(dense.shape)
            or tuple(scale.shape) != tuple(w_q.shape[1:])):
        raise ValueError(f"int8 leaf {w_q.dtype} {tuple(w_q.shape)} / {tuple(scale.shape)} "
                         f"does not fit {tuple(dense.shape)}")
    dev = dense.device
    dst.w = None
    dst.w_qt = nn.Parameter(w_q.t().contiguous().to(dev), requires_grad=False)
    dst.scale = nn.Parameter(scale.contiguous().to(dev), requires_grad=False)


def _leaf(dst: Q.Linear, src: dict) -> None:
    if "w_q" in src:
        _copy_int8(dst, src["w_q"], src["scale"])
    else:
        _copy(dst.w, src["w"])
    if dst.b is not None:
        _copy(dst.b, src["b"])


def _packed_leaf(dst: Q.Linear, srcs: list[dict]) -> None:
    """Write the leaves' columns side by side into the packed ``dst``."""
    if _AUDIT is not None:
        _AUDIT.packed(dst, srcs)
        return
    if "w_q" in srcs[0]:
        _copy_int8(dst, torch.cat([_as_tensor(s["w_q"]) for s in srcs], dim=1),
                   torch.cat([_as_tensor(s["scale"]) for s in srcs]))
    elif hasattr(dst.w, "shard"):   # a rank's share of each part, cut from their pack
        _copy(dst.w, torch.cat([_as_tensor(s["w"]) for s in srcs], dim=1))
    else:
        widths = [_as_tensor(s["w"]).shape[-1] for s in srcs]
        if sum(widths) != dst.w.shape[1]:
            raise ValueError(f"packed leaf: widths {widths} do not fill {tuple(dst.w.shape)}")
        off = 0
        for s, n in zip(srcs, widths):
            _copy(dst.w[:, off:off + n], s["w"])
            off += n
    if dst.b is not None and hasattr(dst.b, "shard"):
        _copy(dst.b, torch.cat([_as_tensor(s["b"]) for s in srcs]))
    elif dst.b is not None:
        off = 0
        for s in srcs:
            n = _as_tensor(s["b"]).shape[0]
            _copy(dst.b[off:off + n], s["b"])
            off += n
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


def _load_vit_blocks(blocks, tree_blocks) -> None:
    """Pre-LN ViT blocks (CLIP's both towers, SigLIP, EVA): ln1, the packed
    q|k|v, o, ln2, fc1, fc2."""
    for dst, src in _pairs(blocks, tree_blocks):
        _norm(dst.ln1, src["ln1"])
        _norm(dst.ln2, src["ln2"])
        attn = src["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, src["mlp"]["fc1"])
        _leaf(dst.fc2, src["mlp"]["fc2"])


def _load_vision(p: tclip.VisionTower, tree: dict) -> tclip.VisionTower:
    for name in ("class_emb", "patch_w", "pos_emb"):
        _copy(getattr(p, name), tree[name])
    if tree.get("proj") is None:
        p.proj = None  # a LLaVA tower has no projection (feature_layer=-2 reads none)
    else:
        _copy(p.proj, tree["proj"])
    _norm(p.ln_pre, tree["ln_pre"])
    _norm(p.ln_post, tree["ln_post"])
    _load_vit_blocks(p.blocks, tree["blocks"])
    return p


@torch.no_grad()
def clip_from_numpy(tree: dict, cfg: tuple, device, dtype, mesh=None) -> tclip.CLIPModel:
    """CLIPScore's tree ({vision, text, logit_scale}); ``cfg`` is the
    (vision, text) config pair. ``mesh``: each rank loads its share only
    (``parallel/mesh.py:build_sharded``)."""
    model = build_sharded(tclip.CLIPModel, (*cfg,), device, dtype, mesh)
    _load_vision(model.vision, tree["vision"])
    t, src = model.text, tree["text"]
    for name in ("tok_emb", "pos_emb", "proj"):
        _copy(getattr(t, name), src[name])
    _norm(t.ln_final, src["ln_final"])
    _load_vit_blocks(t.blocks, src["blocks"])
    _copy(model.logit_scale, tree["logit_scale"])
    return model


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
        for dst, src in _pairs(stack.blocks, src_stack["blocks"]):
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
                       dtype, mesh=None) -> tcft5.CLIPT5Model:
    """``mesh``: each rank loads its share only
    (``parallel/mesh.py:build_sharded``)."""
    model = build_sharded(tcft5.CLIPT5Model, (cfg,), device, dtype, mesh)
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
    for dst, src in _pairs(p.blocks, tree["blocks"]):
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
            if dst.moe.shared is not None:     # Qwen3-Omni's talker
                for name in ("gate", "up", "down"):
                    _leaf(getattr(dst.moe.shared, name), moe["shared"][name])
                _leaf(dst.moe.shared_gate, moe["shared_gate"])
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
    for dst, blk in _pairs(v.blocks, src["blocks"]):
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
    _load_qwen3_vision(model.vision, tree["vision"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


def _load_qwen3_vision(v: tqwen3.VisionTower, src: dict) -> None:
    for name in ("patch_w", "patch_b", "pos_emb"):
        _copy(getattr(v, name), src[name])
    for dst, blk in _pairs(v.blocks, src["blocks"]):
        _norm(dst.ln1, blk["ln1"])
        _norm(dst.ln2, blk["ln2"])
        attn = blk["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, blk["mlp"]["fc1"])
        _leaf(dst.fc2, blk["mlp"]["fc2"])
    for dst, m in [(v.merger, src["merger"]), *_pairs(v.deepstack, src["deepstack"])]:
        _norm(dst.norm, m["norm"])
        _leaf(dst.fc1, m["fc1"])
        _leaf(dst.fc2, m["fc2"])


@torch.no_grad()
def qwen3omni_from_numpy(tree: dict, cfg: tomni.Qwen3OmniConfig, device,
                         dtype) -> tomni.Qwen3OmniModel:
    """The thinker's scoring path: the audio tower (q|k|v packed into one
    leaf), the Qwen3-VL vision tower and the MoE decoder."""
    model = tomni.Qwen3OmniModel(cfg, device, dtype)
    a, src = model.audio, tree["audio"]
    for i, (w, b) in enumerate(zip(a.conv_w, a.conv_b), 1):
        _copy(w, src[f"conv{i}"]["w"])
        _copy(b, src[f"conv{i}"]["b"])
    _copy(a.conv_out, src["conv_out"]["w"])
    _load_vit_blocks(a.blocks, src["blocks"])
    _norm(a.ln_post, src["ln_post"])
    _leaf(a.proj1, src["proj1"])
    _leaf(a.proj2, src["proj2"])
    _load_qwen3_vision(model.vision, tree["vision"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


@torch.no_grad()
def talker_from_numpy(tree: dict, cfg: ttalk.TalkerConfig, device,
                      dtype) -> ttalk.TalkerModel:
    """Qwen3-Omni's talker from the JAX package's tree (``convert_talker``'s,
    either package's): the MoE decoder with its shared experts and codec
    head, the code predictor and the two projections, whose inner width is
    read from the tree. The decoder layers are read one at a time, so a
    lazily converted tree (the port's ``convert_talker``) holds one layer's
    stacked experts at a time."""
    proj_ff = _as_tensor(tree["text_projection"]["fc1"]["w"]).shape[1]
    model = ttalk.TalkerModel(cfg, proj_ff, device, dtype)
    _load_decoder(model.decoder, tree["decoder"])
    pred, src = model.predictor, tree["predictor"]
    _load_decoder(pred.decoder, src["decoder"])
    for dst, t in _pairs(pred.group_embeds, src["group_embeds"]):
        _copy(dst, t)
    for dst, t in _pairs(pred.heads, src["heads"]):
        _copy(dst, t)
    for name in ("text_projection", "hidden_projection"):
        _leaf(getattr(model, name).fc1, tree[name]["fc1"])
        _leaf(getattr(model, name).fc2, tree[name]["fc2"])
    return model


def _load_conv(dst, src: dict) -> None:
    _copy(dst.w, src["w"])
    _copy(dst.b, src["b"])


def _load_snake(dst: ttalk.Snake, src: dict) -> None:
    _copy(dst.alpha, src["alpha"])
    _copy(dst.beta, src["beta"])


@torch.no_grad()
def code2wav_from_numpy(tree: dict, cfg: ttalk.Code2WavConfig, device,
                        dtype) -> ttalk.Code2WavModel:
    """Qwen3-Omni's Code2Wav from the JAX package's tree: the transformer
    (q|k|v packed), the upsampling stages and the decoder blocks. The tree's
    factors, strides and dilations are the config's and are not read."""
    model = ttalk.Code2WavModel(cfg, device, dtype)
    _copy(model.code_embedding, tree["code_embedding"])
    pre = tree["pre_transformer"]
    for dst, blk in _pairs(model.blocks, pre["blocks"]):
        _norm(dst.ln1, blk["ln1"])
        _norm(dst.ln2, blk["ln2"])
        attn = blk["attn"]
        _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        _leaf(dst.o, attn["o"])
        for name in ("gate", "up", "down"):
            _leaf(getattr(dst, name), blk["mlp"][name])
        _copy(dst.scale_attn, blk["scale_attn"])
        _copy(dst.scale_mlp, blk["scale_mlp"])
    _norm(model.ln_final, pre["ln_final"])
    for dst, up in _pairs(model.upsample, tree["upsample"]):
        nx = up["convnext"]
        _load_conv(dst.tconv, up["tconv"])
        _load_conv(dst.dw, nx["dw"])
        _norm(dst.norm, nx["norm"])
        _leaf(dst.fc1, nx["fc1"])
        _leaf(dst.fc2, nx["fc2"])
        _copy(dst.gamma, nx["gamma"])
    _load_conv(model.dec_pre, tree["dec_pre"])
    for dst, blk in _pairs(model.dec_blocks, tree["dec_blocks"]):
        _load_snake(dst.snake, blk["snake"])
        _load_conv(dst.tconv, blk["tconv"])
        for ru, src in _pairs(dst.res_units, blk["res_units"]):
            _load_snake(ru.snake1, src["snake1"])
            _load_conv(ru.conv1, src["conv1"])
            _load_snake(ru.snake2, src["snake2"])
            _load_conv(ru.conv2, src["conv2"])
    _load_snake(model.dec_snake, tree["dec_snake"])
    _load_conv(model.dec_post, tree["dec_post"])
    return model


def _load_siglip(p: tsiglip.SiglipVisionTower, tree: dict) -> tsiglip.SiglipVisionTower:
    for name in ("patch_w", "patch_b", "pos_emb"):
        _copy(getattr(p, name), tree[name])
    _norm(p.ln_post, tree["ln_post"])
    _load_vit_blocks(p.blocks, tree["blocks"])
    return p


@torch.no_grad()
def paligemma_from_numpy(tree: dict, cfg: tpg.PaliGemmaConfig, device,
                         dtype) -> tpg.PaliGemmaModel:
    model = tpg.PaliGemmaModel(cfg, device, dtype)
    _load_siglip(model.vision, tree["vision"])
    _leaf(model.projector, tree["projector"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


@torch.no_grad()
def llava_from_numpy(tree: dict, cfg: tllava.LlavaConfig, device,
                     dtype) -> tllava.LlavaModel:
    model = tllava.LlavaModel(cfg, device, dtype)
    _load_vision(model.vision, tree["vision"])
    _leaf(model.projector.fc1, tree["projector"]["fc1"])
    _leaf(model.projector.fc2, tree["projector"]["fc2"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


@torch.no_grad()
def gemma3_from_numpy(tree: dict, cfg: tgemma3.Gemma3Config, device,
                      dtype) -> tgemma3.Gemma3Model:
    model = tgemma3.Gemma3Model(cfg, device, dtype)
    _load_siglip(model.vision, tree["vision"])
    _norm(model.projector.norm, tree["projector"]["norm"])
    _copy(model.projector.proj, tree["projector"]["proj"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


def _unbiased_(dst: Q.Linear, src) -> None:
    """Drop ``dst``'s bias where the source leaf has none (InternViT's q|k|v
    carry a bias in the 300M tower's checkpoints, none in the 6B tower's)."""
    if dst.b is not None and src.get("b") is None:
        dst.b = None


@torch.no_grad()
def internvl_from_numpy(tree: dict, cfg: tivl.InternVLConfig, device,
                        dtype) -> tivl.InternVLModel:
    model = tivl.InternVLModel(cfg, device, dtype)
    v, src = model.vision, tree["vision"]
    for name in ("cls", "patch_w", "patch_b", "pos_emb"):
        _copy(getattr(v, name), src[name])
    for dst, blk in _pairs(v.blocks, src["blocks"]):
        _norm(dst.ln1, blk["ln1"])
        _norm(dst.ln2, blk["ln2"])
        attn = blk["attn"]
        if dst.qkv is not None:
            _unbiased_(dst.qkv, attn["q"])
            _packed_leaf(dst.qkv, [attn["q"], attn["k"], attn["v"]])
        else:
            for name in ("q", "k", "v"):
                _unbiased_(getattr(dst, name), attn[name])
                _leaf(getattr(dst, name), attn[name])
            _norm(dst.q_norm, attn["q_norm"])
            _norm(dst.k_norm, attn["k_norm"])
        _unbiased_(dst.o, attn["o"])
        _leaf(dst.o, attn["o"])
        _leaf(dst.fc1, blk["mlp"]["fc1"])
        _leaf(dst.fc2, blk["mlp"]["fc2"])
        _copy(dst.lambda_1, blk["lambda_1"])
        _copy(dst.lambda_2, blk["lambda_2"])
    proj = tree["projector"]
    _norm(model.projector.ln, proj["ln"])
    _leaf(model.projector.fc1, proj["fc1"])
    _leaf(model.projector.fc2, proj["fc2"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


@torch.no_grad()
def molmo2_from_numpy(tree: dict, cfg: tm2.Molmo2Config, device,
                      dtype) -> tm2.Molmo2Model:
    model = tm2.Molmo2Model(cfg, device, dtype)
    _load_vision(model.vision, tree["vision"])
    _leaf(model.connector.fc1, tree["connector"]["fc1"])
    _leaf(model.connector.fc2, tree["connector"]["fc2"])
    _load_decoder(model.decoder, tree["decoder"])
    return model


def _load_bert_attn(dst: tbitm.BertAttention, src: dict) -> None:
    if dst.qkv is not None:
        _packed_leaf(dst.qkv, [src["q"], src["k"], src["v"]])
    else:
        _leaf(dst.q, src["q"])
        _packed_leaf(dst.kv, [src["k"], src["v"]])
    _leaf(dst.o, src["o"])
    _norm(dst.ln, src["ln"])


def _load_bert_ffn(dst: tbitm.BertFFN, src: dict) -> None:
    _leaf(dst.fc1, src["fc1"])
    _leaf(dst.fc2, src["fc2"])
    _norm(dst.ln, src["ln"])


@torch.no_grad()
def blip2_itm_from_numpy(tree: dict, cfg: tbitm.Blip2ITMConfig, device,
                         dtype) -> tbitm.Blip2ITMModel:
    model = tbitm.Blip2ITMModel(cfg, device, dtype)
    _load_tower_qformer(model, tree)
    _leaf(model.itm_head, tree["itm_head"])
    return model


@torch.no_grad()
def instructblip_from_numpy(tree: dict, cfg: tib.InstructBlipConfig, device,
                            dtype) -> tib.InstructBlipModel:
    model = tib.InstructBlipModel(cfg, device, dtype)
    _load_tower_qformer(model, tree)
    _leaf(model.proj, tree["proj"])
    _load_t5(model.t5, tree["t5"])
    return model


def _load_tower_qformer(model, tree: dict) -> None:
    """The EVA tower, the Q-Former and the query tokens of BLIP-2 ITM and
    InstructBLIP."""
    v, src = model.vision, tree["vision"]
    for name in ("class_emb", "patch_w", "patch_b", "pos_emb"):
        _copy(getattr(v, name), src[name])
    _norm(v.ln_post, src["ln_post"])
    _load_vit_blocks(v.blocks, src["blocks"])
    qf, src = model.qformer, tree["qformer"]
    for name in ("word_emb", "pos_emb"):
        _copy(getattr(qf, name), src[name])
    _norm(qf.ln_emb, src["ln_emb"])
    for dst, layer in _pairs(qf.layers, src["layers"]):
        _load_bert_attn(dst.self_attn, layer["self"])
        if dst.cross is not None:
            _load_bert_attn(dst.cross, layer["cross"])
        _load_bert_ffn(dst.ffn_query, layer["ffn_query"])
        _load_bert_ffn(dst.ffn_text, layer["ffn_text"])
    _copy(model.query_tokens, tree["query_tokens"])


# ---------------------------------------------------------------------------
# Shape checks: a loader run onto the meta device, every problem collected
# ---------------------------------------------------------------------------

class _Missing:
    """A key the tree lacks (or holds as None), as an audited loader sees it:
    every key below it is missing too."""

    shape = None

    def __init__(self, path: str):
        self.path = path

    def __getitem__(self, key):
        return _Missing(f"{self.path}/{key}")

    def __contains__(self, key) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def get(self, key, default=None):
        return default


class _Tree(dict):
    """A dict node of an audited tree: a key read is recorded, a key it lacks
    reads as a ``_Missing`` naming its path (``get`` still gives None)."""

    def __init__(self, node: dict, path: str):
        super().__init__(node)
        self.path = path

    def __getitem__(self, key):
        path = f"{self.path}{key}"
        v = dict.get(self, key)
        if v is None:
            return _Missing(path)
        _AUDIT.read.add(path)
        _AUDIT.paths[id(v)] = path
        return _wrap(v, path)

    def get(self, key, default=None):
        return self[key] if dict.get(self, key) is not None else default


class _Seq(list):
    """A list node of an audited tree; its path names a block it lacks."""

    def __init__(self, items, path: str):
        super().__init__(items)
        self.path = path


def _wrap(node, path: str):
    if isinstance(node, dict):
        return _Tree(node, f"{path}/" if path else "")
    if isinstance(node, (list, tuple)):
        return _Seq([_wrap(v, f"{path}/{i}") for i, v in enumerate(node)], path)
    return node


def _pairs(dsts, srcs):
    """(module, source) pairs of a stack: the lengths must agree, except in
    an audit, where a source the stack lacks reads as missing and one past
    the stack stays unread."""
    if _AUDIT is None:
        return zip(dsts, srcs, strict=True)
    return [(d, srcs[i] if i < len(srcs) else _Missing(f"{srcs.path}/{i}"))
            for i, d in enumerate(dsts)]


class _Audit:
    """What a loader run under ``shape_problems`` found: the paths it read
    and (path, message) for each leaf missing or misshapen."""

    def __init__(self):
        self.read, self.paths, self.problems = set(), {}, []

    def fit(self, shape, src) -> None:
        shape = tuple(shape)
        if isinstance(src, _Missing):
            self.problems.append((src.path, f"missing: {src.path} (expected {shape})"))
        elif tuple(src.shape) != shape:
            path = self.paths[id(src)]
            self.problems.append((path, f"shape mismatch: {path} checkpoint "
                                        f"{tuple(src.shape)} != config {shape}"))

    def packed(self, dst: Q.Linear, srcs: list) -> None:
        """The parts of a packed leaf: their rows fit, their columns fill it."""
        for key, full in (("w", dst.w), ("b", dst.b)):
            if full is None:
                continue
            parts = [s["w_q"] if key == "w" and "w_q" in s else s[key] for s in srcs]
            for s, q in zip(srcs, parts):
                if key == "w" and "w_q" in s and not isinstance(q, _Missing):
                    self.fit(q.shape[1:], s["scale"])
            missing = [q for q in parts if isinstance(q, _Missing)]
            for q in missing:
                self.problems.append((q.path, f"missing: {q.path} (expected columns of "
                                              f"{tuple(full.shape)})"))
            got = [tuple(q.shape) for q in parts if not isinstance(q, _Missing)]
            if (not missing and sum(g[-1] for g in got) != full.shape[-1]) \
                    or any(g[:-1] != tuple(full.shape[:-1]) for g in got):
                paths = [self.paths[id(q)] for q in parts if not isinstance(q, _Missing)]
                self.problems.append((paths[0], f"shape mismatch: {' | '.join(paths)} "
                                                f"checkpoint {got} do not pack into config "
                                                f"{tuple(full.shape)}"))


_AUDIT: _Audit | None = None


def shape_problems(load, tree) -> list[str]:
    """Every way ``tree`` does not fit the model ``load`` builds, one line a
    leaf in path order: ``load(tree)`` (a family's ``*_from_numpy`` onto
    ``torch.device("meta")``) runs once, reading no leaf's data, with each
    check collected instead of raised; a leaf it never read is unexpected."""
    global _AUDIT
    audit = _AUDIT = _Audit()
    try:
        load(_wrap(tree, ""))
    finally:
        _AUDIT = None
    flat = _flatten(tree)
    unread = [(k, f"unexpected: {k} {tuple(v.shape)}") for k, v in flat.items()
              if v is not None and k not in audit.read]
    return ["  " + msg for _, msg in sorted(audit.problems + unread)]
