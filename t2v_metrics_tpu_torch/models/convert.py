"""HF checkpoint -> parameter trees (port of t2v_metrics_tpu/models/convert.py,
under the same names).

A converter reads an HF state dict (any ``Mapping`` from key to tensor: the
lazy views of ``checkpoint.load_safetensors_dict`` or a ``torch.load``-ed
dict) and returns a tree in the JAX package's layout
(linear weights (in, out), the conv patch embedding as a (3*p*p, width)
matrix) whose leaves are CPU tensor views: a transpose is a view, not a
copy, and no dtype is cast here. ``bridge.py`` copies each leaf to the
device in its own dtype and casts it there.

The BLIP-2 ITM converter is ``models/blip2_itm.py:convert_blip2_itm``.
"""

from __future__ import annotations

import torch


def t2np(t):
    """A checkpoint tensor as a detached CPU view (no copy); anything else
    (the stand-in ``checkpoint.convert_checked`` gives for a missing key)
    passes through."""
    return t.detach() if isinstance(t, torch.Tensor) else t


def _lin(sd, prefix):
    """torch Linear (out, in) -> {w: (in, out) view, b}."""
    bias = prefix + ".bias"
    return {"w": t2np(sd[prefix + ".weight"]).t(),
            "b": t2np(sd[bias]) if bias in sd else None}


def _ln(sd, prefix):
    return {"scale": t2np(sd[prefix + ".weight"]),
            "bias": t2np(sd[prefix + ".bias"])}


def patch_matrix(conv_w):
    """A conv patch embedding (width, C, [T,] p, p) as the (C*[T*]p*p,
    width) matmul weight of ``ops.image.patchify`` (a view)."""
    conv_w = t2np(conv_w)
    return conv_w.reshape(conv_w.shape[0], -1).t()


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def _clip_block(sd, p):
    return {
        "ln1": _ln(sd, f"{p}.layer_norm1"),
        "attn": {
            "q": _lin(sd, f"{p}.self_attn.q_proj"),
            "k": _lin(sd, f"{p}.self_attn.k_proj"),
            "v": _lin(sd, f"{p}.self_attn.v_proj"),
            "o": _lin(sd, f"{p}.self_attn.out_proj"),
        },
        "ln2": _ln(sd, f"{p}.layer_norm2"),
        "mlp": {
            "fc1": _lin(sd, f"{p}.mlp.fc1"),
            "fc2": _lin(sd, f"{p}.mlp.fc2"),
        },
    }


def convert_clip_vision(sd, num_layers: int, prefix="vision_model"):
    """HF CLIPVisionModel(+projection) state dict -> the vision tree. ``proj``
    is None without ``visual_projection.weight`` (a LLaVA tower has none)."""
    return {
        "class_emb": t2np(sd[f"{prefix}.embeddings.class_embedding"]),
        "patch_w": patch_matrix(sd[f"{prefix}.embeddings.patch_embedding.weight"]),
        "pos_emb": t2np(sd[f"{prefix}.embeddings.position_embedding.weight"]),
        "ln_pre": _ln(sd, f"{prefix}.pre_layrnorm"),
        "blocks": [_clip_block(sd, f"{prefix}.encoder.layers.{i}")
                   for i in range(num_layers)],
        "ln_post": _ln(sd, f"{prefix}.post_layernorm"),
        "proj": (t2np(sd["visual_projection.weight"]).t()
                 if "visual_projection.weight" in sd else None),
    }


def convert_clip_text(sd, num_layers: int, prefix="text_model"):
    """HF CLIPTextModel(+projection) state dict -> the text tree. ``proj`` is
    None without ``text_projection.weight``."""
    return {
        "tok_emb": t2np(sd[f"{prefix}.embeddings.token_embedding.weight"]),
        "pos_emb": t2np(sd[f"{prefix}.embeddings.position_embedding.weight"]),
        "blocks": [_clip_block(sd, f"{prefix}.encoder.layers.{i}")
                   for i in range(num_layers)],
        "ln_final": _ln(sd, f"{prefix}.final_layer_norm"),
        "proj": (t2np(sd["text_projection.weight"]).t()
                 if "text_projection.weight" in sd else None),
    }


def convert_clip(sd, vision_layers: int, text_layers: int):
    """HF CLIPModel state dict -> {vision, text, logit_scale}."""
    return {
        "vision": convert_clip_vision(sd, vision_layers),
        "text": convert_clip_text(sd, text_layers),
        "logit_scale": t2np(sd["logit_scale"]),
    }


# ---------------------------------------------------------------------------
# T5 (FlanT5 encoder-decoder)
# ---------------------------------------------------------------------------

def _t5_lin(sd, name):
    return {"w": t2np(sd[name]).t(), "b": None}


def _t5_attn(sd, p):
    out = {k: _t5_lin(sd, f"{p}.{k}.weight") for k in ("q", "k", "v", "o")}
    rel = f"{p}.relative_attention_bias.weight"
    if rel in sd:
        out["rel_bias"] = t2np(sd[rel])  # (num_buckets, heads)
    return out


def _t5_rms(sd, p):
    return {"scale": t2np(sd[p + ".weight"])}


def _t5_mlp(sd, p, gated: bool):
    names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
    return {k: _t5_lin(sd, f"{p}.{k}.weight") for k in names}


def convert_t5(sd, num_layers_enc: int, num_layers_dec: int,
               gated: bool = True, prefix: str = ""):
    """HF T5ForConditionalGeneration state dict -> the T5 tree.

    encoder.block.N.layer.0 = self-attn, layer.1 = mlp; decoder layer.0
    self-attn, layer.1 cross-attn, layer.2 mlp. ``lm_head`` is None with
    tied embeddings."""
    P = prefix
    enc_blocks = []
    for i in range(num_layers_enc):
        b = f"{P}encoder.block.{i}"
        enc_blocks.append({
            "ln1": _t5_rms(sd, f"{b}.layer.0.layer_norm"),
            "attn": _t5_attn(sd, f"{b}.layer.0.SelfAttention"),
            "ln2": _t5_rms(sd, f"{b}.layer.1.layer_norm"),
            "mlp": _t5_mlp(sd, f"{b}.layer.1.DenseReluDense", gated),
        })
    dec_blocks = []
    for i in range(num_layers_dec):
        b = f"{P}decoder.block.{i}"
        dec_blocks.append({
            "ln1": _t5_rms(sd, f"{b}.layer.0.layer_norm"),
            "attn": _t5_attn(sd, f"{b}.layer.0.SelfAttention"),
            "ln_cross": _t5_rms(sd, f"{b}.layer.1.layer_norm"),
            "cross": _t5_attn(sd, f"{b}.layer.1.EncDecAttention"),
            "ln2": _t5_rms(sd, f"{b}.layer.2.layer_norm"),
            "mlp": _t5_mlp(sd, f"{b}.layer.2.DenseReluDense", gated),
        })
    lm_head = f"{P}lm_head.weight"
    return {
        "shared_emb": t2np(sd[f"{P}shared.weight"]),
        "encoder": {"blocks": enc_blocks,
                    "ln_final": _t5_rms(sd, f"{P}encoder.final_layer_norm")},
        "decoder": {"blocks": dec_blocks,
                    "ln_final": _t5_rms(sd, f"{P}decoder.final_layer_norm")},
        "lm_head": t2np(sd[lm_head]).t() if lm_head in sd else None,
    }
