"""CLIP-FlanT5 VQAScore in plain PyTorch, float32: the reference that decides
``correct`` for the clip_flant5 family, and its control.

It follows the published model (LLaVA-style CLIP-FlanT5, Lin et al. 2024,
"Evaluating Text-to-Visual Generation with Image-to-Text Generation"):
Pillow's bicubic resize of the padded-to-square image to 336 px, the CLIP
mean and std; CLIP ViT-L/14-336's patch features after its second-to-last
block (CLS dropped); a two-layer exact-GELU projector; the features written
over the ``<image>`` slot of the LLaVA ``t5_chat`` prompt, each text chunk
ending in ``</s>``; the FlanT5 encoder (RMSNorm, relative-position buckets,
no 1/sqrt(d) scaling, gated gelu_new MLP) and its decoder teacher-forced on
the answer; the score is exp(mean log P(answer tokens)). It imports nothing
of the port: weights come from the benchmark's rule (``weights.py``), the
parameter paths are the port's checkpoint layout (linear weights (in, out),
q|k|v packed along the output, the patch weight in conv (c, ph, pw) row
order), and every layer is built when it is reached and freed after.

``quant="fp8"`` is the control: every matrix product takes its weight per
output column and its input per row in float8 e4m3 (absmax scaled to 448),
the nearest precision below the bf16 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..tokenizer import WordTokenizer
from . import pillow
from .common import Weights, attend, fp8, layer_norm, no_tf32, rms_norm

SYSTEM_MSG = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)
QUESTION_TEMPLATE = 'Does this figure show "{}"? Please answer yes or no.'
ANSWER = "Yes"
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def leaf_rule(cfg: dict):
    """The weight rule of the family, (std, mean) of a leaf by its path:
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.02^2), embeddings of the ViT
    N(0, 0.02^2), linears N(0, 1/fan_in); T5's query columns carry its folded
    1/sqrt(d_kv) (HF T5's init), the token embeddings N(0, 1), the
    relative-position tables N(0, 0.5^2) and lm_head N(0, 1/d_model), so the
    logits are of order one."""
    t5 = cfg["t5"]
    inner = t5["num_heads"] * t5["d_kv"]

    def rule(path: str, shape: tuple):
        last = path.rsplit(".", 1)[-1]
        if last == "scale":
            return 0.1, 1.0
        if last in ("b", "bias"):
            return 0.02, 0.0
        if last in ("class_emb", "pos_emb"):
            return 0.02, 0.0
        if last == "rel_bias":
            return 0.5, 0.0
        if last == "shared_emb":
            return 1.0, 0.0
        if path.startswith("t5.") and path.endswith("attn.qkv.w"):
            std = torch.full((shape[1],), shape[0] ** -0.5)
            std[:inner] = (shape[0] * t5["d_kv"]) ** -0.5
            return std, 0.0
        if path.startswith("t5.") and path.endswith("cross.q.w"):
            return (shape[0] * t5["d_kv"]) ** -0.5, 0.0
        return shape[0] ** -0.5, 0.0

    return rule


def prompt_chunks(prompt: str) -> tuple[str, str]:
    """The ``t5_chat`` prompt of a text, split at its ``<image>`` slot."""
    question = QUESTION_TEMPLATE.format(prompt)
    return SYSTEM_MSG + " USER: ", "\n" + question + " ASSISTANT: "


def encoder_length(cfg: dict, tok: WordTokenizer, prompt: str) -> int:
    a, b = prompt_chunks(prompt)
    return len(tok(a).input_ids) + cfg["num_image_tokens"] + len(tok(b).input_ids)


def answer_length(tok: WordTokenizer) -> int:
    return len(tok(ANSWER).input_ids)


def _rms_norm(x, w: Weights, path: str, width: int, eps: float):
    return rms_norm(x, w(path + ".scale", width), eps)


def _bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
            max_distance: int) -> torch.Tensor:
    """T5's relative-position bucket of ``memory - query`` positions."""
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out = out + (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    exact = num_buckets // 2
    far = rel.clamp(min=exact).float()
    large = exact + (torch.log(far / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return out + torch.where(rel < exact, rel, large)


def _position_bias(w: Weights, stack: str, t5: dict, q: int, k: int, bidirectional: bool):
    table = w(f"t5.{stack}.blocks.0.attn.rel_bias", t5["num_buckets"], t5["num_heads"])
    dev = table.device
    rel = torch.arange(k, device=dev)[None, :] - torch.arange(q, device=dev)[:, None]
    buckets = _bucket(rel, bidirectional, t5["num_buckets"], t5["max_distance"])
    return table[buckets].permute(2, 0, 1)[None]            # (1, H, q, k)


@torch.no_grad()
def _vision_features(cfg: dict, w: Weights, images: list[np.ndarray]) -> torch.Tensor:
    """(M, num_image_tokens, d_model): resize, ViT to the feature layer,
    projector."""
    v = cfg["vision"]
    size, patch, width = v["image_size"], v["patch_size"], v["width"]
    fill = tuple(int(m * 255) for m in CLIP_MEAN)
    mean = torch.tensor(CLIP_MEAN, device=w.device)
    std = torch.tensor(CLIP_STD, device=w.device)
    pix = []
    for img in images:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(w.device)
        if cfg["image_aspect_ratio"] == "pad":
            x = pillow.expand_to_square(x, fill)
        x = pillow.resize(x, size, size).float() / 255.0
        pix.append(((x - mean) / std).permute(2, 0, 1))
    pix = torch.stack(pix)                                     # (M, 3, S, S)
    patch_w = w("vision.patch_w", 3 * patch * patch, width)
    conv = patch_w.T.reshape(width, 3, patch, patch)
    if w.quant is not None:
        conv = fp8(conv.reshape(width, -1), 1).reshape(conv.shape)
    x = F.conv2d(pix, conv, stride=patch).flatten(2).transpose(1, 2)
    m = x.shape[0]
    n_tok = (size // patch) ** 2 + 1
    cls = w("vision.class_emb", width).expand(m, 1, width)
    x = torch.cat([cls, x], 1) + w("vision.pos_emb", n_tok, width)
    eps = v["ln_eps"]
    x = layer_norm(x, w, "vision.ln_pre", width, eps)
    heads = v["heads"]
    for i in range(v["layers"] + 1 + cfg["feature_layer"]):
        p = f"vision.blocks.{i}"
        h = layer_norm(x, w, p + ".ln1", width, eps)
        qkv = w.linear(h, p + ".qkv", width, 3 * width, True)
        q, k, vv = qkv.split(width, -1)
        a = attend(q, k, vv, heads, scale=(width // heads) ** -0.5, quant=w.quant)
        x = x + w.linear(a, p + ".o", width, width, True)
        h = layer_norm(x, w, p + ".ln2", width, eps)
        h = w.linear(h, p + ".fc1", width, v["mlp_dim"], True)
        h = h * torch.sigmoid(1.702 * h)                       # quick_gelu
        x = x + w.linear(h, p + ".fc2", v["mlp_dim"], width, True)
    feats = x[:, 1:]
    d = cfg["t5"]["d_model"]
    h = F.gelu(w.linear(feats, "projector.fc1", width, d, True))
    return w.linear(h, "projector.fc2", d, d, True)


@torch.no_grad()
def _t5_scores(cfg: dict, w: Weights, tok: WordTokenizer, feats: torch.Tensor,
               pairs: list[tuple[int, str]]) -> torch.Tensor:
    """Mean answer log-probability of each (feature row, prompt) pair."""
    t5 = cfg["t5"]
    d, heads, eps = t5["d_model"], t5["num_heads"], t5["eps"]
    inner = heads * t5["d_kv"]
    emb_table = w("t5.shared_emb", t5["vocab_size"], d)
    dev = feats.device
    rows, lengths = [], []
    for mi, prompt in pairs:
        a, b = prompt_chunks(prompt)
        ids_a = torch.tensor(tok(a).input_ids, device=dev)
        ids_b = torch.tensor(tok(b).input_ids, device=dev)
        rows.append(torch.cat([emb_table[ids_a], feats[mi], emb_table[ids_b]]))
        lengths.append(rows[-1].shape[0])
    s = max(lengths)
    x = torch.stack([F.pad(r, (0, 0, 0, s - r.shape[0])) for r in rows])
    mask = torch.arange(s, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    bias = _position_bias(w, "encoder", t5, s, s, True)

    def mlp(h, p):
        g = F.gelu(w.linear(h, p + ".mlp.wi_0", d, t5["d_ff"]), approximate="tanh")
        return w.linear(g * w.linear(h, p + ".mlp.wi_1", d, t5["d_ff"]), p + ".mlp.wo",
                        t5["d_ff"], d)

    for i in range(t5["enc_layers"]):
        p = f"t5.encoder.blocks.{i}"
        h = _rms_norm(x, w, p + ".ln1", d, eps)
        q, k, v = w.linear(h, p + ".attn.qkv", d, 3 * inner).split(inner, -1)
        x = x + w.linear(attend(q, k, v, heads, bias=bias, key_mask=mask, quant=w.quant),
                         p + ".attn.o", inner, d)
        x = x + mlp(_rms_norm(x, w, p + ".ln2", d, eps), p)
    enc = _rms_norm(x, w, "t5.encoder.ln_final", d, eps)

    ans = torch.tensor(tok(ANSWER).input_ids, device=dev)
    n_ans = ans.shape[0]
    dec_in = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), ans[:-1]])
    y = emb_table[dec_in].expand(len(pairs), n_ans, d).clone()
    del emb_table
    dbias = _position_bias(w, "decoder", t5, n_ans, n_ans, False)
    for i in range(t5["dec_layers"]):
        p = f"t5.decoder.blocks.{i}"
        h = _rms_norm(y, w, p + ".ln1", d, eps)
        q, k, v = w.linear(h, p + ".attn.qkv", d, 3 * inner).split(inner, -1)
        y = y + w.linear(attend(q, k, v, heads, bias=dbias, causal=True, quant=w.quant),
                         p + ".attn.o", inner, d)
        h = _rms_norm(y, w, p + ".ln_cross", d, eps)
        a = attend(w.linear(h, p + ".cross.q", d, inner), w.linear(enc, p + ".cross.k", d, inner),
                    w.linear(enc, p + ".cross.v", d, inner), heads, key_mask=mask,
                    quant=w.quant)
        y = y + w.linear(a, p + ".cross.o", inner, d)
        y = y + mlp(_rms_norm(y, w, p + ".ln2", d, eps), p)
    y = _rms_norm(y, w, "t5.decoder.ln_final", d, eps)
    logits = w.mm(y, w("t5.lm_head", d, t5["vocab_size"]))
    logp = torch.log_softmax(logits, -1)
    return logp.gather(-1, ans.expand(len(pairs), n_ans)[..., None])[..., 0].mean(-1)


def log_scores(cfg: dict, seed: int, media: list, prompts: list[str],
               pairs: list[tuple[int, int]], device, quant: str | None = None) -> np.ndarray:
    """log VQAScore of each (media index, prompt index) pair: ``media`` the
    raw uint8 (H, W, 3) images, ``prompts`` the texts."""
    with no_tf32():
        w = Weights(leaf_rule(cfg), seed, device, getattr(torch, cfg["dtype"]), quant)
        tok = WordTokenizer(cfg["t5"]["vocab_size"])
        uniq = sorted({mi for mi, _ in pairs})
        row = {mi: r for r, mi in enumerate(uniq)}
        feats = _vision_features(cfg, w, [media[mi] for mi in uniq])
        out = _t5_scores(cfg, w, tok, feats, [(row[mi], prompts[pi]) for mi, pi in pairs])
        return out.double().cpu().numpy()
