"""Qwen3-VL (dense or MoE) VQAScore on images in plain PyTorch, float32: the
reference that decides ``correct`` for the qwen3_vl family, and its control.

It follows the published model (HF ``Qwen3VLMoeForConditionalGeneration``
and qwen_vl_utils): ``smart_resize`` to multiples of patch x merge within the
pixel limits, Pillow's bicubic resize, the configuration's ``image_mean``
and ``image_std`` (the published preprocessor's), each image tiled over the
temporal patch; the ViT with a biased patch embedding,
learned position embeddings bilinearly interpolated from their square table,
2-D rotary embeddings, LayerNorm blocks with a GELU-tanh MLP, the merger
over each 2x2 group, and the deepstack mergers of the tapped blocks; the chat
prompt with the image's vision tokens, interleaved M-RoPE positions, the
decoder (RMSNorm, qk-norm, GQA, SwiGLU experts with a softmax router,
top-k renormalised), the deepstack features added to the visual positions
after the first layers; the score is exp(mean log P(answer tokens)). It
imports nothing of the port: weights come from the benchmark's rule, the
parameter paths are the port's checkpoint layout (linear weights (in, out),
q|k|v packed, the patch weight with rows in (c, t, ph, pw) order, the
experts' gate|up (E, H, 2I) and down (E, I, H)), and every layer is built
when it is reached and freed after. ``quant="fp8"`` is the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..tokenizer import WordTokenizer
from . import pillow
from .common import Weights, attend, layer_norm, no_tf32, rms_norm, rotate_half

CHAT_PRE = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
CHAT_POST = "{question}<|im_end|>\n<|im_start|>assistant\n"
QUESTION_TEMPLATE = 'Does this figure show "{}"? Please answer Yes or No.'
ANSWER = "Yes"


def leaf_rule(cfg: dict):
    """(std, mean) of a leaf by its path: norm scales 1 + N(0, 0.1^2),
    biases N(0, 0.02^2), the vision position table N(0, 0.5^2), token
    embeddings N(0, 1), lm_head N(0, 1/d_model), the router N(0, 9/d_model)
    (logits of a few units, so the top-k is not a near tie everywhere),
    every other weight N(0, 1/fan_in) (the experts' per expert)."""

    def rule(path: str, shape: tuple):
        last = path.rsplit(".", 1)[-1]
        if last == "scale":
            return 0.1, 1.0
        if last in ("b", "bias", "patch_b"):
            return 0.02, 0.0
        if last == "pos_emb":
            return 0.5, 0.0
        if last == "embed":
            return 1.0, 0.0
        if path.endswith("router.w"):
            return 3.0 * shape[0] ** -0.5, 0.0
        if last in ("gate_up", "down"):
            return shape[1] ** -0.5, 0.0
        return shape[0] ** -0.5, 0.0

    return rule


def smart_resize(h: int, w: int, factor: int, min_pixels: int, max_pixels: int):
    """qwen_vl_utils' ``smart_resize``: the nearest multiples of ``factor``
    with the pixel count brought within [min_pixels, max_pixels]."""
    h_bar = max(factor, round(h / factor) * factor)
    w_bar = max(factor, round(w / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        h_bar = max(factor, math.floor(h / beta / factor) * factor)
        w_bar = max(factor, math.floor(w / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        h_bar = math.ceil(h * beta / factor) * factor
        w_bar = math.ceil(w * beta / factor) * factor
    return h_bar, w_bar


def grid_of(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The patch grid (rows, columns) of an h x w image."""
    v = cfg["vision"]
    hb, wb = smart_resize(h, w, v["patch_size"] * v["merge_size"],
                          cfg["image_resize"]["min_pixels"], cfg["image_resize"]["max_pixels"])
    return hb // v["patch_size"], wb // v["patch_size"]


def prompt_ids(cfg: dict, tok: WordTokenizer, prompt: str, n_vis: int) -> list[int]:
    question = QUESTION_TEMPLATE.format(prompt)
    return (tok.encode(CHAT_PRE, add_special_tokens=False) + [cfg["vision_start_token_id"]]
            + [cfg["image_token_id"]] * n_vis + [cfg["vision_end_token_id"]]
            + tok.encode(CHAT_POST.format(question=question), add_special_tokens=False))


def answer_ids(tok: WordTokenizer) -> list[int]:
    return tok.encode(ANSWER, add_special_tokens=False)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


@torch.no_grad()
def _vision(cfg: dict, w: Weights, image: np.ndarray):
    """One image -> (merged features (S/4, D), [deepstack level (S/4, D)])."""
    v = cfg["vision"]
    p, m, tp, hid = v["patch_size"], v["merge_size"], v["temporal_patch_size"], v["hidden"]
    gh, gw = grid_of(cfg, image.shape[0], image.shape[1])
    x = torch.from_numpy(np.ascontiguousarray(image)).to(w.device)
    x = pillow.resize(x, gh * p, gw * p).float() / 255.0
    x = ((x - torch.tensor(cfg["image_mean"], device=w.device))
         / torch.tensor(cfg["image_std"], device=w.device))
    # rows in 2x2-group order (bh, bw, mh, mw), features (c, t, ph, pw)
    x = x.permute(2, 0, 1).reshape(3, gh // m, m, p, gw // m, m, p)
    x = x.permute(1, 4, 2, 5, 0, 3, 6)[..., None, :, :]
    x = x.expand(*x.shape[:5], tp, p, p).reshape(gh * gw, 3 * tp * p * p)
    x = w.mm(x, w("vision.patch_w", 3 * tp * p * p, hid)) + w("vision.patch_b", hid)

    # positions of the rows: (h, w) in the same group order
    hh = (torch.arange(gh // m)[:, None, None, None] * m + torch.arange(m)[None, None, :, None])
    ww = (torch.arange(gw // m)[None, :, None, None] * m + torch.arange(m)[None, None, None, :])
    hh = hh.expand(gh // m, gw // m, m, m).reshape(-1).to(w.device)
    ww = ww.expand(gh // m, gw // m, m, m).reshape(-1).to(w.device)

    # the position table, bilinear at linspace(0, side - 1, grid) (HF)
    side = int(round(v["num_position_embeddings"] ** 0.5))
    table = w("vision.pos_emb", v["num_position_embeddings"], hid).view(side, side, hid)
    fh = torch.linspace(0, side - 1, gh, dtype=torch.float64, device=w.device)[hh]
    fw = torch.linspace(0, side - 1, gw, dtype=torch.float64, device=w.device)[ww]
    h0, w0 = fh.floor().long(), fw.floor().long()
    h1, w1 = (h0 + 1).clamp(max=side - 1), (w0 + 1).clamp(max=side - 1)
    dh, dw = (fh - h0)[:, None].float(), (fw - w0)[:, None].float()
    x = x + ((1 - dh) * (1 - dw) * table[h0, w0] + (1 - dh) * dw * table[h0, w1]
             + dh * (1 - dw) * table[h1, w0] + dh * dw * table[h1, w1])

    heads = v["heads"]
    hd = hid // heads
    half = hd // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float32, device=w.device)
                             / half))
    ang = torch.cat([hh[:, None].float() * inv, ww[:, None].float() * inv], -1)
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()

    def merge(y, path, postshuffle):
        width = hid * m * m
        if postshuffle:
            y = layer_norm(y.reshape(-1, width), w, path + ".norm", width, v["ln_eps"])
        else:
            y = layer_norm(y, w, path + ".norm", hid, v["ln_eps"]).reshape(-1, width)
        y = F.gelu(w.linear(y, path + ".fc1", width, width, True))
        return w.linear(y, path + ".fc2", width, v["out_hidden"], True)

    deepstack = []
    s = x.shape[0]
    for i in range(v["depth"]):
        b = f"vision.blocks.{i}"
        h = layer_norm(x, w, b + ".ln1", hid, v["ln_eps"])
        q, k, val = w.linear(h, b + ".qkv", hid, 3 * hid, True).split(hid, -1)
        q = rotate_half(q.view(s, heads, hd), cos, sin).reshape(1, s, hid)
        k = rotate_half(k.view(s, heads, hd), cos, sin).reshape(1, s, hid)
        a = attend(q, k, val[None], heads, scale=hd ** -0.5, quant=w.quant)[0]
        x = x + w.linear(a, b + ".o", hid, hid, True)
        h = layer_norm(x, w, b + ".ln2", hid, v["ln_eps"])
        h = _gelu_tanh(w.linear(h, b + ".fc1", hid, v["d_ff"], True))
        x = x + w.linear(h, b + ".fc2", v["d_ff"], hid, True)
        if i in v["deepstack_indexes"]:
            d = v["deepstack_indexes"].index(i)
            deepstack.append(merge(x, f"vision.deepstack.{d}", True))
    return merge(x, "vision.merger", False), deepstack


def _mrope(cfg: dict, pos: torch.Tensor):
    """(3, S) t/h/w positions -> cos, sin (S, head_dim): the T stream's
    frequencies with the H stream's at 1, 4, 7, ... and the W stream's at
    2, 5, 8, ... (below 3 x its section), as Qwen3-VL interleaves them."""
    t = cfg["text"]
    half = t["head_dim"] // 2
    inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, half, dtype=torch.float32,
                                                  device=pos.device) / half))
    freqs = pos.float()[..., None] * inv                      # (3, S, half)
    out = freqs[0].clone()
    for stream in (1, 2):
        idx = torch.arange(stream, min(t["mrope_section"][stream] * 3, half), 3,
                           device=pos.device)
        out[:, idx] = freqs[stream][:, idx]
    emb = torch.cat([out, out], -1)
    return emb.cos(), emb.sin()


def _positions(cfg: dict, ids: list[int], grid: tuple[int, int]) -> torch.Tensor:
    """(3, S) M-RoPE positions: text counts up on all three streams; an
    image's tokens hold (start, start + row, start + column) over its merged
    grid, and the text after it starts past their largest."""
    m = cfg["vision"]["merge_size"]
    out, st, j = np.zeros((3, len(ids)), np.int64), 0, 0
    while j < len(ids):
        if ids[j] == cfg["image_token_id"]:
            lh, lw = grid[0] // m, grid[1] // m
            n = lh * lw
            out[0, j:j + n] = st
            out[1, j:j + n] = st + np.repeat(np.arange(lh), lw)
            out[2, j:j + n] = st + np.tile(np.arange(lw), lh)
            st = out[:, j:j + n].max() + 1
            j += n
        else:
            out[:, j] = st
            st += 1
            j += 1
    return torch.from_numpy(out)


@torch.no_grad()
def _decoder(cfg: dict, w: Weights, seqs: list[dict]) -> torch.Tensor:
    """Mean answer log-probability of each sequence: ``ids`` (prompt and
    answer), ``pos`` (3, S), ``vis`` (main features), ``ds`` (deepstack
    levels), ``n`` the prompt's length, ``ans`` the answer's ids."""
    t = cfg["text"]
    d, hd, heads, kvh = t["d_model"], t["head_dim"], t["heads"], t["kv_heads"]
    eps, e, k, ff = t["rms_eps"], t["num_experts"], t["experts_per_tok"], t["moe_d_ff"]
    dev = w.device
    lens = [len(sq["ids"]) for sq in seqs]
    s_max, b = max(lens), len(seqs)
    embed = w("decoder.embed", t["vocab_size"], d)
    x = torch.zeros((b, s_max, d), device=dev)
    vis_mask = torch.zeros((b, s_max), dtype=torch.bool, device=dev)
    cos = torch.zeros((b, s_max, hd), device=dev)
    sin = torch.zeros((b, s_max, hd), device=dev)
    for j, sq in enumerate(seqs):
        ids = torch.tensor(sq["ids"], device=dev)
        x[j, :len(ids)] = embed[ids]
        vm = ids == cfg["image_token_id"]
        x[j, :len(ids)][vm] = sq["vis"]
        vis_mask[j, :len(ids)] = vm
        c, s_ = _mrope(cfg, sq["pos"].to(dev))
        cos[j, :len(ids)], sin[j, :len(ids)] = c, s_
    del embed
    key_mask = torch.arange(s_max, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    qkv_out = (heads + 2 * kvh) * hd
    for i in range(t["layers"]):
        p = f"decoder.blocks.{i}"
        h = rms_norm(x, w(p + ".ln1.scale", d), eps)
        qkv = w.linear(h, p + ".qkv", d, qkv_out)
        q = qkv[..., :heads * hd].reshape(b, s_max, heads, hd)
        kk = qkv[..., heads * hd:(heads + kvh) * hd].reshape(b, s_max, kvh, hd)
        v = qkv[..., (heads + kvh) * hd:]
        q = rotate_half(rms_norm(q, w(p + ".q_norm.scale", hd), eps), cos, sin)
        kk = rotate_half(rms_norm(kk, w(p + ".k_norm.scale", hd), eps), cos, sin)
        a = attend(q.reshape(b, s_max, -1), kk.reshape(b, s_max, -1), v, heads, kvh,
                   key_mask=key_mask, causal=True, scale=hd ** -0.5, quant=w.quant)
        x = x + w.linear(a, p + ".o", heads * hd, d)
        h = rms_norm(x, w(p + ".ln2.scale", d), eps).reshape(-1, d)
        probs = torch.softmax(w.mm(h, w(p + ".moe.router.w", d, e)), -1)
        topv, topi = torch.topk(probs, k, -1)
        topv = topv / topv.sum(-1, keepdim=True)
        gate_up = w(p + ".moe.gate_up", e, d, 2 * ff)
        down = w(p + ".moe.down", e, ff, d)
        out = torch.zeros_like(h)
        for ex in topi.unique().tolist():
            rows, slot = (topi == ex).nonzero(as_tuple=True)
            g, u = w.mm(h[rows], gate_up[ex]).chunk(2, -1)
            out.index_add_(0, rows, w.mm(F.silu(g) * u, down[ex]) * topv[rows, slot, None])
        del gate_up, down
        x = x + out.view(b, s_max, d)
        if i < len(seqs[0]["ds"]):
            for j, sq in enumerate(seqs):
                x[j][vis_mask[j]] += sq["ds"][i]
    x = rms_norm(x, w("decoder.ln_final.scale", d), eps)
    lm_head = w("decoder.lm_head", d, t["vocab_size"])
    out = []
    for j, sq in enumerate(seqs):
        n, ans = sq["n"], sq["ans"]
        rows = x[j, n - 1:n - 1 + len(ans)]
        logp = torch.log_softmax(w.mm(rows, lm_head), -1)
        out.append(logp[torch.arange(len(ans)), torch.tensor(ans, device=dev)].mean())
    return torch.stack(out)


def log_scores(cfg: dict, seed: int, media: list, prompts: list[str],
               pairs: list[tuple[int, int]], device, quant: str | None = None) -> np.ndarray:
    """log VQAScore of each (media index, prompt index) pair: ``media`` the
    raw uint8 (H, W, 3) images, ``prompts`` the texts."""
    with no_tf32():
        w = Weights(leaf_rule(cfg), seed, device, getattr(torch, cfg["dtype"]), quant)
        tok = WordTokenizer(cfg["tokenizer_vocab"])
        feats = {}
        for mi in sorted({mi for mi, _ in pairs}):
            feats[mi] = _vision(cfg, w, media[mi])
        seqs = []
        m = cfg["vision"]["merge_size"]
        ans = answer_ids(tok)
        for mi, pi in pairs:
            gh, gw = grid_of(cfg, media[mi].shape[0], media[mi].shape[1])
            ids = prompt_ids(cfg, tok, prompts[pi], gh * gw // (m * m))
            n = len(ids)
            pos = _positions(cfg, ids, (gh, gw))
            tail = pos[:, -1].max() + 1 + torch.arange(len(ans))
            seqs.append({"ids": ids + ans, "n": n, "ans": ans,
                         "pos": torch.cat([pos, tail.expand(3, -1)], 1),
                         "vis": feats[mi][0], "ds": feats[mi][1]})
        return _decoder(cfg, w, seqs).double().cpu().numpy()
