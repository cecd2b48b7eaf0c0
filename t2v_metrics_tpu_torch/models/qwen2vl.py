"""Qwen2.5-VL in PyTorch (port of t2v_metrics_tpu/models/qwen2vl.py, images).

  * vision: the (C*2*14*14)-wide patch embedding as a matmul, 2-D rotary
    embeddings, window attention (8x8 merged-patch windows) with full
    attention at ``fullatt_block_indexes``, RMSNorm + SwiGLU (with biases)
    blocks, and the 2x2 patch-merger MLP to the decoder width. The window
    layout, rotary ids and segment ids depend only on the patch grid and are
    built on the host in numpy (``vision_geometry``, copied from the JAX
    module, which imports jax at its top);
  * decoder: ``models/decoder.py`` with the M-RoPE t/h/w position streams
    of ``build_rope_index`` (HF get_rope_index semantics);
  * scoring: teacher-forced mean log P(answer tokens), fp32 log-softmax of
    logits divided by the temperature.

The windowed layers take one of two layouts, chosen by the adapter
(``qwen2vl_adapter._padded_geometry``): bin-packed 128-row window tiles (the
tower reshapes to (B*NT, 128, L) and attends inside each tile under window
segment ids), or, when the tiles overflow the patch bucket, the whole
(B, S, L) sequence under window segment ids. Both run the flat attention
kernel with segment ids on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from t2v_metrics_tpu.constants import CLIP_MEAN, CLIP_STD

from ..ops import image as timage
from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.rope import rope_pack
from . import decoder as dec
from .clip import Norm, init_norm_, normal_


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    hidden: int = 1280
    depth: int = 32
    heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    d_ff: int = 3420
    out_hidden: int = 3584
    rms_eps: float = 1e-6
    tokens_per_second: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.merge_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vision: QwenVisionConfig
    text: dec.DecoderConfig
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


QWEN2_VL_MODELS = {
    "qwen2.5-vl-3b": {
        "hf": "Qwen/Qwen2.5-VL-3B-Instruct", "fps": 8.0,
        "config": Qwen2VLConfig(
            vision=QwenVisionConfig(out_hidden=2048),
            text=dec.DecoderConfig(vocab_size=151936, d_model=2048, layers=36,
                                   heads=16, kv_heads=2, head_dim=128,
                                   d_ff=11008, tie_embeddings=True)),
    },
    "qwen2.5-vl-7b": {
        "hf": "Qwen/Qwen2.5-VL-7B-Instruct", "fps": 8.0,
        "config": Qwen2VLConfig(
            vision=QwenVisionConfig(out_hidden=3584),
            text=dec.DecoderConfig(vocab_size=152064, d_model=3584, layers=28,
                                   heads=28, kv_heads=4, head_dim=128,
                                   d_ff=18944)),
    },
    "qwen2.5-vl-32b": {
        "hf": "Qwen/Qwen2.5-VL-32B-Instruct", "fps": 8.0,
        "config": Qwen2VLConfig(
            vision=QwenVisionConfig(out_hidden=5120),
            text=dec.DecoderConfig(vocab_size=152064, d_model=5120, layers=64,
                                   heads=40, kv_heads=8, head_dim=128,
                                   d_ff=27648)),
    },
    "qwen2.5-vl-72b": {
        "hf": "Qwen/Qwen2.5-VL-72B-Instruct", "fps": 8.0,
        "config": Qwen2VLConfig(
            vision=QwenVisionConfig(out_hidden=8192),
            text=dec.DecoderConfig(vocab_size=152064, d_model=8192, layers=80,
                                   heads=64, kv_heads=8, head_dim=128,
                                   d_ff=29568)),
    },
    # tiny test config (random weights, SimpleT5Tokenizer)
    "qwen2.5-vl-test": {
        "hf": None, "fps": 8.0,
        "config": Qwen2VLConfig(
            vision=QwenVisionConfig(hidden=32, depth=4, heads=4, patch_size=4,
                                    window_size=16, fullatt_block_indexes=(1, 3),
                                    d_ff=64, out_hidden=48),
            text=dec.DecoderConfig(vocab_size=512, d_model=48, layers=2,
                                   heads=4, kv_heads=2, head_dim=12, d_ff=96),
            image_token_id=501, video_token_id=502, vision_start_token_id=503,
            vision_end_token_id=504),
    },
}


# ---------------------------------------------------------------------------
# Host-side geometry (depends only on grid_thw -> plain numpy)
# ---------------------------------------------------------------------------

def frames_to_patches(frames_nchw: np.ndarray, cfg: QwenVisionConfig):
    """(T, C, H, W) normalized frames -> flattened patch rows + grid_thw, in
    (t, h/m, w/m, m, m, C, T, ph, pw) order; T is repeated up to a multiple
    of the temporal patch (an image is tiled x2)."""
    p, m, tp = cfg.patch_size, cfg.merge_size, cfg.temporal_patch_size
    t, c, h, w = frames_nchw.shape
    if t % tp:
        reps = np.repeat(frames_nchw[-1:], tp - t % tp, axis=0)
        frames_nchw = np.concatenate([frames_nchw, reps], axis=0)
        t = frames_nchw.shape[0]
    grid_t, grid_h, grid_w = t // tp, h // p, w // p
    x = frames_nchw.reshape(grid_t, tp, c, grid_h // m, m, p, grid_w // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(grid_t * grid_h * grid_w, c * tp * p * p)
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)


def vision_geometry(grid_thw: tuple, cfg: QwenVisionConfig):
    """Window permutation + rotary position ids + segment ids for one image.

    Returns a dict of numpy arrays, all in *window order* (the order the
    device sequence runs in):
      perm: (S,) row permutation applied to the flattened patches
      reverse: (S/4,) permutation restoring merged-token order
      pos_hw: (S, 2) h/w rotary position ids
      win_seg: (S,) window segment id per patch
      win_gather / win_tseg / win_scatter, win_tr: the bin-packed tile layout
        (window-order row -> tile slot, per-slot window ids with -1 on pad
        slots, tile slot of each row, rows per tile)
    HF get_window_index/rot_pos_emb semantics (modeling_qwen2_5_vl.py).
    """
    t, h, w = grid_thw
    m = cfg.merge_size
    llm_h, llm_w = h // m, w // m
    ws = cfg.window_size // m // cfg.patch_size  # merged patches per window

    # rotary ids in original (pre-window) patch order, merge-grouped
    hh = np.arange(h).reshape(h // m, m, 1, 1)
    hh = np.broadcast_to(hh, (h // m, m, w // m, m)).transpose(0, 2, 1, 3).reshape(-1)
    wwv = np.arange(w).reshape(1, 1, w // m, m)
    wwv = np.broadcast_to(wwv, (h // m, m, w // m, m)).transpose(0, 2, 1, 3).reshape(-1)
    pos_hw = np.tile(np.stack([hh, wwv], axis=-1), (t, 1))   # (S, 2)

    # window index over merged tokens; HF pads a whole extra window when the
    # grid is already divisible (harmless -100 rows)
    idx = np.arange(t * llm_h * llm_w).reshape(t, llm_h, llm_w)
    pad_h = ws - llm_h % ws
    pad_w = ws - llm_w % ws
    idxp = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
    nwh, nww = (llm_h + pad_h) // ws, (llm_w + pad_w) // ws
    idxp = idxp.reshape(t, nwh, ws, nww, ws).transpose(0, 1, 3, 2, 4)
    idxp = idxp.reshape(t, nwh * nww, ws, ws)
    seqlens = (idxp != -100).sum(axis=(2, 3)).reshape(-1)  # merged tokens/window
    flat = idxp.reshape(-1)
    window_index = flat[flat != -100]                      # merged-token perm

    # expand the merged-token permutation to patch rows (merge_unit groups)
    mu = cfg.merge_unit
    perm = (window_index[:, None] * mu + np.arange(mu)[None, :]).reshape(-1)
    win_seg = np.repeat(np.arange(len(seqlens)), seqlens * mu)

    # windows bin-packed first-fit-decreasing into uniform 128-row tiles
    counts = (seqlens * mu).astype(np.int64)           # patches per window
    cap = ws * ws * mu                                 # window capacity
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    S = int(counts.sum())
    TR = 128 if cap <= 128 else -(-cap // 128) * 128   # tile rows
    order = np.argsort(-counts, kind="stable")
    tile_of = np.zeros(len(counts), np.int64)
    slot_of = np.zeros(len(counts), np.int64)          # start slot in tile
    remaining: list = []
    for win in order:
        c = int(counts[win])
        for ti in range(len(remaining)):
            if remaining[ti] >= c:
                break
        else:
            remaining.append(TR)
            ti = len(remaining) - 1
        tile_of[win] = ti
        slot_of[win] = TR - remaining[ti]
        remaining[ti] -= c
    nt = len(remaining)
    win_gather = np.zeros(nt * TR, np.int64)           # pad -> row 0
    win_tseg = np.full(nt * TR, -1, np.int64)          # pad -> no segment
    win_scatter = np.zeros(S, np.int64)
    for win in range(len(counts)):
        c = int(counts[win])
        dst = tile_of[win] * TR + slot_of[win] + np.arange(c)
        win_gather[dst] = starts[win] + np.arange(c)
        win_tseg[dst] = win
        win_scatter[starts[win]:starts[win] + c] = dst

    reverse = np.argsort(window_index)
    return {
        "perm": perm.astype(np.int32),
        "reverse": reverse.astype(np.int32),
        "pos_hw": pos_hw[perm].astype(np.int32),
        "win_seg": win_seg.astype(np.int32),
        "win_gather": win_gather.astype(np.int32),
        "win_tseg": win_tseg.astype(np.int32),
        "win_scatter": win_scatter.astype(np.int32),
        "win_tr": TR,
    }


def build_rope_index(input_ids: np.ndarray, grids: list, cfg: Qwen2VLConfig,
                     second_per_grid_ts: list | None = None) -> np.ndarray:
    """(S,) token ids -> (3, S) t/h/w position ids (HF get_rope_index
    semantics). ``grids`` lists (t, h, w) per vision block in order."""
    m = cfg.vision.merge_size
    ids = input_ids.tolist()
    st_idx = 0
    out = np.zeros((3, len(ids)), dtype=np.int64)
    j = 0
    gidx = 0
    while j < len(ids):
        if ids[j] in (cfg.image_token_id, cfg.video_token_id):
            t, h, w = grids[gidx]
            spgt = (second_per_grid_ts[gidx]
                    if second_per_grid_ts else (0 if ids[j] == cfg.image_token_id else 1.0))
            llm_h, llm_w = h // m, w // m
            n = t * llm_h * llm_w
            t_idx = (np.arange(t).repeat(llm_h * llm_w)
                     * float(spgt) * cfg.vision.tokens_per_second).astype(np.int64)
            h_idx = np.tile(np.arange(llm_h).repeat(llm_w), t)
            w_idx = np.tile(np.tile(np.arange(llm_w), llm_h), t)
            out[0, j:j + n] = t_idx + st_idx
            out[1, j:j + n] = h_idx + st_idx
            out[2, j:j + n] = w_idx + st_idx
            st_idx = out[:, j:j + n].max() + 1
            j += n
            gidx += 1
        else:
            out[:, j] = st_idx
            st_idx += 1
            j += 1
    return out


# ---------------------------------------------------------------------------
# Device: image preprocessing
# ---------------------------------------------------------------------------

def image_patches(pixels_u8: torch.Tensor, cfg: QwenVisionConfig,
                  out_h: int, out_w: int) -> torch.Tensor:
    """(n, H0, W0*3) uint8 images on the device -> (n, S, patch_dim) fp32
    patch rows in ``frames_to_patches`` order, S = (out_h/p)*(out_w/p).

    Bicubic resize to the smart-resize size (two matmuls, each pass rounded
    to uint8 levels as Pillow's uint8 resize does), /255, CLIP normalize,
    temporal tile x2, patchify.
    """
    p, m, tp = cfg.patch_size, cfg.merge_size, cfg.temporal_patch_size
    x = timage.resize_uint8_levels_flat(pixels_u8.float(), out_h, out_w, 3)
    x = timage.normalize_flat(x / 255.0, CLIP_MEAN, CLIP_STD)
    n = x.shape[0]
    gh, gw = out_h // p, out_w // p
    x = x.reshape(n, 1, out_h, out_w, 3).permute(0, 1, 4, 2, 3)
    x = x.expand(n, tp, 3, out_h, out_w)               # an image is tiled in T
    x = x.reshape(n, 1, tp, 3, gh // m, m, p, gw // m, m, p)
    x = x.permute(0, 1, 4, 7, 5, 8, 3, 2, 6, 9)
    return x.reshape(n, gh * gw, 3 * tp * p * p)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device, dtype):
        super().__init__()
        d = cfg.hidden
        self.ln1 = Norm(d, False, device, dtype)
        self.qkv = Q.Linear.empty(d, 3 * d, True, device, dtype)
        self.o = Q.Linear.empty(d, d, True, device, dtype)
        self.ln2 = Norm(d, False, device, dtype)
        self.gate = Q.Linear.empty(d, cfg.d_ff, True, device, dtype)
        self.up = Q.Linear.empty(d, cfg.d_ff, True, device, dtype)
        self.down = Q.Linear.empty(cfg.d_ff, d, True, device, dtype)


class Merger(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device, dtype):
        super().__init__()
        merge_in = cfg.hidden * cfg.merge_unit
        self.ln_q = Norm(cfg.hidden, False, device, dtype)
        self.fc1 = Q.Linear.empty(merge_in, merge_in, True, device, dtype)
        self.fc2 = Q.Linear.empty(merge_in, cfg.out_hidden, True, device, dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device, dtype):
        super().__init__()
        self.patch_w = nn.Parameter(
            torch.empty((cfg.patch_dim, cfg.hidden), device=device, dtype=dtype),
            requires_grad=False)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype)
                                    for _ in range(cfg.depth))
        self.merger = Merger(cfg, device, dtype)


class Qwen2VLModel(nn.Module):
    """Parameters of the whole scorer: ``vision`` and ``decoder``."""

    def __init__(self, cfg: Qwen2VLConfig, device, dtype):
        super().__init__()
        self.vision = VisionTower(cfg.vision, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_qwen2vl(cfg: Qwen2VLConfig, seed: int, device,
                 dtype=torch.float32) -> Qwen2VLModel:
    """Random parameters made directly on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_qwen2vl's
    distributions (the numbers differ from the JAX package's): linears
    N(0, 1/d_in), zero biases, ones for norms, N(0, 0.02^2) for the
    embedding and the lm head."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Qwen2VLModel(cfg, device, dtype)
    v = model.vision
    normal_(v.patch_w, v.patch_w.shape[0] ** -0.5, gen)
    for blk in v.blocks:
        init_norm_(blk.ln1)
        init_norm_(blk.ln2)
        for leaf in (blk.qkv, blk.o, blk.gate, blk.up, blk.down):
            normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
            leaf.b.zero_()
    init_norm_(v.merger.ln_q)
    for leaf in (v.merger.fc1, v.merger.fc2):
        normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    dec.init_decoder(model.decoder, gen)
    return model


# ---------------------------------------------------------------------------
# Device: vision tower
# ---------------------------------------------------------------------------

def _vision_rope(cfg: QwenVisionConfig, pos_hw: torch.Tensor):
    """(B, S, 2) h/w ids -> f32 cos/sin (B, S, head_dim): theta 10000 over
    arange(0, d/2, 2) / (d/2) for the h and w streams side by side."""
    half = cfg.head_dim // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float32,
                                          device=pos_hw.device) / half))
    freqs = pos_hw.float()[..., None] * inv            # (B, S, 2, half/2)
    freqs = freqs.reshape(*pos_hw.shape[:2], -1)       # (B, S, half)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def vision_tower_batch(params: VisionTower, cfg: QwenVisionConfig,
                       patches: torch.Tensor,   # (B, S, patch_dim)
                       pos_hw: torch.Tensor,    # (B, S, 2) int
                       win_seg: torch.Tensor,   # (B, S) window segs, -1 = pad
                       full_seg: torch.Tensor,  # (B, S) image segs, -1 = pad
                       reverse: torch.Tensor,   # (B, S/mu) un-permutation
                       tiled: bool = False) -> torch.Tensor:
    """B same-shape visuals through one call -> (B, S/merge_unit,
    out_hidden) merged features in original order.

    ``tiled=True`` declares that the caller laid the rows out as bin-packed
    128-row window tiles (every window contiguous inside one tile, pads
    under segment -1): the windowed layers then attend inside each tile, a
    pure reshape to (B*NT, 128, L). Otherwise they attend over the whole
    sequence under window segment ids. Full-attention layers and every
    row-wise op are permutation-invariant, so the tile order is exact.
    """
    x = patches.to(params.patch_w.dtype) @ params.patch_w   # (B, S, hidden)
    cos, sin = _vision_rope(cfg, pos_hw)
    b, s, _ = x.shape
    d = cfg.head_dim
    for i, blk in enumerate(params.blocks):
        full = i in cfg.fullatt_block_indexes
        seg = full_seg if full else win_seg
        h = L.rms_norm(x, blk.ln1.scale, cfg.rms_eps)
        pk = rope_pack(Q.linear(h, blk.qkv), cos, sin, 2 * cfg.heads, d)
        if not full and tiled:
            nt = s // 128
            a = attention_flat_packed(pk.reshape(b * nt, 128, pk.shape[-1]),
                                      cfg.heads,
                                      segment_ids=seg.reshape(b * nt, 128))
            a = a.reshape(b, s, -1)
        else:
            a = attention_flat_packed(pk, cfg.heads, segment_ids=seg)
        x = x + Q.linear(a, blk.o)
        h = L.rms_norm(x, blk.ln2.scale, cfg.rms_eps)
        h = L.ACT_FNS["silu"](Q.linear(h, blk.gate)) * Q.linear(h, blk.up)
        x = x + Q.linear(h, blk.down)

    mg = params.merger
    x = L.rms_norm(x, mg.ln_q.scale, cfg.rms_eps)
    mu = cfg.merge_unit
    x = x.reshape(b, s // mu, mu * cfg.hidden)
    x = Q.linear(L.ACT_FNS["gelu"](Q.linear(x, mg.fc1)), mg.fc2)
    rev = reverse.long().clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, rev[..., None].expand(-1, -1, x.shape[-1]))


def splice_and_score(params: Qwen2VLModel, cfg: Qwen2VLConfig,
                     ids: torch.Tensor,          # (B, S)
                     vis_feats: torch.Tensor,    # (B, T, D) per-seq vision feats
                     vis_mask: torch.Tensor,     # (B, S) position is vision
                     vis_slot: torch.Tensor,     # (B, S) index into vis_feats
                     position_ids: torch.Tensor,  # (3, B, S)
                     attn_mask: torch.Tensor,    # (B, S)
                     ans_ids: torch.Tensor,      # (B, A)
                     ans_pos: torch.Tensor,      # (B, A) logit positions
                     ans_mask: torch.Tensor,     # (B, A)
                     temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced mean log-prob of the answer tokens per sequence.
    ans_pos[b, i] is the row whose logits predict answer token i."""
    dp = params.decoder
    tok = dp.embed[ids]
    slot = vis_slot.long().clamp(0, vis_feats.shape[1] - 1)
    vis = torch.gather(vis_feats, 1, slot[..., None].expand(-1, -1, vis_feats.shape[-1]))
    embeds = torch.where(vis_mask[..., None], vis.to(tok.dtype), tok)
    logits = dec.forward(dp, cfg.text, embeds, position_ids, attn_mask,
                         logit_positions=ans_pos)     # (B, A, V) fp32
    logp = L.log_softmax_fp32(logits / temperature)
    ans = ans_ids.long().clamp(0, logp.shape[-1] - 1)
    tok_logp = torch.gather(logp, -1, ans[..., None])[..., 0] * ans_mask
    return tok_logp.sum(-1) / ans_mask.sum(-1).clamp(min=1)
