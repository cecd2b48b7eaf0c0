"""Qwen3-VL in PyTorch (port of t2v_metrics_tpu/models/qwen3vl.py, images).

  * vision: the (C*2*16*16)-wide patch embedding (with bias) as a matmul,
    learned position embeddings bilinearly interpolated from a 48x48 table
    (blended in f32, rounded once), 2-D rotary embeddings at head dim 72,
    full attention per image (no windows) through the flat attention kernel
    with segment ids, LayerNorm blocks with a GELU-tanh MLP, the pre-shuffle
    patch merger, and the post-shuffle "deepstack" mergers that tap layers
    ``deepstack_indexes``. A batch of same-shape images goes through one
    call; the host geometry (``pos_embed_interp``, ``vision_geometry``)
    depends only on the patch grid and is copied from the JAX module, which
    imports jax at its top;
  * decoder: ``models/decoder.py`` with qk-norm, interleaved M-RoPE and, for
    the MoE variants, the routed experts (``ops/moe.py``); the deepstack
    features are added to the hidden state after the first decoder layers;
  * scoring: teacher-forced mean log P(answer tokens), as Qwen2.5-VL.

Pixels are normalised with the published processor's mean and std, 0.5 and
0.5 (``QWEN3_VL_MEAN`` / ``QWEN3_VL_STD``, set by ``resolve_config``); the
JAX package normalises Qwen3-VL with CLIP's, which this port does not copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..constants import CLIP_MEAN, CLIP_STD
from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.rope import rope_pack
from . import decoder as dec
from . import qwen2vl as q2
from ..parallel.mesh import build_sharded, gather_cols
from .clip import Norm, fan_in, init_norm_, normal_


@dataclasses.dataclass(frozen=True)
class Qwen3VisionConfig:
    hidden: int = 1152
    depth: int = 27
    heads: int = 16
    patch_size: int = 16
    temporal_patch_size: int = 2
    merge_size: int = 2
    d_ff: int = 4304
    out_hidden: int = 3584
    num_position_embeddings: int = 2304
    deepstack_indexes: tuple = (8, 16, 24)
    act: str = "gelu_pytorch_tanh"
    ln_eps: float = 1e-6
    # qwen3 videos use raw frame indices in the rope index (timestamps are
    # text): tokens_per_second=1 in the qwen2-style rope index
    tokens_per_second: int = 1
    # the pixel normalisation: CLIP's by default, which Qwen3-Omni keeps
    # until its published processor's is checked; ``resolve_config`` gives
    # every Qwen3-VL model ``QWEN3_VL_MEAN`` / ``QWEN3_VL_STD``
    image_mean: tuple = CLIP_MEAN
    image_std: tuple = CLIP_STD

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.merge_size ** 2

    @property
    def grid_side(self) -> int:
        return int(self.num_position_embeddings ** 0.5)


@dataclasses.dataclass(frozen=True)
class Qwen3VLConfig:
    vision: Qwen3VisionConfig
    text: dec.DecoderConfig
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


# Qwen3-VL's preprocessor_config.json (and transformers 4.57's
# Qwen3VLVideoProcessor defaults): its SigLIP2-shaped tower takes pixels in [-1, 1]
QWEN3_VL_MEAN = QWEN3_VL_STD = (0.5, 0.5, 0.5)


def _q3_vision(**kw) -> Qwen3VisionConfig:
    return Qwen3VisionConfig(image_mean=QWEN3_VL_MEAN, image_std=QWEN3_VL_STD, **kw)


def _q3_text(d_model, layers, heads, kv_heads, d_ff, vocab=151936,
             head_dim=128, rope_theta=5_000_000.0):
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=head_dim, d_ff=d_ff, rope_theta=rope_theta,
        mrope_section=(24, 20, 20), mrope_interleaved=True, qkv_bias=False,
        qk_norm=True)


# The JAX package's registry, name for name (reference qwen3vl_model.py:
# 9-146): dense "dims" (d_model, layers, heads, kv_heads, d_ff) and MoE
# "moe_dims" (d_model, layers, heads, kv_heads, experts, top-k, moe_d_ff).
QWEN3_VL_MODELS = {
    "qwen3-vl-2b": {"hf": "Qwen/Qwen3-VL-2B-Instruct", "fps": 8.0,
                    "config": None, "dims": (2048, 28, 16, 8, 6144)},
    "qwen3-vl-4b": {"hf": "Qwen/Qwen3-VL-4B-Instruct", "fps": 8.0,
                    "config": None, "dims": (2560, 36, 32, 8, 9728)},
    "qwen3-vl-8b": {"hf": "Qwen/Qwen3-VL-8B-Instruct", "fps": 8.0,
                    "config": None, "dims": (4096, 36, 32, 8, 12288)},
    "qwen3-vl-32b": {"hf": "Qwen/Qwen3-VL-32B-Instruct", "fps": 8.0,
                     "config": None, "dims": (5120, 64, 64, 8, 25600)},
    "qwen3-vl-30b-a3b": {"hf": "Qwen/Qwen3-VL-30B-A3B-Instruct", "fps": 8.0,
                         "config": None,
                         "moe_dims": (2048, 48, 32, 4, 128, 8, 768)},
    "qwen3-vl-235b-a22b": {"hf": "Qwen/Qwen3-VL-235B-A22B-Instruct", "fps": 8.0,
                           "config": None,
                           "moe_dims": (4096, 94, 64, 4, 128, 8, 1536)},
    # Qwen3.5: Qwen3-VL dense structure, the chat template closes an empty
    # thinking block (enable_thinking=False); dims provisional in the JAX
    # package too
    "qwen3.5-4b": {"hf": "Qwen/Qwen3.5-4B", "fps": 8.0, "config": None,
                   "dims": (2560, 36, 32, 8, 9728), "enable_thinking": False},
    "qwen3.5-9b": {"hf": "Qwen/Qwen3.5-9B", "fps": 8.0, "config": None,
                   "dims": (4096, 40, 32, 8, 12288), "enable_thinking": False},
    "qwen3.5-27b": {"hf": "Qwen/Qwen3.5-27B", "fps": 8.0, "config": None,
                    "dims": (5120, 64, 64, 8, 25600),
                    "enable_thinking": False},
    "qwen3-vl-test": {"hf": None, "fps": 8.0, "config": "test", "dims": None},
    "qwen3-vl-moe-test": {"hf": None, "fps": 8.0, "config": "moe-test",
                          "dims": None},
}

# -thinking variants: the same architecture, other checkpoints
for _base, _hf in [("qwen3-vl-2b", "Qwen/Qwen3-VL-2B-Thinking"),
                   ("qwen3-vl-4b", "Qwen/Qwen3-VL-4B-Thinking"),
                   ("qwen3-vl-8b", "Qwen/Qwen3-VL-8B-Thinking"),
                   ("qwen3-vl-32b", "Qwen/Qwen3-VL-32B-Thinking"),
                   ("qwen3-vl-30b-a3b", "Qwen/Qwen3-VL-30B-A3B-Thinking"),
                   ("qwen3-vl-235b-a22b", "Qwen/Qwen3-VL-235B-A22B-Thinking")]:
    QWEN3_VL_MODELS[f"{_base}-thinking"] = dict(QWEN3_VL_MODELS[_base], hf=_hf)


def resolve_config(name: str) -> Qwen3VLConfig:
    spec = QWEN3_VL_MODELS[name]
    if spec["config"] == "moe-test":
        base = resolve_config("qwen3-vl-test")
        return dataclasses.replace(
            base, text=dataclasses.replace(base.text, num_experts=4,
                                           experts_per_tok=2, moe_d_ff=32))
    if spec.get("moe_dims"):
        d_model, layers, heads, kv, n_exp, topk, moe_ff = spec["moe_dims"]
        return Qwen3VLConfig(
            vision=_q3_vision(out_hidden=d_model),
            text=dataclasses.replace(
                _q3_text(d_model, layers, heads, kv, d_ff=0),
                num_experts=n_exp, experts_per_tok=topk, moe_d_ff=moe_ff,
                moe_dispatch=True))
    if spec["config"] == "test":
        return Qwen3VLConfig(
            vision=_q3_vision(hidden=32, depth=3, heads=4, patch_size=4,
                              d_ff=64, out_hidden=48, num_position_embeddings=16,
                              deepstack_indexes=(0, 1)),
            text=dec.DecoderConfig(
                vocab_size=512, d_model=48, layers=3, heads=4, kv_heads=2,
                head_dim=16, d_ff=96, rope_theta=5_000_000.0,
                mrope_section=(4, 2, 2), mrope_interleaved=True,
                qkv_bias=False, qk_norm=True),
            image_token_id=501, video_token_id=502,
            vision_start_token_id=503, vision_end_token_id=504)
    d_model, layers, heads, kv, d_ff = spec["dims"]
    return Qwen3VLConfig(
        vision=_q3_vision(out_hidden=d_model),
        text=_q3_text(d_model, layers, heads, kv, d_ff))


# ---------------------------------------------------------------------------
# Host geometry (depends only on grid_thw -> plain numpy)
# ---------------------------------------------------------------------------

def pos_embed_interp(grid_thw: tuple, cfg: Qwen3VisionConfig):
    """Bilinear interpolation of the learned position table: (idx (4,
    S_spatial), weights (4, S_spatial) f32, perm (S_spatial,)); the device
    gathers and blends, then permutes into merge-group order and tiles over
    t (HF fast_pos_embed_interpolate)."""
    t, h, w = grid_thw
    side = cfg.grid_side
    h_idx = np.linspace(0, side - 1, h)
    w_idx = np.linspace(0, side - 1, w)
    hf_, wf_ = h_idx.astype(np.int64), w_idx.astype(np.int64)
    hc = np.clip(hf_ + 1, None, side - 1)
    wc = np.clip(wf_ + 1, None, side - 1)
    dh, dw = h_idx - hf_, w_idx - wf_
    idx = np.stack([
        (hf_[:, None] * side + wf_[None, :]).ravel(),
        (hf_[:, None] * side + wc[None, :]).ravel(),
        (hc[:, None] * side + wf_[None, :]).ravel(),
        (hc[:, None] * side + wc[None, :]).ravel(),
    ])
    wts = np.stack([
        ((1 - dh)[:, None] * (1 - dw)[None, :]).ravel(),
        ((1 - dh)[:, None] * dw[None, :]).ravel(),
        (dh[:, None] * (1 - dw)[None, :]).ravel(),
        (dh[:, None] * dw[None, :]).ravel(),
    ]).astype(np.float32)
    m = cfg.merge_size
    perm = np.arange(h * w).reshape(h // m, m, w // m, m)
    perm = perm.transpose(0, 2, 1, 3).ravel()
    return idx, wts, perm


def vision_geometry(grid_thw: tuple, cfg: Qwen3VisionConfig) -> np.ndarray:
    """(S, 2) h/w rotary position ids in merge-group order (HF rot_pos_emb)."""
    t, h, w = grid_thw
    m = cfg.merge_size
    rows = (np.arange(h // m)[:, None, None, None] * m
            + np.arange(m)[None, None, :, None])
    cols = (np.arange(w // m)[None, :, None, None] * m
            + np.arange(m)[None, None, None, :])
    rows = np.broadcast_to(rows, (h // m, w // m, m, m)).reshape(-1)
    cols = np.broadcast_to(cols, (h // m, w // m, m, m)).reshape(-1)
    pos_hw = np.stack([rows, cols], axis=-1)
    return np.tile(pos_hw, (t, 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen3VisionConfig, device, dtype):
        super().__init__()
        d = cfg.hidden
        self.ln1 = Norm(d, True, device, dtype)
        self.qkv = Q.Linear.empty(d, 3 * d, True, device, dtype)
        self.qkv.parts = tuple((f"{n} heads", cfg.heads, cfg.head_dim) for n in "qkv")
        self.o = Q.Linear.empty(d, d, True, device, dtype)
        self.ln2 = Norm(d, True, device, dtype)
        self.fc1 = Q.Linear.empty(d, cfg.d_ff, True, device, dtype)
        self.fc2 = Q.Linear.empty(cfg.d_ff, d, True, device, dtype)


class Merger(nn.Module):
    """LayerNorm over ``hidden`` (pre-shuffle) or ``merge_unit * hidden``
    (post-shuffle, the deepstack mergers), then fc1, exact GELU, fc2."""

    def __init__(self, cfg: Qwen3VisionConfig, postshuffle: bool, device, dtype):
        super().__init__()
        mi = cfg.hidden * cfg.merge_unit
        self.norm = Norm(mi if postshuffle else cfg.hidden, True, device, dtype)
        self.fc1 = Q.Linear.empty(mi, mi, True, device, dtype)
        self.fc2 = Q.Linear.empty(mi, cfg.out_hidden, True, device, dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: Qwen3VisionConfig, device, dtype):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.patch_w = param(cfg.patch_dim, cfg.hidden)
        self.patch_b = param(cfg.hidden)
        self.pos_emb = param(cfg.num_position_embeddings, cfg.hidden)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype)
                                    for _ in range(cfg.depth))
        self.merger = Merger(cfg, False, device, dtype)
        self.deepstack = nn.ModuleList(Merger(cfg, True, device, dtype)
                                       for _ in cfg.deepstack_indexes)


class Qwen3VLModel(nn.Module):
    """Parameters of the whole scorer: ``vision`` and ``decoder``."""

    def __init__(self, cfg: Qwen3VLConfig, device, dtype):
        super().__init__()
        self.vision = VisionTower(cfg.vision, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_qwen3vl(cfg: Qwen3VLConfig, seed: int, device,
                 dtype=torch.float32, mesh=None) -> Qwen3VLModel:
    """Random parameters made on ``device`` in ``dtype``, one tensor at a
    time, from a ``torch.Generator`` seeded with ``seed``, with
    init_qwen3vl's distributions (the numbers differ from the JAX
    package's): linears N(0, 1/d_in), zero biases, LayerNorms (1, 0),
    position table N(0, 0.02^2), the decoder as ``decoder.init_decoder``.
    No host copy is made (qwen3-vl-30b-a3b is ~31 B parameters). ``mesh``:
    each rank holds its share of the same weights (its experts under EP)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_sharded(Qwen3VLModel, (cfg,), device, dtype, mesh)
    init_vision_(model.vision, gen)
    dec.init_decoder(model.decoder, gen)
    return model


@torch.no_grad()
def init_vision_(v: VisionTower, gen: torch.Generator) -> None:
    """Fill a vision tower in place with init_qwen3vl's distributions."""
    normal_(v.patch_w, v.patch_w.shape[0] ** -0.5, gen)
    v.patch_b.zero_()
    normal_(v.pos_emb, 0.02, gen)
    leaves, norms = [], []
    for blk in v.blocks:
        norms += [blk.ln1, blk.ln2]
        leaves += [blk.qkv, blk.o, blk.fc1, blk.fc2]
    for m in (v.merger, *v.deepstack):
        norms.append(m.norm)
        leaves += [m.fc1, m.fc2]
    for norm in norms:
        init_norm_(norm)
    for leaf in leaves:
        normal_(leaf.w, fan_in(leaf.w) ** -0.5, gen)
        leaf.b.zero_()


# ---------------------------------------------------------------------------
# Device: vision tower
# ---------------------------------------------------------------------------

def _merger(p: Merger, h: torch.Tensor) -> torch.Tensor:
    """The merger's MLP on normed rows (B, S/merge_unit, merge_unit * hidden)
    -> (B, S/merge_unit, out_hidden)."""
    return Q.linear(L.ACT_FNS["gelu"](Q.linear(h, p.fc1)), p.fc2)


def _deepstack_merger(p: Merger, cfg: Qwen3VisionConfig, x: torch.Tensor) -> torch.Tensor:
    """The post-shuffle merger of a deepstack level: (B, S, hidden) -> (B,
    S/merge_unit, out_hidden), the norm over each merge unit's rows."""
    b, s, _ = x.shape
    mu = cfg.merge_unit
    return _merger(p, L.layer_norm(x.reshape(b, s // mu, mu * cfg.hidden),
                                   p.norm.scale, p.norm.bias, cfg.ln_eps))


def vision_tower(params: VisionTower, cfg: Qwen3VisionConfig,
                 patches: torch.Tensor,   # (B, S, patch_dim) merge-group order
                 pos_hw: torch.Tensor,    # (B, S, 2) int
                 pe_idx: torch.Tensor,    # (4, S_spatial) int
                 pe_w: torch.Tensor,      # (4, S_spatial) f32
                 pe_perm: torch.Tensor,   # (S_spatial,) int
                 seg: torch.Tensor,       # (B, S) 0 on patches, -1 on pads
                 grid_t: int = 1):
    """B same-shape images through one call -> (merged (B, S/mu, out),
    [deepstack level (B, S/mu, out) for each of ``deepstack_indexes``])."""
    dtype = params.patch_w.dtype
    x = gather_cols(patches.to(dtype) @ params.patch_w, params.patch_w) + params.patch_b
    b, s, _ = x.shape
    # bilinear position embeddings: the blend in f32, one rounding
    pe = (params.pos_emb[pe_idx.long()].float() * pe_w.float()[..., None]).sum(0)
    pe = pe[pe_perm.long()].repeat(grid_t, 1)
    if pe.shape[0] < s:
        pe = torch.cat([pe, pe.new_zeros((s - pe.shape[0], pe.shape[1]))])
    x = x + pe.to(x.dtype)
    cos, sin = q2._vision_rope(cfg, pos_hw)                # (B, S, head_dim)

    # Each residual add is folded into the LayerNorm that reads its sum
    # (L.add_layer_norm): ``branch`` is the last block's MLP output, not yet
    # added; block i's output is the sum that block i + 1's ln1 (after the
    # last block, the merger's norm) writes, and its deepstack level reads it.
    deepstack = []

    def tap(i):
        if i in cfg.deepstack_indexes:
            di = cfg.deepstack_indexes.index(i)
            deepstack.append(_deepstack_merger(params.deepstack[di], cfg, x))

    branch = None
    for i, blk in enumerate(params.blocks):
        x, h = L.add_layer_norm(x, branch, blk.ln1.scale, blk.ln1.bias, cfg.ln_eps)
        tap(i - 1)
        heads = blk.qkv.d_out // (3 * cfg.head_dim)       # this rank's under TP
        pk = rope_pack(Q.linear(h, blk.qkv), cos, sin, 2 * heads, cfg.head_dim)
        a = attention_flat_packed(pk, heads, segment_ids=seg)
        x, h = L.add_layer_norm(x, Q.linear(a, blk.o), blk.ln2.scale, blk.ln2.bias,
                                cfg.ln_eps)
        branch = Q.linear(L.ACT_FNS[cfg.act](Q.linear(h, blk.fc1)), blk.fc2)
    norm = params.merger.norm
    x, h = L.add_layer_norm(x, branch, norm.scale, norm.bias, cfg.ln_eps)
    tap(len(params.blocks) - 1)
    mu = cfg.merge_unit
    return _merger(params.merger, h.reshape(b, s // mu, mu * cfg.hidden)), deepstack


def splice_and_score(params: Qwen3VLModel, cfg: Qwen3VLConfig, ids,
                     vis_feats, deepstack_feats, vis_mask, vis_slot,
                     position_ids, attn_mask, ans_ids, ans_pos, ans_mask,
                     temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced mean log P(answer), with deepstack residuals.
    deepstack_feats: (n_ds, B, T, D) features aligned with vis_feats'
    slots, scattered to the visual positions (zero elsewhere)."""
    return q2.splice_and_score(params, cfg, ids, vis_feats, vis_mask,
                               vis_slot, position_ids, attn_mask, ans_ids,
                               ans_pos, ans_mask, temperature=temperature,
                               deepstack_feats=deepstack_feats)


def splice_and_answer_dists(params: Qwen3VLModel, cfg: Qwen3VLConfig, ids,
                            stacked_feats, vis_mask, vis_slot, position_ids,
                            attn_mask, ans_pos, temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced fp32 softmax distributions (B, A, V) at the answer
    rows, the deepstack residuals included. stacked_feats: (B, 1 + n_ds, T,
    D), the main level and the deepstack levels."""
    return q2.splice_and_answer_dists(params, cfg, ids, stacked_feats[:, 0], vis_mask,
                                      vis_slot, position_ids, attn_mask, ans_pos,
                                      temperature=temperature,
                                      deepstack_feats=stacked_feats[:, 1:].unbind(1))


def convert_qwen3vl(sd, cfg: Qwen3VLConfig):
    """HF Qwen3VL(Moe)ForConditionalGeneration state dict -> tree of CPU
    tensor views in the JAX layout (port of the JAX ``convert_qwen3vl``):
    dense or MoE per layer, the MoE experts' fused ``gate_up_proj`` (E, H,
    2I) and ``down_proj`` (E, I, H) passed through as they are, the layout
    the grouped GEMM reads."""
    from .convert import _lin, _ln, patch_matrix, t2np

    def lin(name, bias=True):
        leaf = _lin(sd, name)
        return leaf if bias else {"w": leaf["w"], "b": None}

    def rms(name):
        return {"scale": t2np(sd[f"{name}.weight"])}

    def merger(prefix):
        return {"norm": _ln(sd, f"{prefix}.norm"),
                "fc1": lin(f"{prefix}.linear_fc1"),
                "fc2": lin(f"{prefix}.linear_fc2")}

    vp, tp = q2.hf_prefixes(sd)
    vision = {
        "patch_w": patch_matrix(sd[f"{vp}.patch_embed.proj.weight"]),
        "patch_b": t2np(sd[f"{vp}.patch_embed.proj.bias"]),
        "pos_emb": t2np(sd[f"{vp}.pos_embed.weight"]),
        "blocks": [],
        "merger": merger(f"{vp}.merger"),
        "deepstack": [merger(f"{vp}.deepstack_merger_list.{i}")
                      for i in range(len(cfg.vision.deepstack_indexes))],
    }
    for i in range(cfg.vision.depth):
        b = f"{vp}.blocks.{i}"
        vision["blocks"].append({
            "ln1": _ln(sd, f"{b}.norm1"),
            "attn": {**q2.split_qkv(sd, f"{b}.attn"), "o": lin(f"{b}.attn.proj")},
            "ln2": _ln(sd, f"{b}.norm2"),
            "mlp": {"fc1": lin(f"{b}.mlp.linear_fc1"), "fc2": lin(f"{b}.mlp.linear_fc2")},
        })
    blocks = []
    for i in range(cfg.text.layers):
        b = f"{tp}.layers.{i}"
        if f"{b}.mlp.experts.gate_up_proj" in sd:
            mlp = {"moe": {"router": {"w": t2np(sd[f"{b}.mlp.gate.weight"]).t()},
                           "gate_up": t2np(sd[f"{b}.mlp.experts.gate_up_proj"]),
                           "down": t2np(sd[f"{b}.mlp.experts.down_proj"])}}
        else:
            mlp = {k: lin(f"{b}.mlp.{k}_proj", bias=False) for k in ("gate", "up", "down")}
        blocks.append({
            "ln1": rms(f"{b}.input_layernorm"),
            "attn": {**{k: lin(f"{b}.self_attn.{k}_proj", bias=False) for k in "qkvo"},
                     "q_norm": rms(f"{b}.self_attn.q_norm"),
                     "k_norm": rms(f"{b}.self_attn.k_norm")},
            "ln2": rms(f"{b}.post_attention_layernorm"),
            "mlp": mlp,
        })
    decoder = {"embed": t2np(sd[f"{tp}.embed_tokens.weight"]), "blocks": blocks,
               "ln_final": rms(f"{tp}.norm")}
    if not cfg.text.tie_embeddings:
        decoder["lm_head"] = t2np(sd["lm_head.weight"]).t()
    return {"vision": vision, "decoder": decoder}
