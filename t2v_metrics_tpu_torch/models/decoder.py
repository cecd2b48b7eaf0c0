"""Decoder-only transformer (GQA + RoPE / M-RoPE) in PyTorch: the Qwen2.5,
Qwen3 and Gemma 3 parts of t2v_metrics_tpu/models/decoder.py.

Ported: ``DecoderConfig`` (every field), ``rope_cos_sin`` (1-D RoPE,
Qwen2.5-VL's sectioned M-RoPE and Qwen3-VL's interleaved layout, linear
scaling), the prefill branch of the attention (one packed q|k|v linear,
qk-norm and rope in one pass over the q|k lanes (``rms_norm_rope_pack``;
``rope_pack`` without the qk-norm), in place, the
flat attention with GQA, key mask, causal mask, the ``q_scale`` override,
a per-layer sliding window and the bidir image-block overlay, the
o-projection), the dense SwiGLU MLP, the routed-expert MLP (Qwen3-VL-MoE:
the sorted dispatch with the grouped GEMM of ``ops/moe.py`` when
``moe_dispatch``, else the dense ``_moe_mlp`` oracle), Gemma's sandwich
norms and ``layer_types`` (a local RoPE table on the sliding layers, linear
scaling on the global ones), ``forward`` with ``logit_positions`` (the lm
head runs only at the rows that score) and deepstack residuals, and the
random init, and the KV-cached path (``init_cache``, ``forward(cache=,
cache_pos=)``: one chunk appended to a flat (B, max_len, KvH*D) k and v per
layer, written in place, and attended over the cache view up to the chunk's
end), Qwen3-Omni's talker MoE (a SwiGLU shared expert behind a sigmoid
gate, top-k renormalised only when ``moe_norm_topk``) and ``forward``'s
``want_hidden`` / ``capture_layer`` outputs.

Parameters keep the JAX layouts (linear weights (in, out), activations flat
(B, S, H*D)); each layer's q|k|v weights are one packed (d_model,
(H + 2*KvH)*D) leaf, made once at load (``bridge.py``) or at init.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat, attention_flat_packed
from ..ops.moe import add_shared_expert, moe_mlp_dispatch
from ..ops.rope import rms_norm_rope_pack, rope_pack
from ..parallel import comm
from ..parallel.mesh import gather_cols
from .clip import Norm, fan_in, init_norm_, normal_


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 152064
    d_model: int = 3584
    layers: int = 28
    heads: int = 28
    kv_heads: int = 4
    head_dim: int = 128
    d_ff: int = 18944
    act: str = "silu"
    rms_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: tuple | None = (16, 24, 24)  # None -> standard 1D RoPE
    mrope_interleaved: bool = False  # Qwen3-VL interleaved THTHW... layout
    qkv_bias: bool = True
    tie_embeddings: bool = False
    # --- Gemma3-style options -------------------------------------------
    qk_norm: bool = False            # per-head RMSNorm on q/k
    q_scale: float | None = None     # attention scale override
    sandwich_norms: bool = False     # post-attn + pre/post-ffw norms
    rms_offset: float = 0.0          # 1.0 -> Gemma (1 + w) convention
    rms_cast_weight: bool = True     # False -> multiply in fp32 (Gemma)
    sliding_window: int | None = None
    layer_types: tuple | None = None  # per-layer 'sliding_attention'/'full_attention'
    local_rope_theta: float | None = None  # rope theta for sliding layers
    rope_scaling_factor: float | None = None  # linear scaling, global layers
    # --- MoE (Qwen3-VL-MoE-style) ---------------------------------------
    num_experts: int = 0                 # 0 -> dense MLP
    experts_per_tok: int = 8
    moe_d_ff: int = 0                    # per-expert intermediate size
    moe_dispatch: bool = False
    moe_norm_topk: bool = True           # renormalize top-k router weights
    moe_shared_ff: int = 0               # >0: shared expert + sigmoid gate


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(cfg: DecoderConfig, position_ids: torch.Tensor,
                 theta: float | None = None, scaling: float | None = None):
    """position_ids: (B, S), or (3, B, S) t/h/w streams for M-RoPE.

    Returns f32 cos/sin of shape (B, S, head_dim) with the M-RoPE sections
    already merged, so that applying them is uniform. ``scaling`` divides
    the inverse frequencies (HF linear rope scaling).
    """
    half = cfg.head_dim // 2
    theta = theta if theta is not None else cfg.rope_theta
    dev = position_ids.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=dev) / half))
    if scaling:
        inv_freq = inv_freq / scaling
    pos = position_ids.float()
    if position_ids.dim() == 2:
        pos = pos[None]                                # (1, B, S)
    freqs = pos[..., None] * inv_freq                  # (streams, B, S, half)
    if position_ids.dim() == 3 and cfg.mrope_section is not None:
        if cfg.mrope_interleaved:
            # Qwen3-VL: the T-stream frequencies, with H at indices
            # 1, 4, 7, .. (< 3*sec_h) and W at 2, 5, 8, .. (< 3*sec_w), only
            # below the half width (HF's slice clips there and the JAX
            # scatter drops the rest: the talker's (24, 20, 20) over 32)
            out = freqs[0].clone()
            for dim, offset in ((1, 1), (2, 2)):
                idx = torch.arange(offset, min(cfg.mrope_section[dim] * 3, half), 3,
                                   device=dev)
                out[..., idx] = freqs[dim][..., idx]
            freqs = out[None]
        else:
            # Qwen2.5-VL: section i of the half width from stream i % 3
            parts, start = [], 0
            for i, sec in enumerate(cfg.mrope_section):
                parts.append(freqs[i % 3, :, :, start:start + sec])
                start += sec
            freqs = torch.cat(parts, dim=-1)[None]
    emb = torch.cat([freqs, freqs], dim=-1)            # (streams, B, S, dim)
    return torch.cos(emb)[0], torch.sin(emb)[0]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class SharedExpert(nn.Module):
    """The talker MoE's shared SwiGLU expert: ``gate``, ``up`` (H, F) and
    ``down`` (F, H) leaves."""

    def __init__(self, d: int, ff: int, device, dtype):
        super().__init__()
        self.gate = Q.Linear.empty(d, ff, False, device, dtype)
        self.up = Q.Linear.empty(d, ff, False, device, dtype)
        self.down = Q.Linear.empty(ff, d, False, device, dtype)


class MoE(nn.Module):
    """Routed experts: ``router`` (a leaf, w (H, E)), ``gate_up`` (E, H, 2I)
    with the gate and up halves side by side, and ``down`` (E, I, H); with
    ``moe_shared_ff`` also ``shared`` (a ``SharedExpert``) and
    ``shared_gate`` (a leaf, w (H, 1)), else None."""

    def __init__(self, cfg: DecoderConfig, device, dtype):
        super().__init__()
        e, d, i = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        self.router = Q.Linear.empty(d, e, False, device, dtype)
        self.gate_up = nn.Parameter(torch.empty((e, d, 2 * i), device=device,
                                                dtype=dtype), requires_grad=False)
        self.down = nn.Parameter(torch.empty((e, i, d), device=device, dtype=dtype),
                                 requires_grad=False)
        sf = cfg.moe_shared_ff
        self.shared = SharedExpert(d, sf, device, dtype) if sf else None
        self.shared_gate = Q.Linear.empty(d, 1, False, device, dtype) if sf else None


class DecoderBlock(nn.Module):
    """``ln1``, ``qkv`` (q|k|v packed), ``q_norm`` / ``k_norm`` (qk-norm, or
    None), ``o``, ``ln2`` and either ``moe`` or the dense ``gate``, ``up``,
    ``down`` (the others None). With sandwich norms also ``ln1_post``,
    ``ln_ff_pre`` (which takes ``ln2``'s place) and ``ln_ff_post``."""

    def __init__(self, cfg: DecoderConfig, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        qkv_out = (cfg.heads + 2 * cfg.kv_heads) * hd
        self.ln1 = Norm(d, False, device, dtype)
        self.qkv = Q.Linear.empty(d, qkv_out, cfg.qkv_bias, device, dtype)
        self.qkv.parts = (("heads", cfg.heads, hd), ("kv heads", cfg.kv_heads, hd),
                          ("kv heads", cfg.kv_heads, hd))
        self.q_norm = Norm(hd, False, device, dtype) if cfg.qk_norm else None
        self.k_norm = Norm(hd, False, device, dtype) if cfg.qk_norm else None
        self.o = Q.Linear.empty(cfg.heads * hd, d, False, device, dtype)
        self.ln2 = Norm(d, False, device, dtype)
        sandwich = cfg.sandwich_norms
        self.ln1_post = Norm(d, False, device, dtype) if sandwich else None
        self.ln_ff_pre = Norm(d, False, device, dtype) if sandwich else None
        self.ln_ff_post = Norm(d, False, device, dtype) if sandwich else None
        self.moe = MoE(cfg, device, dtype) if cfg.num_experts else None
        dense = not cfg.num_experts
        self.gate = Q.Linear.empty(d, cfg.d_ff, False, device, dtype) if dense else None
        self.up = Q.Linear.empty(d, cfg.d_ff, False, device, dtype) if dense else None
        self.down = Q.Linear.empty(cfg.d_ff, d, False, device, dtype) if dense else None


class Decoder(nn.Module):
    """``embed`` (V, D), ``blocks``, ``ln_final`` and ``lm_head`` (D, V),
    which is None with tied embeddings."""

    def __init__(self, cfg: DecoderConfig, device, dtype):
        super().__init__()
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=device, dtype=dtype),
            requires_grad=False)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_final = Norm(cfg.d_model, False, device, dtype)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab_size), device=device, dtype=dtype),
            requires_grad=False))


@torch.no_grad()
def init_decoder(p: Decoder, gen: torch.Generator) -> Decoder:
    """Fill a decoder in place with init_decoder's distributions: linears
    N(0, 1/d_in), zero biases, ones for norms (qk-norm included), N(0,
    0.02^2) for ``embed`` and ``lm_head``; the router and ``gate_up``
    N(0, 1/d_model), ``down`` N(0, 1/moe_d_ff); the shared expert's and its
    gate's leaves N(0, 1/d_in) like the linears."""
    normal_(p.embed, 0.02, gen)
    if p.lm_head is not None:
        normal_(p.lm_head, 0.02, gen)
    init_norm_(p.ln_final)
    for blk in p.blocks:
        for norm in (blk.ln1, blk.ln2, blk.q_norm, blk.k_norm, blk.ln1_post,
                     blk.ln_ff_pre, blk.ln_ff_post):
            if norm is not None:
                init_norm_(norm)
        leaves = [blk.qkv, blk.o]
        if blk.moe is None:
            leaves += [blk.gate, blk.up, blk.down]
        else:
            leaves.append(blk.moe.router)
            if blk.moe.shared is not None:
                sh = blk.moe.shared
                leaves += [sh.gate, sh.up, sh.down, blk.moe.shared_gate]
            normal_(blk.moe.gate_up, blk.moe.gate_up.shape[1] ** -0.5, gen)
            normal_(blk.moe.down, blk.moe.down.shape[1] ** -0.5, gen)
        for leaf in leaves:
            normal_(leaf.w, fan_in(leaf.w) ** -0.5, gen)
            if leaf.b is not None:
                leaf.b.zero_()
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """Flat (B, max_len, kv_heads*head_dim) k and v per layer: the packed
    projection's k and v columns, appended with no transpose and read by the
    flat attention with GQA (no repeat of the kv heads)."""
    kvd = cfg.kv_heads * cfg.head_dim
    return [{"k": torch.zeros((batch, max_len, kvd), dtype=dtype, device=device),
             "v": torch.zeros((batch, max_len, kvd), dtype=dtype, device=device)}
            for _ in range(cfg.layers)]


def _attn(p: DecoderBlock, cfg: DecoderConfig, x, cos, sin, mask,
          local_window=None, bidir_ids=None, cache_layer=None, cache_pos=0):
    d = cfg.head_dim
    tp = (cfg.heads + 2 * cfg.kv_heads) * d // p.qkv.d_out   # its share of the heads
    h, kvh = cfg.heads // tp, cfg.kv_heads // tp
    packed = Q.linear(x, p.qkv)                        # (B, S, (H+2KvH)*D)
    if cfg.qk_norm:
        pk = rms_norm_rope_pack(packed, p.q_norm.scale, p.k_norm.scale, cos, sin, h, kvh,
                                d, cfg.rms_eps, offset=cfg.rms_offset,
                                cast_weight_dtype=cfg.rms_cast_weight)
    else:
        pk = rope_pack(packed, cos, sin, h + kvh, d)
    if cache_layer is None:
        out = attention_flat_packed(pk, h, kv_heads=kvh, kv_mask=mask, causal=True,
                                    scale=cfg.q_scale, local_window=local_window,
                                    bidir_ids=bidir_ids)
        return Q.linear(out, p.o)
    # the chunk takes cache slots [cache_pos, end), written in place; its
    # rows attend over the view of slots [0, end) with the causal band and
    # the window aligned to the view's end, so row i sees slots <= cache_pos
    # + i (and > cache_pos + i - window): the JAX masks over absolute slots
    end = cache_pos + x.shape[1]
    ck, cv = cache_layer["k"], cache_layer["v"]
    ck[:, cache_pos:end] = pk[..., h * d:(h + kvh) * d]
    cv[:, cache_pos:end] = pk[..., (h + kvh) * d:]
    out = attention_flat(pk[..., :h * d], ck[:, :end], cv[:, :end], h, kv_heads=kvh,
                         kv_mask=mask, causal=True, scale=cfg.q_scale,
                         local_window=local_window, bidir_ids=bidir_ids)
    return Q.linear(out, p.o)


def _mlp(p: DecoderBlock, cfg: DecoderConfig, x):
    if p.moe is not None:
        if cfg.moe_dispatch:
            return moe_mlp_dispatch(p.moe, cfg, x)
        return _moe_mlp(p.moe, cfg, x)
    h = L.ACT_FNS[cfg.act](Q.mm(x, p.gate)) * Q.mm(x, p.up)
    return Q.mm(h, p.down)


def _moe_mlp(p: MoE, cfg: DecoderConfig, x):
    """Top-k routed SwiGLU experts as a dense einsum: every token runs every
    expert and zero router weights mask the rest (HF Qwen3VLMoe semantics:
    fp32 router softmax, top-k renormalised when ``moe_norm_topk``), plus
    the sigmoid-gated shared expert where there is one (Qwen3-Omni's
    talker). The numerics oracle of ``moe_mlp_dispatch``; its (T, E, 2I)
    and (T, E, H) intermediates rule it out at real widths. On a share of
    the experts (expert parallelism) the rank runs its own and the combine
    is all-reduced, as in the dispatch."""
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    probs = torch.softmax(Q.mm(xt, p.router).float(), dim=-1)   # (T, E)
    topv, topi = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    if cfg.moe_norm_topk:
        topv = topv / topv.sum(-1, keepdim=True)
    w = torch.zeros_like(probs).scatter_(1, topi, topv)
    lo, group = getattr(p, "experts", (0, None))
    w = w[:, lo:lo + p.gate_up.shape[0]]
    gu = torch.einsum("th,ehi->tei", xt, p.gate_up)
    g, u = gu.chunk(2, dim=-1)
    act = L.ACT_FNS[cfg.act](g) * u
    out = torch.einsum("tei,eih->teh", act, p.down)
    out = out * w[..., None].to(out.dtype)
    if group is None:
        out = out.sum(dim=1)
    else:   # as the dispatch: the ranks' fp32 sums, rounded once after
        out = comm.all_reduce(out.float().sum(dim=1), group).to(x.dtype)
    out = add_shared_expert(p, cfg, xt, out)
    return out.reshape(b, s, h).to(x.dtype)


def _chunk_bidir(bidir_ids, cache_pos: int, s: int, device):
    """The overlay of a cached chunk of ``s`` rows from a cache-aligned (B,
    max_len) id array. At the prefill (``cache_pos`` 0) it is the chunk's own
    (B, s) ids: its keys are its rows, as the kernels take the overlay. Past
    the prefill the JAX package applies the overlay only to rows of a
    non-negative group, and generated rows are -1, so there it changes nothing
    and is left out; that is checked on a host array, and a device array
    raises there rather than drop a live overlay unseen."""
    if bidir_ids is None:
        return None
    if cache_pos == 0:
        return torch.as_tensor(bidir_ids[:, :s], device=device)
    if isinstance(bidir_ids, torch.Tensor) and bidir_ids.device.type != "cpu":
        raise ValueError("decoder: past the prefill, bidir_ids must be a host array "
                         "(its rows are checked to be -1 there)")
    if (np.asarray(bidir_ids[:, cache_pos:cache_pos + s]) >= 0).any():
        raise NotImplementedError("decoder: an image-block overlay on rows past the "
                                  "prefill")
    return None


def forward(params: Decoder, cfg: DecoderConfig, embeds: torch.Tensor,
            position_ids: torch.Tensor, attn_mask: torch.Tensor | None = None,
            logit_positions: torch.Tensor | None = None,
            cache=None, deepstack=None, bidir_ids=None, cache_pos: int = 0,
            want_hidden: bool = False, capture_layer: int | None = None):
    """embeds: (B, S, D) -> fp32 logits; with ``cache`` (logits, cache).

    want_hidden: also return the post-final-norm hidden (B, S, D) of every
    row (the talker's input to its code predictor). capture_layer k: also
    return HF's ``hidden_states[k]``, the residual stream after layer k
    (and its deepstack residual), the embeddings for k = 0. These come
    after the logits (and the cache), in the JAX order: hidden, then the
    capture.

    position_ids: (B, S), or (3, B, S) for M-RoPE. attn_mask: (B, S), true =
    a real token. logit_positions: optional (B, A) rows; the lm head then
    runs only there and the logits are (B, A, vocab) (the head is per row,
    so gathering rows before it equals gathering logits after it).
    deepstack: optional list of (B, S, D) residuals added, in the
    activation dtype, after layers 0..len-1 (Qwen3-VL's deepstack visual
    features, zero away from the visual positions). bidir_ids: optional
    (B, S) group ids, -1 on text: positions sharing a non-negative id attend
    each other both ways, over the causal mask and the window (Gemma 3 image
    blocks). Sliding layers (``layer_types``) take the local RoPE table and
    ``sliding_window``; the others the global table, linearly scaled.

    Without ``cache``: causal self-attention over the whole sequence
    (teacher-forced scoring). With ``cache`` (``init_cache``): the chunk's k
    and v are written into each layer's cache at slots [cache_pos,
    cache_pos + S) (a host int), in place, and the returned cache is the same
    list. attn_mask is then the (B, max_len) validity of the cache slots after
    the insert: masks count slots, not rope positions, so the pad slots
    between a short prompt and its first generated token stay invalid and a
    window counts them. bidir_ids is cache-aligned (B, max_len), -1 on
    generated slots (see ``_chunk_bidir``).
    """
    s = embeds.shape[1]
    if cache is not None:
        if attn_mask is None:
            raise ValueError("decoder: the cached path needs the cache's validity mask")
        attn_mask = attn_mask[:, :cache_pos + s].to(torch.int32).contiguous()
        bidir_ids = _chunk_bidir(bidir_ids, cache_pos, s, embeds.device)

    def norm(x, p):
        return L.rms_norm(x, p.scale, cfg.rms_eps, offset=cfg.rms_offset,
                          cast_weight_dtype=cfg.rms_cast_weight)

    def add_norm(x, r, p):
        return L.add_rms_norm(x, r, p.scale, cfg.rms_eps, offset=cfg.rms_offset,
                              cast_weight_dtype=cfg.rms_cast_weight)

    rope_g = rope_cos_sin(cfg, position_ids, scaling=cfg.rope_scaling_factor)
    rope_l = (rope_g if cfg.local_rope_theta is None
              else rope_cos_sin(cfg, position_ids, theta=cfg.local_rope_theta))
    # each residual add is folded into the RMSNorm that reads its sum: x is
    # the stream less ``branch``, the last add still pending (None: none)
    x, branch = embeds, None
    captured = embeds if capture_layer == 0 else None
    for i, blk in enumerate(params.blocks):
        sliding = (cfg.layer_types is not None and cfg.layer_types[
            i % len(cfg.layer_types)] == "sliding_attention")
        x, h = add_norm(x, branch, blk.ln1)
        a = _attn(blk, cfg, h, *(rope_l if sliding else rope_g),
                  attn_mask, local_window=cfg.sliding_window if sliding else None,
                  bidir_ids=bidir_ids, cache_layer=None if cache is None else cache[i],
                  cache_pos=cache_pos)
        if cfg.sandwich_norms:
            a = norm(a, blk.ln1_post)
        x, h = add_norm(x, a, blk.ln_ff_pre if cfg.sandwich_norms else blk.ln2)
        branch = _mlp(blk, cfg, h)
        if cfg.sandwich_norms:
            branch = norm(branch, blk.ln_ff_post)
        if deepstack is not None and i < len(deepstack):
            # two roundings stay two: the MLP's add here, the deepstack
            # residual's in the next norm
            x, branch = x + branch, deepstack[i].to(x.dtype)
        if capture_layer == i + 1:
            x, branch = x + branch, None
            captured = x
    x = add_norm(x, branch, params.ln_final)[1]
    xh = x
    if logit_positions is not None:
        rows = logit_positions.long().clamp(0, x.shape[1] - 1)
        xh = torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))
    if params.lm_head is None:
        logits = (xh @ params.embed.T).float()
    else:
        logits = gather_cols(xh @ params.lm_head, params.lm_head).float()
    out = (logits,) if cache is None else (logits, cache)
    if want_hidden:
        out += (x,)
    if capture_layer is not None:
        out += (captured,)
    return out[0] if len(out) == 1 else out
