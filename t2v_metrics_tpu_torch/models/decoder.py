"""Decoder-only transformer (GQA + RoPE / M-RoPE) in PyTorch: the Qwen2.5
parts of t2v_metrics_tpu/models/decoder.py.

Ported: ``DecoderConfig`` (every field), ``rope_cos_sin`` (1-D RoPE,
Qwen2.5-VL's sectioned M-RoPE and Qwen3-VL's interleaved layout, linear
scaling), the prefill branch of the attention (one packed q|k|v linear,
``rope_pack`` on the q|k lanes, the flat attention with GQA, key mask and
causal mask, the o-projection), the dense SwiGLU MLP, ``forward`` with
``logit_positions`` (the lm head runs only at the rows that score) and the
random init. The cached decode path, MoE, qk-norm, sandwich norms and
sliding windows come with the slices that need them and raise until then.

Parameters keep the JAX layouts (linear weights (in, out), activations flat
(B, S, H*D)); each layer's q|k|v weights are one packed (d_model,
(H + 2*KvH)*D) leaf, made once at load (``bridge.py``) or at init.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.rope import rope_pack
from .clip import Norm, init_norm_, normal_


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


def check_supported(cfg: DecoderConfig) -> None:
    """Raise for the decoder options whose slices are not ported yet."""
    missing = [name for name, on in (
        ("MoE", cfg.num_experts), ("qk_norm", cfg.qk_norm),
        ("sandwich_norms", cfg.sandwich_norms),
        ("sliding windows", cfg.sliding_window is not None
         or cfg.layer_types is not None)) if on]
    if missing:
        raise NotImplementedError(f"decoder: {', '.join(missing)} not ported yet")


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
            # 1, 4, 7, .. (< 3*sec_h) and W at 2, 5, 8, .. (< 3*sec_w)
            out = freqs[0].clone()
            for dim, offset in ((1, 1), (2, 2)):
                idx = torch.arange(offset, cfg.mrope_section[dim] * 3, 3,
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

class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        qkv_out = (cfg.heads + 2 * cfg.kv_heads) * hd
        self.ln1 = Norm(d, False, device, dtype)
        self.qkv = Q.Linear.empty(d, qkv_out, cfg.qkv_bias, device, dtype)
        self.o = Q.Linear.empty(cfg.heads * hd, d, False, device, dtype)
        self.ln2 = Norm(d, False, device, dtype)
        self.gate = Q.Linear.empty(d, cfg.d_ff, False, device, dtype)
        self.up = Q.Linear.empty(d, cfg.d_ff, False, device, dtype)
        self.down = Q.Linear.empty(cfg.d_ff, d, False, device, dtype)


class Decoder(nn.Module):
    """``embed`` (V, D), ``blocks``, ``ln_final`` and ``lm_head`` (D, V),
    which is None with tied embeddings."""

    def __init__(self, cfg: DecoderConfig, device, dtype):
        super().__init__()
        check_supported(cfg)
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
    N(0, 1/d_in), zero biases, ones for norms, N(0, 0.02^2) for ``embed``
    and ``lm_head``."""
    normal_(p.embed, 0.02, gen)
    if p.lm_head is not None:
        normal_(p.lm_head, 0.02, gen)
    init_norm_(p.ln_final)
    for blk in p.blocks:
        init_norm_(blk.ln1)
        init_norm_(blk.ln2)
        for leaf in (blk.qkv, blk.o, blk.gate, blk.up, blk.down):
            normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
            if leaf.b is not None:
                leaf.b.zero_()
    return p


# ---------------------------------------------------------------------------
# Forward (prefill, no cache)
# ---------------------------------------------------------------------------

def _attn(p: DecoderBlock, cfg: DecoderConfig, x, cos, sin, mask):
    h, kvh, d = cfg.heads, cfg.kv_heads, cfg.head_dim
    packed = Q.linear(x, p.qkv)                        # (B, S, (H+2KvH)*D)
    pk = rope_pack(packed, cos, sin, h + kvh, d)
    out = attention_flat_packed(pk, h, kv_heads=kvh, kv_mask=mask, causal=True,
                                scale=cfg.q_scale)
    return Q.linear(out, p.o)


def _mlp(p: DecoderBlock, cfg: DecoderConfig, x):
    h = L.ACT_FNS[cfg.act](Q.mm(x, p.gate)) * Q.mm(x, p.up)
    return Q.mm(h, p.down)


def forward(params: Decoder, cfg: DecoderConfig, embeds: torch.Tensor,
            position_ids: torch.Tensor, attn_mask: torch.Tensor | None = None,
            logit_positions: torch.Tensor | None = None,
            cache=None) -> torch.Tensor:
    """embeds: (B, S, D) -> fp32 logits, causal self-attention over the
    whole sequence (teacher-forced scoring).

    position_ids: (B, S), or (3, B, S) for M-RoPE. attn_mask: (B, S), true =
    a real token. logit_positions: optional (B, A) rows; the lm head then
    runs only there and the logits are (B, A, vocab) (the head is per row,
    so gathering rows before it equals gathering logits after it).
    """
    if cache is not None:
        raise NotImplementedError("decoder: the KV-cached decode path is not "
                                  "ported yet")

    def norm(x, p):
        return L.rms_norm(x, p.scale, cfg.rms_eps, offset=cfg.rms_offset,
                          cast_weight_dtype=cfg.rms_cast_weight)

    cos, sin = rope_cos_sin(cfg, position_ids, scaling=cfg.rope_scaling_factor)
    x = embeds
    for blk in params.blocks:
        x = x + _attn(blk, cfg, norm(x, blk.ln1), cos, sin, attn_mask)
        x = x + _mlp(blk, cfg, norm(x, blk.ln2))
    x = norm(x, params.ln_final)
    if logit_positions is not None:
        rows = logit_positions.long().clamp(0, x.shape[1] - 1)
        x = torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))
    head = params.embed.T if params.lm_head is None else params.lm_head
    return (x @ head).float()
