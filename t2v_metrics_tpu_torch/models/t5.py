"""T5 / FlanT5 encoder-decoder in PyTorch (port of t2v_metrics_tpu/models/t5.py).

Parity-critical conventions, as in the JAX package:
  * RMSNorm, eps 1e-6, the normalized fp32 value rounded to the weight dtype
    before the scale multiply;
  * no 1/sqrt(d) attention scaling (scale=1.0);
  * relative-position bias held by layer 0 of each stack (bidirectional
    buckets in the encoder, causal in the decoder) and shared by the later
    layers; cross-attention has no bias; the bias is the dense (1, H, S, S)
    form (the JAX package's default, ``INKERNEL_REL_BIAS=False``);
  * FlanT5: gated gelu_new MLP, untied lm_head; logits are the bf16
    ``x @ lm_head`` cast to fp32.

Self-attention q|k|v weights are packed into one (d_model, 3*inner) leaf at
load, so the attention kernel reads the one projection in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat, attention_flat_packed
from .clip import Norm, init_norm_, normal_


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_heads: int = 6
    enc_layers: int = 8
    dec_layers: int = 8
    num_buckets: int = 32
    max_distance: int = 128
    eps: float = 1e-6
    gated: bool = True
    act: str = "gelu_new"
    tie_word_embeddings: bool = False
    decoder_start_token_id: int = 0
    pad_token_id: int = 0


# FlanT5 sizes (HF config values).
T5_CONFIGS = {
    "flan-t5-small": T5Config(d_model=512, d_kv=64, d_ff=1024, num_heads=6,
                              enc_layers=8, dec_layers=8),
    "flan-t5-base": T5Config(d_model=768, d_kv=64, d_ff=2048, num_heads=12,
                             enc_layers=12, dec_layers=12),
    "flan-t5-large": T5Config(d_model=1024, d_kv=64, d_ff=2816, num_heads=16,
                              enc_layers=24, dec_layers=24),
    "flan-t5-xl": T5Config(d_model=2048, d_kv=64, d_ff=5120, num_heads=32,
                           enc_layers=24, dec_layers=24),
    "flan-t5-xxl": T5Config(d_model=4096, d_kv=64, d_ff=10240, num_heads=64,
                            enc_layers=24, dec_layers=24),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class T5SelfAttention(nn.Module):
    """Packed q|k|v leaf, output leaf, and the rel-pos table in layer 0."""

    def __init__(self, cfg: T5Config, rel_bias: bool, device, dtype):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.qkv = Q.Linear.empty(cfg.d_model, 3 * inner, False, device, dtype)
        self.o = Q.Linear.empty(inner, cfg.d_model, False, device, dtype)
        self.rel_bias = (nn.Parameter(
            torch.empty((cfg.num_buckets, cfg.num_heads), device=device,
                        dtype=dtype), requires_grad=False) if rel_bias else None)


class T5CrossAttention(nn.Module):
    def __init__(self, cfg: T5Config, device, dtype):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = Q.Linear.empty(cfg.d_model, inner, False, device, dtype)
        self.k = Q.Linear.empty(cfg.d_model, inner, False, device, dtype)
        self.v = Q.Linear.empty(cfg.d_model, inner, False, device, dtype)
        self.o = Q.Linear.empty(inner, cfg.d_model, False, device, dtype)


class T5MLP(nn.Module):
    def __init__(self, cfg: T5Config, device, dtype):
        super().__init__()
        if cfg.gated:
            self.wi_0 = Q.Linear.empty(cfg.d_model, cfg.d_ff, False, device, dtype)
            self.wi_1 = Q.Linear.empty(cfg.d_model, cfg.d_ff, False, device, dtype)
        else:
            self.wi = Q.Linear.empty(cfg.d_model, cfg.d_ff, False, device, dtype)
        self.wo = Q.Linear.empty(cfg.d_ff, cfg.d_model, False, device, dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, decoder: bool, rel_bias: bool, device,
                 dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(d, False, device, dtype)
        self.attn = T5SelfAttention(cfg, rel_bias, device, dtype)
        if decoder:
            self.ln_cross = Norm(d, False, device, dtype)
            self.cross = T5CrossAttention(cfg, device, dtype)
        self.ln2 = Norm(d, False, device, dtype)
        self.mlp = T5MLP(cfg, device, dtype)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, layers: int, decoder: bool, device, dtype):
        super().__init__()
        self.blocks = nn.ModuleList(T5Block(cfg, decoder, i == 0, device, dtype)
                                    for i in range(layers))
        self.ln_final = Norm(cfg.d_model, False, device, dtype)


class T5Model(nn.Module):
    def __init__(self, cfg: T5Config, device, dtype):
        super().__init__()
        self.shared_emb = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=device, dtype=dtype),
            requires_grad=False)
        self.encoder = T5Stack(cfg, cfg.enc_layers, False, device, dtype)
        self.decoder = T5Stack(cfg, cfg.dec_layers, True, device, dtype)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab_size), device=device, dtype=dtype),
            requires_grad=False)


@torch.no_grad()
def init_t5(p: T5Model, gen: torch.Generator) -> T5Model:
    """Fill a T5 in place with init_t5's distributions: every linear,
    embedding and rel-pos table N(0, 0.02^2), norms ones."""
    for name, t in p.named_parameters():
        if name.endswith(".scale"):
            t.fill_(1.0)
        else:
            normal_(t, 0.02, gen)
    return p


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------

def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5's bucketing of relative positions (memory_pos - query_pos)."""
    rel = relative_position
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    rel_large = torch.clamp(rel_large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, rel_large)


def compute_position_bias(rel_emb: torch.Tensor, qlen: int, klen: int,
                          bidirectional: bool, num_buckets: int,
                          max_distance: int, q_offset: int = 0) -> torch.Tensor:
    """rel_emb: (num_buckets, heads) -> bias (1, heads, qlen, klen)."""
    dev = rel_emb.device
    ctx = torch.arange(qlen, device=dev)[:, None] + q_offset
    mem = torch.arange(klen, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                       max_distance)
    return rel_emb[buckets].permute(2, 0, 1)[None]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _self_attention(p: T5SelfAttention, x, heads, bias=None, kv_mask=None,
                    causal=False):
    a = attention_flat_packed(Q.mm(x, p.qkv), heads, bias=bias,
                              kv_mask=kv_mask, causal=causal, scale=1.0)
    return Q.mm(a, p.o)


def _cross_attention(p: T5CrossAttention, x, kv, heads, kv_mask=None):
    a = attention_flat(Q.mm(x, p.q), Q.mm(kv, p.k), Q.mm(kv, p.v), heads,
                       kv_mask=kv_mask, scale=1.0)
    return Q.mm(a, p.o)


def _t5_mlp(p: T5MLP, x, cfg: T5Config):
    if cfg.gated:
        h = L.ACT_FNS[cfg.act](Q.mm(x, p.wi_0)) * Q.mm(x, p.wi_1)
    else:
        h = torch.relu(Q.mm(x, p.wi))
    return Q.mm(h, p.wo)


def _enc_block(p: T5Block, x, cfg: T5Config, bias, kv_mask):
    h = L.rms_norm(x, p.ln1.scale, cfg.eps)
    x = x + _self_attention(p.attn, h, cfg.num_heads, bias=bias, kv_mask=kv_mask)
    h = L.rms_norm(x, p.ln2.scale, cfg.eps)
    return x + _t5_mlp(p.mlp, h, cfg)


def _dec_block(p: T5Block, x, enc, cfg: T5Config, self_bias, enc_mask,
               self_mask):
    h = L.rms_norm(x, p.ln1.scale, cfg.eps)
    x = x + _self_attention(p.attn, h, cfg.num_heads, bias=self_bias,
                            kv_mask=self_mask, causal=True)
    h = L.rms_norm(x, p.ln_cross.scale, cfg.eps)
    x = x + _cross_attention(p.cross, h, enc, cfg.num_heads, kv_mask=enc_mask)
    h = L.rms_norm(x, p.ln2.scale, cfg.eps)
    return x + _t5_mlp(p.mlp, h, cfg)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

def encode(params: T5Model, cfg: T5Config, input_embeds: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """input_embeds: (B, S, d_model), possibly with image features spliced
    in. mask: (B, S) bool."""
    enc = params.encoder
    s = input_embeds.shape[1]
    # fp32 and contiguous once per pass; every layer reads it
    bias = compute_position_bias(enc.blocks[0].attn.rel_bias, s, s, True,
                                 cfg.num_buckets, cfg.max_distance
                                 ).float().contiguous()
    x = input_embeds
    for blk in enc.blocks:
        x = _enc_block(blk, x, cfg, bias, mask)
    return L.rms_norm(x, enc.ln_final.scale, cfg.eps)


def decode(params: T5Model, cfg: T5Config, decoder_ids: torch.Tensor,
           enc_hidden: torch.Tensor, enc_mask: torch.Tensor | None = None,
           dec_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced decoder pass. Returns logits (B, S_dec, vocab) fp32."""
    dec = params.decoder
    x = params.shared_emb[decoder_ids]
    a = decoder_ids.shape[1]
    bias = compute_position_bias(dec.blocks[0].attn.rel_bias, a, a, False,
                                 cfg.num_buckets, cfg.max_distance
                                 ).float().contiguous()
    for blk in dec.blocks:
        x = _dec_block(blk, x, enc_hidden, cfg, bias, enc_mask, dec_mask)
    x = L.rms_norm(x, dec.ln_final.scale, cfg.eps)
    if cfg.tie_word_embeddings:
        logits = (x * cfg.d_model ** -0.5) @ params.shared_emb.T
    else:
        logits = x @ params.lm_head
    return logits.float()


def answer_log_probs(params: T5Model, cfg: T5Config,
                     input_embeds: torch.Tensor, enc_mask: torch.Tensor,
                     answer_ids: torch.Tensor,
                     answer_mask: torch.Tensor) -> torch.Tensor:
    """Mean log P(answer token | encoder input), teacher-forced, per row.

    answer_ids: (B, A) ids incl. the final </s>, right-padded; answer_mask
    (B, A) float. Returns (B,) fp32.
    """
    enc_hidden = encode(params, cfg, input_embeds, enc_mask)
    start = torch.full((answer_ids.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=answer_ids.dtype, device=answer_ids.device)
    dec_in = torch.cat([start, answer_ids[:, :-1]], dim=1)
    logits = decode(params, cfg, dec_in, enc_hidden, enc_mask)
    logp = torch.log_softmax(logits, dim=-1)
    idx = answer_ids.long().clamp(0, logp.shape[-1] - 1)
    tok_logp = torch.gather(logp, -1, idx[..., None])[..., 0] * answer_mask
    return tok_logp.sum(-1) / torch.clamp(answer_mask.sum(-1), min=1)
