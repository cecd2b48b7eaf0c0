"""T5 / FlanT5 encoder-decoder in PyTorch (port of t2v_metrics_tpu/models/t5.py).

Parity-critical conventions, as in the JAX package:
  * RMSNorm, eps 1e-6, the normalized fp32 value rounded to the weight dtype
    before the scale multiply;
  * no 1/sqrt(d) attention scaling (scale=1.0);
  * relative-position bias held by layer 0 of each stack (bidirectional
    buckets in the encoder, causal in the decoder) and shared by the later
    layers; cross-attention has no bias; the bias is the dense (1, H, S, S)
    form by default, or computed in the per-head attention kernel from the
    (H, num_buckets) table under ``INKERNEL_REL_BIAS`` (as in the JAX
    package, default False);
  * FlanT5: gated gelu_new MLP, untied lm_head; logits are the bf16
    ``x @ lm_head`` cast to fp32.

Both decode-step attentions run in the port's kernels (the flat one, or
the per-head one with the bias in the kernel under ``INKERNEL_REL_BIAS``),
where the JAX package runs them through its XLA reference: the self-
attention over the cache view of slots [0, cpos] with the bias row of
relative positions ``mem - cpos``, the cross-attention over the encoder rows
with their key mask.

Self-attention q|k|v weights are packed into one (d_model, 3*inner) leaf at
load, so the attention kernel reads the one projection in place; the cached
decode step (``decode_step``, ``greedy_decode``) writes its k and v columns
into a (B, max_len, H*d_kv) cache in place. Under int8
(``ops/quant.quantize_t5_``) the packed q|k|v and the other linears become
int8 leaves, cross-attention q, k and v stay separate products as in the JAX
package, and a gated MLP runs one packed wi_0|wi_1 leaf (``wi_01``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import (attention, attention_flat, attention_flat_packed,
                             merge_heads, packed_heads, split_heads)
from ..ops.position import compute_position_bias
from ..parallel import mesh as pmesh
from ..parallel import sp as psp
from .clip import Norm, init_norm_, normal_

# In-kernel T5 relative-position bias (t2v_metrics_tpu/models/t5.py:44, off
# there too): the self-attention runs the per-head attention() on (B, H, S,
# D) views of the packed projection with the (H, num_buckets) table, and no
# dense (1, H, S, S) bias is built.
INKERNEL_REL_BIAS = False


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
        self.qkv.parts = tuple((f"{n} heads", cfg.num_heads, cfg.d_kv) for n in "qkv")
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
# Blocks
# ---------------------------------------------------------------------------

def _self_attention(p: T5SelfAttention, x, cfg: T5Config, bias=None, kv_mask=None,
                    causal=False, rel_bias=None, rel_cfg=None, seq=False):
    """Self-attention over this rank's heads (all of them without tensor
    parallelism). ``seq``: ``x`` holds this rank's rows of the sequence
    (``parallel/sp.py``): its queries run against the keys and values of
    every row, all-gathered over sp; ``bias`` holds its rows only, and the
    in-kernel bias takes their offset in ``rel_cfg``."""
    qkv = Q.mm(x, p.qkv)
    heads = p.qkv.d_out // (3 * cfg.d_kv)
    inner = heads * cfg.d_kv
    if seq:
        q, kv = qkv[..., :inner], psp.gather_seq(qkv[..., inner:])
        k, v = kv[..., :inner], kv[..., inner:]
        if rel_bias is None:
            a = attention_flat(q, k, v, heads, bias=bias, kv_mask=kv_mask,
                               causal=causal, scale=1.0)
        else:
            a = merge_heads(attention(*(split_heads(t, heads) for t in (q, k, v)),
                                      kv_mask=kv_mask, causal=causal, scale=1.0,
                                      rel_bias=rel_bias, rel_cfg=rel_cfg))
    elif rel_bias is None:
        a = attention_flat_packed(qkv, heads, bias=bias, kv_mask=kv_mask,
                                  causal=causal, scale=1.0)
    else:
        a = merge_heads(attention(*packed_heads(qkv, heads), kv_mask=kv_mask,
                                  causal=causal, scale=1.0, rel_bias=rel_bias,
                                  rel_cfg=rel_cfg))
    return Q.mm(a, p.o)


def _cross_attention(p: T5CrossAttention, x, kv, cfg: T5Config, kv_mask=None):
    a = attention_flat(Q.mm(x, p.q), Q.mm(kv, p.k), Q.mm(kv, p.v),
                       p.q.d_out // cfg.d_kv, kv_mask=kv_mask, scale=1.0)
    return Q.mm(a, p.o)


def _t5_mlp(p: T5MLP, x, cfg: T5Config):
    if cfg.gated and hasattr(p, "wi_01"):
        # int8: ONE packed wi_0|wi_1 product (one activation quant for both),
        # split into its halves
        h0, h1 = Q.mm(x, p.wi_01).chunk(2, dim=-1)
        h = L.ACT_FNS[cfg.act](h0) * h1
    elif cfg.gated:
        h = L.ACT_FNS[cfg.act](Q.mm(x, p.wi_0)) * Q.mm(x, p.wi_1)
    else:
        h = torch.relu(Q.mm(x, p.wi))
    return Q.mm(h, p.wo)


def _enc_block(p: T5Block, x, branch, cfg: T5Config, bias, kv_mask, rel=(None, None),
               seq=False):
    """One encoder block on the residual stream ``x + branch`` (``branch``:
    the previous block's MLP output, not yet added, or None). Each residual
    add is folded into the RMSNorm that reads its sum. Returns (the stream
    after the attention half, this block's MLP output, not yet added)."""
    x, h = L.add_rms_norm(x, branch, p.ln1.scale, cfg.eps)
    a = _self_attention(p.attn, h, cfg, bias, kv_mask, False, *rel, seq=seq)
    x, h = L.add_rms_norm(x, a, p.ln2.scale, cfg.eps)
    return x, _t5_mlp(p.mlp, h, cfg)


def _dec_block(p: T5Block, x, branch, enc, cfg: T5Config, self_bias, enc_mask,
               self_mask, rel=(None, None)):
    """One decoder block on ``x + branch``, as ``_enc_block``."""
    x, h = L.add_rms_norm(x, branch, p.ln1.scale, cfg.eps)
    a = _self_attention(p.attn, h, cfg, self_bias, self_mask, True, *rel)
    x, h = L.add_rms_norm(x, a, p.ln_cross.scale, cfg.eps)
    a = _cross_attention(p.cross, h, enc, cfg, kv_mask=enc_mask)
    x, h = L.add_rms_norm(x, a, p.ln2.scale, cfg.eps)
    return x, _t5_mlp(p.mlp, h, cfg)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

def _position_bias(stack: T5Stack, cfg: T5Config, qlen: int, klen: int,
                   bidirectional: bool):
    """(dense bias, (rel_bias, rel_cfg)) of a stack: the dense (1, H, S, S)
    fp32 bias, contiguous once per pass since every layer reads it, or
    under INKERNEL_REL_BIAS the (H, num_buckets) table and its config."""
    rel_emb = stack.blocks[0].attn.rel_bias
    if INKERNEL_REL_BIAS:
        return None, (rel_emb.T, (bidirectional, cfg.num_buckets,
                                  cfg.max_distance, 0))
    bias = compute_position_bias(rel_emb, qlen, klen, bidirectional,
                                 cfg.num_buckets, cfg.max_distance)
    return bias.float().contiguous(), (None, None)


def encode(params: T5Model, cfg: T5Config, input_embeds: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """input_embeds: (B, S, d_model), possibly with image features spliced
    in. mask: (B, S) bool.

    Under an ambient mesh with an sp axis (``parallel/sp.py``, the hooks of
    the JAX t5.py:216-222) each rank runs its S/sp rows through the blocks
    and the final norm, its queries against all keys with its rows of the
    bias, and the rows are joined at the end."""
    enc = params.encoder
    s = input_embeds.shape[1]
    bias, rel = _position_bias(enc, cfg, s, s, True)
    share = psp.seq_shard(s)
    if share is not None:
        off, rows = share
        if bias is not None:
            bias = bias[:, :, off:off + rows].contiguous()
        else:
            rel = (rel[0], rel[1][:3] + (off,))
    x, branch = psp.shard_seq(input_embeds), None
    for blk in enc.blocks:
        x, branch = _enc_block(blk, x, branch, cfg, bias, mask, rel, seq=share is not None)
    return psp.gather_seq(L.add_rms_norm(x, branch, enc.ln_final.scale, cfg.eps)[1])


def decode(params: T5Model, cfg: T5Config, decoder_ids: torch.Tensor,
           enc_hidden: torch.Tensor, enc_mask: torch.Tensor | None = None,
           dec_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced decoder pass. Returns logits (B, S_dec, vocab) fp32."""
    dec = params.decoder
    x = params.shared_emb[decoder_ids]
    a = decoder_ids.shape[1]
    bias, rel = _position_bias(dec, cfg, a, a, False)
    branch = None
    for blk in dec.blocks:
        x, branch = _dec_block(blk, x, branch, enc_hidden, cfg, bias, enc_mask, dec_mask, rel)
    x = L.add_rms_norm(x, branch, dec.ln_final.scale, cfg.eps)[1]
    if cfg.tie_word_embeddings:
        logits = (x * cfg.d_model ** -0.5) @ params.shared_emb.T
    else:
        logits = pmesh.gather_cols(x @ params.lm_head, params.lm_head)
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


# ---------------------------------------------------------------------------
# Cached incremental decoding (generate)
# ---------------------------------------------------------------------------

def init_dec_cache(params: T5Model, cfg: T5Config, batch: int, max_len: int) -> list[dict]:
    """The decoder self-attention's k and v cache, (B, max_len, H*d_kv) a
    layer in the embedding dtype."""
    e = params.shared_emb
    kv = params.decoder.blocks[0].attn.qkv.d_out // 3    # this rank's heads
    return [{"k": torch.zeros((batch, max_len, kv), dtype=e.dtype, device=e.device),
             "v": torch.zeros((batch, max_len, kv), dtype=e.dtype, device=e.device)}
            for _ in range(len(params.decoder.blocks))]


def cross_kv(params: T5Model, cfg: T5Config, enc_hidden: torch.Tensor) -> list:
    """Per-layer cross-attention (k, v) from the encoder hidden, once."""
    return [(Q.mm(enc_hidden, blk.cross.k), Q.mm(enc_hidden, blk.cross.v))
            for blk in params.decoder.blocks]


def decode_step(params: T5Model, cfg: T5Config, tok_ids: torch.Tensor, cache,
                cpos: int, cross_kvs, enc_mask=None):
    """One incremental decoder step.

    tok_ids: (B, 1) current decoder input token; cache: ``init_dec_cache``'s
    list, written in place at slot ``cpos`` (a host int; 0 = the decoder
    start token); cross_kvs: ``cross_kv``'s output. The self-attention runs
    over the cache view of slots [0, cpos] with the causal bias row of
    relative positions ``mem - cpos``. Returns (logits (B, vocab) fp32,
    cache).
    """
    dec = params.decoder
    inner = dec.blocks[0].attn.qkv.d_out // 3           # this rank's heads
    heads = inner // cfg.d_kv
    x = params.shared_emb[tok_ids]                      # (B, 1, D)
    end = cpos + 1
    rel_emb = dec.blocks[0].attn.rel_bias
    if INKERNEL_REL_BIAS:
        bias, rel = None, (rel_emb.T, (False, cfg.num_buckets, cfg.max_distance, cpos))
    else:
        bias = compute_position_bias(rel_emb, 1, end, False, cfg.num_buckets,
                                     cfg.max_distance, q_offset=cpos).float().contiguous()
    b = x.shape[0]

    def heads_of(t):                                    # (B, S, H*d) -> (B, H, S, d)
        return t.view(b, t.shape[1], heads, cfg.d_kv).transpose(1, 2)

    branch = None                                       # the pending residual add
    for blk, cl, (ck, cv) in zip(dec.blocks, cache, cross_kvs):
        x, h = L.add_rms_norm(x, branch, blk.ln1.scale, cfg.eps)
        qkv = Q.mm(h, blk.attn.qkv)                     # (B, 1, 3*inner)
        cl["k"][:, cpos:end] = qkv[..., inner:2 * inner]
        cl["v"][:, cpos:end] = qkv[..., 2 * inner:]
        k, v = cl["k"][:, :end], cl["v"][:, :end]
        if INKERNEL_REL_BIAS:
            a = merge_heads(attention(heads_of(qkv[..., :inner]), heads_of(k), heads_of(v),
                                      scale=1.0, rel_bias=rel[0], rel_cfg=rel[1]))
        else:
            a = attention_flat(qkv[..., :inner], k, v, heads, bias=bias, scale=1.0)
        x, h = L.add_rms_norm(x, Q.mm(a, blk.attn.o), blk.ln_cross.scale, cfg.eps)
        a = attention_flat(Q.mm(h, blk.cross.q), ck, cv, heads, kv_mask=enc_mask, scale=1.0)
        x, h = L.add_rms_norm(x, Q.mm(a, blk.cross.o), blk.ln2.scale, cfg.eps)
        branch = _t5_mlp(blk.mlp, h, cfg)
    x = L.add_rms_norm(x, branch, dec.ln_final.scale, cfg.eps)[1]
    if cfg.tie_word_embeddings:
        logits = (x * cfg.d_model ** -0.5) @ params.shared_emb.T
    else:
        logits = pmesh.gather_cols(x @ params.lm_head, params.lm_head)
    return logits[:, 0].float(), cache


@torch.inference_mode()
def greedy_decode(params: T5Model, cfg: T5Config, enc_hidden: torch.Tensor,
                  enc_mask: torch.Tensor, max_new_tokens: int, eos_id: int = 1,
                  pad_id: int = 0) -> torch.Tensor:
    """Batched greedy decode over cached ``decode_step``s, with no host
    round-trip until the caller reads the tokens. Returns (B,
    max_new_tokens) int64 on the device: ``pad_id`` after EOS, and EOS itself
    is never emitted."""
    b = enc_hidden.shape[0]
    dev = enc_hidden.device
    ckv = cross_kv(params, cfg, enc_hidden)
    cache = init_dec_cache(params, cfg, b, max_new_tokens + 1)
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tok = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    for step in range(max_new_tokens):
        logits, cache = decode_step(params, cfg, tok, cache, step, ckv, enc_mask)
        nxt = logits.argmax(-1)
        stop = nxt == eos_id
        tokens[:, step] = torch.where(done | stop, torch.full_like(nxt, pad_id), nxt)
        done = done | stop
        tok = nxt[:, None]
    return tokens
