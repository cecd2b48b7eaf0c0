"""Qwen3-Omni talker: speech output (codec generation and the vocoder) in
PyTorch (port of t2v_metrics_tpu/models/qwen3omni_talker.py; HF
Qwen3OmniMoeForConditionalGeneration, transformers 4.57):

  1. the thinker generates the text; its input embeddings and its hidden
     state after layer ``accept_hidden_layer`` condition the talker
     (``build_talker_inputs``);
  2. the talker, an MoE decoder with a sigmoid-gated shared expert, qk-norm
     attention and interleaved M-RoPE (``models/decoder.py``), emits the
     first codebook token of each frame through its codec head;
  3. the code predictor, a small dense decoder with per-group embedding
     tables and heads, fills the frame's other ``num_code_groups - 1``
     tokens; the talker's next input is the sum of the frame's group
     embeddings and the next trailing text row (``TalkerSession``);
  4. Code2Wav decodes the (groups, frames) codes to a 24 kHz waveform: the
     mean of the codes' embeddings, a causal transformer with a 72-slot
     window, ConvNeXt upsampling and SnakeBeta / transposed-conv decoder
     blocks, in chunks with left context (``code2wav``, ``chunked_decode``).

Kernels: the decoders run the port's decoder (flat attention, RMSNorm and
qk-norm, rope, the grouped GEMM); the Code2Wav transformer the flat kernel
(causal, ``local_window``), RMSNorm and rope; its ConvNeXt LayerNorm the
LayerNorm kernel. The convolutions are ``F.conv1d`` / ``F.conv_transpose1d``
(cuDNN), as the JAX package computes them with ``lax.conv`` outside any
Pallas kernel.

Departures from the JAX package, each raising a ``ValueError`` where it
would compute something else: a codec id outside its table (the JAX gathers
clamp to the last row; HF's embeddings raise), and codes whose group count
is not ``num_quantizers`` (HF raises; JAX fails to broadcast). The config
defaults are JAX's (32 code groups against 16 quantizers, upsample rates
(5, 4, 3, 2)); a caller that decodes audio sets them consistently.

Parameters keep the JAX layouts (linear weights (in, out)); each attention
layer's q|k|v is one packed leaf, made at load (``bridge.py``).
"""

from __future__ import annotations

import dataclasses
import zlib
from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from ..ops.attention import attention_flat_packed
from ..ops.rope import rope_pack
from . import decoder as dec
from .clip import Norm
from .convert import t2np


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Code2WavConfig:
    codebook_size: int = 2048
    num_quantizers: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    intermediate_size: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    layer_scale_initial_scale: float = 0.01
    upsampling_ratios: tuple = (2, 2)
    upsample_rates: tuple = (5, 4, 3, 2)
    decoder_dim: int = 1536
    act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates + self.upsampling_ratios))


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    text: dec.DecoderConfig            # MoE decoder (+ shared expert)
    predictor: dec.DecoderConfig       # dense code-predictor decoder
    code2wav: Code2WavConfig
    num_code_groups: int = 32
    thinker_hidden_size: int = 2048
    accept_hidden_layer: int = 18
    codec_eos_token_id: int = 4198
    codec_nothink_id: int = 4203
    codec_think_bos_id: int = 4204
    codec_think_eos_id: int = 4205
    codec_pad_id: int = 4196
    codec_bos_id: int = 4197
    speaker_id: tuple = (("ethan", 4199), ("chelsie", 4200), ("aiden", 4202))
    # thinker-side special ids (chat structure + tts specials)
    im_start_token_id: int = 151644
    system_token_id: int = 8948
    user_token_id: int = 872
    assistant_token_id: int = 77091
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671
    # the last `suppress_band` codec-vocab ids are special tokens the
    # talker must not emit (HF suppresses vocab-1024..vocab except eos)
    suppress_band: int = 1024


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Snake(nn.Module):
    """SnakeBeta's per-channel ``alpha`` and ``beta`` (log scale)."""

    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.alpha = _param((c,), device, dtype)
        self.beta = _param((c,), device, dtype)


class _TConv(nn.Module):
    """A transposed convolution's ``w`` (C_in, C_out, K) and bias (C_out,)."""

    def __init__(self, c_in: int, c_out: int, k: int, device, dtype):
        super().__init__()
        self.w = _param((c_in, c_out, k), device, dtype)
        self.b = _param((c_out,), device, dtype)


class _Conv(nn.Module):
    """A convolution's ``w`` (C_out, C_in / groups, K) and bias (C_out,)."""

    def __init__(self, c_out: int, c_in: int, k: int, device, dtype):
        super().__init__()
        self.w = _param((c_out, c_in, k), device, dtype)
        self.b = _param((c_out,), device, dtype)


class C2WBlock(nn.Module):
    """A Code2Wav transformer layer: ``ln1``, ``qkv`` (q|k|v packed), ``o``,
    ``ln2``, the SwiGLU ``gate`` / ``up`` / ``down`` and the layer scales
    ``scale_attn`` / ``scale_mlp``."""

    def __init__(self, cfg: Code2WavConfig, device, dtype):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * hd
        self.ln1 = Norm(h, False, device, dtype)
        self.qkv = Q.Linear.empty(h, qkv, False, device, dtype)
        self.o = Q.Linear.empty(cfg.num_attention_heads * hd, h, False, device, dtype)
        self.ln2 = Norm(h, False, device, dtype)
        self.gate = Q.Linear.empty(h, cfg.intermediate_size, False, device, dtype)
        self.up = Q.Linear.empty(h, cfg.intermediate_size, False, device, dtype)
        self.down = Q.Linear.empty(cfg.intermediate_size, h, False, device, dtype)
        self.scale_attn = _param((h,), device, dtype)
        self.scale_mlp = _param((h,), device, dtype)


class Upsample(nn.Module):
    """One ``upsampling_ratios`` stage: ``tconv`` then a ConvNeXt block
    (``dw`` depthwise conv, ``norm`` LayerNorm, ``fc1`` / ``fc2``,
    ``gamma``)."""

    def __init__(self, h: int, factor: int, device, dtype):
        super().__init__()
        self.tconv = _TConv(h, h, factor, device, dtype)
        self.dw = _Conv(h, 1, 7, device, dtype)
        self.norm = Norm(h, True, device, dtype)
        self.fc1 = Q.Linear.empty(h, 4 * h, True, device, dtype)
        self.fc2 = Q.Linear.empty(4 * h, h, True, device, dtype)
        self.gamma = _param((h,), device, dtype)


class ResUnit(nn.Module):
    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.snake1 = Snake(c, device, dtype)
        self.conv1 = _Conv(c, c, 7, device, dtype)
        self.snake2 = Snake(c, device, dtype)
        self.conv2 = _Conv(c, c, 1, device, dtype)


class DecBlock(nn.Module):
    """A decoder block: ``snake``, ``tconv`` by 2 x its stride, then three
    residual units at dilations 1, 3 and 9."""

    def __init__(self, c_in: int, c_out: int, stride: int, device, dtype):
        super().__init__()
        self.snake = Snake(c_in, device, dtype)
        self.tconv = _TConv(c_in, c_out, 2 * stride, device, dtype)
        self.res_units = nn.ModuleList(ResUnit(c_out, device, dtype) for _ in range(3))


class Code2WavModel(nn.Module):
    """``code_embedding`` (num_quantizers * codebook_size, H), ``blocks`` and
    ``ln_final`` (the transformer), ``upsample``, ``dec_pre``,
    ``dec_blocks``, ``dec_snake`` and ``dec_post``."""

    def __init__(self, cfg: Code2WavConfig, device, dtype):
        super().__init__()
        h, dd = cfg.hidden_size, cfg.decoder_dim
        self.code_embedding = _param((cfg.num_quantizers * cfg.codebook_size, h), device,
                                     dtype)
        self.blocks = nn.ModuleList(C2WBlock(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.ln_final = Norm(h, False, device, dtype)
        self.upsample = nn.ModuleList(Upsample(h, f, device, dtype)
                                      for f in cfg.upsampling_ratios)
        self.dec_pre = _Conv(dd, h, 7, device, dtype)
        self.dec_blocks = nn.ModuleList(
            DecBlock(dd // 2 ** i, dd // 2 ** (i + 1), s, device, dtype)
            for i, s in enumerate(cfg.upsample_rates))
        out = dd // 2 ** len(cfg.upsample_rates)
        self.dec_snake = Snake(out, device, dtype)
        self.dec_post = _Conv(1, out, 7, device, dtype)


class ResizeMLP(nn.Module):
    """Qwen3OmniMoeTalkerResizeMLP: ``fc1`` (thinker width, F) and ``fc2``
    (F, talker width), both with biases."""

    def __init__(self, d_in: int, ff: int, d_out: int, device, dtype):
        super().__init__()
        self.fc1 = Q.Linear.empty(d_in, ff, True, device, dtype)
        self.fc2 = Q.Linear.empty(ff, d_out, True, device, dtype)


class Predictor(nn.Module):
    """The code predictor: ``decoder`` (its ``lm_head`` a (D, 1) stand-in, as
    in the JAX tree: the per-group heads run on its post-norm hidden),
    ``group_embeds`` and ``heads``, num_code_groups - 1 of each."""

    def __init__(self, cfg: TalkerConfig, device, dtype):
        super().__init__()
        pcfg, g = cfg.predictor, cfg.num_code_groups - 1
        self.decoder = dec.Decoder(pcfg, device, dtype)
        self.decoder.lm_head = _param((pcfg.d_model, 1), device, dtype)
        self.group_embeds = nn.ParameterList(_param((pcfg.vocab_size, pcfg.d_model), device,
                                                    dtype) for _ in range(g))
        self.heads = nn.ParameterList(_param((pcfg.d_model, pcfg.vocab_size), device, dtype)
                                      for _ in range(g))


class TalkerModel(nn.Module):
    """The talker's parameters: ``decoder`` (the MoE decoder with its codec
    head), ``predictor``, ``text_projection`` and ``hidden_projection``
    (``ResizeMLP``, width ``proj_ff`` inside: HF's talker text
    ``intermediate_size``)."""

    def __init__(self, cfg: TalkerConfig, proj_ff: int, device, dtype):
        super().__init__()
        d = cfg.text.d_model
        self.decoder = dec.Decoder(cfg.text, device, dtype)
        self.predictor = Predictor(cfg, device, dtype)
        self.text_projection = ResizeMLP(cfg.thinker_hidden_size, proj_ff, d, device, dtype)
        self.hidden_projection = ResizeMLP(cfg.thinker_hidden_size, proj_ff, d, device, dtype)


# ---------------------------------------------------------------------------
# Code2Wav
# ---------------------------------------------------------------------------

def _causal_conv1d(x, w, b, stride=1, dilation=1, groups=1):
    """HF Qwen3OmniMoeCausalConvNet: left 'causal' pad of (effective_kernel
    - stride) plus a right pad to a whole output frame. x: (B, C_in, T); w:
    (C_out, C_in / groups, K)."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    padding = k_eff - stride
    t = x.shape[-1]
    n_frames = (t - k_eff + padding) / stride + 1
    ideal = (int(np.ceil(n_frames)) - 1) * stride + (k_eff - padding)
    extra = ideal - t
    xp = F.pad(x, (padding, max(extra, 0)))
    return F.conv1d(xp, w, b, stride=stride, dilation=dilation, groups=groups)


def _causal_trans_conv1d(x, w, b, stride):
    """HF Qwen3OmniMoeCausalTransConvNet: ConvTranspose1d, then ceil(K -
    stride) samples trimmed from both ends. w: (C_in, C_out, K)."""
    out = F.conv_transpose1d(x, w, b, stride=stride)
    pad = int(np.ceil(w.shape[-1] - stride))
    return out[..., pad: out.shape[-1] - pad]


def _snake_beta(x, p: Snake, eps=1e-9):
    """x + 1/exp(beta) * sin^2(x * exp(alpha)), per channel."""
    a = torch.exp(p.alpha)[None, :, None]
    b = torch.exp(p.beta)[None, :, None]
    return x + (1.0 / (b + eps)) * torch.sin(x * a) ** 2


def _convnext_block(p: Upsample, x, eps=1e-6):
    """(B, C, T) ConvNeXt: depthwise causal conv -> LayerNorm -> MLP,
    layer-scaled, plus the residual."""
    h = _causal_conv1d(x, p.dw.w, p.dw.b, groups=x.shape[1])
    h = L.layer_norm(h.transpose(1, 2).contiguous(), p.norm.scale, p.norm.bias, eps)
    h = L.ACT_FNS["gelu"](Q.linear(h, p.fc1))
    h = Q.linear(h, p.fc2) * p.gamma
    return x + h.transpose(1, 2)


def _c2w_transformer(p: Code2WavModel, cfg: Code2WavConfig, x):
    """The causal transformer over (B, T, H) code embeddings: the flat
    attention with ``local_window`` = sliding_window (a row sees itself and
    the window - 1 rows before it, as the JAX package's mask)."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pos = torch.arange(x.shape[1], device=x.device)[None]
    cos, sin = dec.rope_cos_sin(
        dataclasses.replace(dec.DecoderConfig(), head_dim=hd, rope_theta=cfg.rope_theta,
                            mrope_section=None), pos)
    branch = None          # the layer-scaled MLP output, its add folded into the next norm
    for blk in p.blocks:
        x, h = L.add_rms_norm(x, branch, blk.ln1.scale, cfg.rms_norm_eps)
        pk = rope_pack(Q.linear(h, blk.qkv), cos, sin, nh + nkv, hd)
        a = attention_flat_packed(pk, nh, kv_heads=nkv, causal=True,
                                  local_window=cfg.sliding_window)
        x, h = L.add_rms_norm(x, Q.linear(a, blk.o) * blk.scale_attn, blk.ln2.scale,
                              cfg.rms_norm_eps)
        m = Q.mm(L.ACT_FNS[cfg.act](Q.mm(h, blk.gate)) * Q.mm(h, blk.up), blk.down)
        branch = m * blk.scale_mlp
    return L.add_rms_norm(x, branch, p.ln_final.scale, cfg.rms_norm_eps)[1]


def check_codes(codes, cfg: Code2WavConfig) -> None:
    """Raise unless ``codes`` (B, num_quantizers, T) holds ids of the
    codebooks: HF raises on another group count, and its embedding on an id
    past the table; the JAX package fails to broadcast, or clamps."""
    c = np.asarray(codes)
    if c.ndim != 3 or c.shape[1] != cfg.num_quantizers:
        raise ValueError(f"code2wav: expected (B, {cfg.num_quantizers}, T) codes "
                         f"(num_quantizers {cfg.num_quantizers}), got {c.shape}")
    if c.size and (c.min() < 0 or c.max() >= cfg.codebook_size):
        bad = int(c.min()) if c.min() < 0 else int(c.max())
        raise ValueError(f"code2wav: codec id {bad} is outside the codebook of "
                         f"{cfg.codebook_size} rows")


def code2wav(p: Code2WavModel, cfg: Code2WavConfig, codes) -> torch.Tensor:
    """codes: (B, num_quantizers, T) host ints -> waveform (B, 1, T *
    total_upsample) on the parameters' device, clamped to [-1, 1] (HF
    Qwen3OmniMoeCode2Wav.forward)."""
    check_codes(codes, cfg)
    dev = p.code_embedding.device
    offset = torch.arange(cfg.num_quantizers, device=dev)[None, :, None] * cfg.codebook_size
    ids = torch.as_tensor(np.asarray(codes), device=dev).long() + offset
    hidden = p.code_embedding[ids].mean(dim=1)                   # (B, T, H)
    hidden = _c2w_transformer(p, cfg, hidden).transpose(1, 2)    # (B, H, T)
    for up, factor in zip(p.upsample, cfg.upsampling_ratios):
        hidden = _causal_trans_conv1d(hidden, up.tconv.w, up.tconv.b, factor)
        hidden = _convnext_block(up, hidden)
    wav = _causal_conv1d(hidden, p.dec_pre.w, p.dec_pre.b)
    for blk, stride in zip(p.dec_blocks, cfg.upsample_rates):
        wav = _causal_trans_conv1d(_snake_beta(wav, blk.snake), blk.tconv.w, blk.tconv.b,
                                   stride)
        for ru, dilation in zip(blk.res_units, (1, 3, 9)):
            r = _causal_conv1d(_snake_beta(wav, ru.snake1), ru.conv1.w, ru.conv1.b,
                               dilation=dilation)
            r = _causal_conv1d(_snake_beta(r, ru.snake2), ru.conv2.w, ru.conv2.b)
            wav = wav + r
    wav = _causal_conv1d(_snake_beta(wav, p.dec_snake), p.dec_post.w, p.dec_post.b)
    return wav.clamp(-1.0, 1.0)


@torch.inference_mode()
def chunked_decode(p: Code2WavModel, cfg: Code2WavConfig, codes: np.ndarray,
                   chunk_size: int = 300, left_context_size: int = 25) -> np.ndarray:
    """HF chunked_decode: decode in chunks with left context, trim the
    context's samples from each chunk -> float32 numpy (B, 1, samples)."""
    codes = np.asarray(codes)
    wavs, start, t, up = [], 0, codes.shape[-1], cfg.total_upsample
    while start < t:
        end = min(start + chunk_size, t)
        ctx = left_context_size if start - left_context_size > 0 else start
        wav = code2wav(p, cfg, codes[..., start - ctx: end])
        wavs.append(wav.float().cpu().numpy()[..., ctx * up:])
        start = end
    return np.concatenate(wavs, axis=-1)


# ---------------------------------------------------------------------------
# Converters (HF state dict -> trees in the JAX layout)
# ---------------------------------------------------------------------------

def convert_code2wav(sd, cfg: Code2WavConfig, prefix: str = "code2wav.") -> dict:
    """HF Qwen3OmniMoeCode2Wav state dict -> the JAX package's tree, its
    leaves views of ``sd``'s tensors (linears transposed to (in, out))."""

    def J(name, transpose=False):
        t = t2np(sd[prefix + name])
        return t.t() if transpose else t

    def lin(name):
        b = f"{name}.bias"
        return {"w": J(f"{name}.weight", True), "b": J(b) if prefix + b in sd else None}

    def conv(name):
        return {"w": J(f"{name}.conv.weight"), "b": J(f"{name}.conv.bias")}

    def snake(name):
        return {"alpha": J(f"{name}.alpha"), "beta": J(f"{name}.beta")}

    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f"pre_transformer.layers.{i}"
        blocks.append({
            "ln1": {"scale": J(f"{b}.input_layernorm.weight")},
            "ln2": {"scale": J(f"{b}.post_attention_layernorm.weight")},
            "attn": {k: lin(f"{b}.self_attn.{k}_proj") for k in "qkvo"},
            "mlp": {k: lin(f"{b}.mlp.{k}_proj") for k in ("gate", "up", "down")},
            "scale_attn": J(f"{b}.self_attn_layer_scale.scale"),
            "scale_mlp": J(f"{b}.mlp_layer_scale.scale"),
        })
    upsample = [{
        "factor": int(factor),
        "tconv": conv(f"upsample.{i}.0"),
        "convnext": {
            "dw": conv(f"upsample.{i}.1.dwconv"),
            "norm": {"scale": J(f"upsample.{i}.1.norm.weight"),
                     "bias": J(f"upsample.{i}.1.norm.bias")},
            "fc1": lin(f"upsample.{i}.1.pwconv1"),
            "fc2": lin(f"upsample.{i}.1.pwconv2"),
            "gamma": J(f"upsample.{i}.1.gamma"),
        }} for i, factor in enumerate(cfg.upsampling_ratios)]
    dec_blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        b = f"decoder.{i + 1}.block"
        dec_blocks.append({
            "stride": int(rate),
            "snake": snake(f"{b}.0"),
            "tconv": conv(f"{b}.1"),
            "res_units": [{"dilation": dilation,
                           "snake1": snake(f"{b}.{j + 2}.act1"),
                           "conv1": conv(f"{b}.{j + 2}.conv1"),
                           "snake2": snake(f"{b}.{j + 2}.act2"),
                           "conv2": conv(f"{b}.{j + 2}.conv2")}
                          for j, dilation in enumerate((1, 3, 9))],
        })
    n_dec = len(cfg.upsample_rates)
    return {
        "code_embedding": J("code_embedding.weight"),
        "pre_transformer": {"blocks": blocks,
                            "ln_final": {"scale": J("pre_transformer.norm.weight")}},
        "upsample": upsample,
        "dec_pre": conv("decoder.0"),
        "dec_blocks": dec_blocks,
        "dec_snake": snake(f"decoder.{n_dec + 1}"),
        "dec_post": conv(f"decoder.{n_dec + 2}"),
    }


class _LazyLayers(Sequence):
    """A stack's layers converted as they are read, and not kept: a
    converted talker holds one layer's stacked experts at a time."""

    def __init__(self, n: int, convert):
        self.n, self.convert = n, convert

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.convert(i)


def convert_talker(sd: Mapping, cfg: TalkerConfig, prefix: str = "talker.") -> dict:
    """HF Qwen3OmniMoeTalkerForConditionalGeneration state dict -> the JAX
    package's tree: ``decoder`` (codec embedding, MoE layers with the
    experts stacked into gate_up (E, H, 2I) and down (E, I, H), the shared
    expert and its gate, the codec head), ``predictor`` (the dense decoder
    with a (D, 1) zero head, per-group embeddings and heads) and the two
    projections. The MoE and predictor layers are converted as the tree is
    read (``_LazyLayers``), so a caller that loads them one at a time holds
    one layer's stacked experts at a time."""

    def J(name, transpose=False):
        t = t2np(sd[prefix + name])
        return t.t() if transpose else t

    def attn(b):
        out = {k: {"w": J(f"{b}.self_attn.{k}_proj.weight", True), "b": None} for k in "qkvo"}
        out["q_norm"] = {"scale": J(f"{b}.self_attn.q_norm.weight")}
        out["k_norm"] = {"scale": J(f"{b}.self_attn.k_norm.weight")}
        return out

    def talker_layer(i):
        b = f"model.layers.{i}"
        ex = [f"{b}.mlp.experts.{e}" for e in range(cfg.text.num_experts)]
        return {
            "ln1": {"scale": J(f"{b}.input_layernorm.weight")},
            "ln2": {"scale": J(f"{b}.post_attention_layernorm.weight")},
            "attn": attn(b),
            "mlp": {"moe": {
                "router": {"w": J(f"{b}.mlp.gate.weight", True)},
                "gate_up": torch.stack([torch.cat([J(f"{e}.gate_proj.weight", True),
                                                   J(f"{e}.up_proj.weight", True)], dim=1)
                                        for e in ex]),
                "down": torch.stack([J(f"{e}.down_proj.weight", True) for e in ex]),
                "shared": {k: {"w": J(f"{b}.mlp.shared_expert.{k}_proj.weight", True)}
                           for k in ("gate", "up", "down")},
                "shared_gate": {"w": J(f"{b}.mlp.shared_expert_gate.weight", True)},
            }},
        }

    def predictor_layer(i):
        b = f"code_predictor.model.layers.{i}"
        return {
            "ln1": {"scale": J(f"{b}.input_layernorm.weight")},
            "ln2": {"scale": J(f"{b}.post_attention_layernorm.weight")},
            "attn": attn(b),
            "mlp": {k: {"w": J(f"{b}.mlp.{k}_proj.weight", True), "b": None}
                    for k in ("gate", "up", "down")},
        }

    norm = J("code_predictor.model.norm.weight")
    groups = range(cfg.num_code_groups - 1)

    def mlp2(name):
        return {f"fc{i}": {"w": J(f"{name}.linear_fc{i}.weight", True),
                           "b": J(f"{name}.linear_fc{i}.bias")} for i in (1, 2)}

    return {
        "decoder": {"embed": J("model.codec_embedding.weight"),
                    "blocks": _LazyLayers(cfg.text.layers, talker_layer),
                    "ln_final": {"scale": J("model.norm.weight")},
                    "lm_head": J("codec_head.weight", True)},
        "predictor": {
            "group_embeds": [J(f"code_predictor.model.codec_embedding.{g}.weight")
                             for g in groups],
            "decoder": {"embed": J("code_predictor.model.codec_embedding.0.weight"),
                        "blocks": _LazyLayers(cfg.predictor.layers, predictor_layer),
                        "ln_final": {"scale": norm},
                        "lm_head": torch.zeros((norm.shape[0], 1), dtype=norm.dtype,
                                               device=norm.device)},
            "heads": [J(f"code_predictor.lm_head.{g}.weight", True) for g in groups],
        },
        "text_projection": mlp2("text_projection"),
        "hidden_projection": mlp2("hidden_projection"),
    }


# ---------------------------------------------------------------------------
# HF layouts and random weights in them
# ---------------------------------------------------------------------------

def hf_talker_layout(cfg: TalkerConfig, proj_ff: int = 2048) -> dict:
    """The tensors of an HF talker state dict that ``convert_talker`` reads
    (without the ``talker.`` prefix): key -> (shape, init), init ("normal",
    std) or ("const", value). The random weights of ``init_talker``: linears
    N(0, 1/d_in), embeddings N(0, 1), norms ones. ``proj_ff``: the
    projections' inner width (HF's talker text ``intermediate_size``, 2048
    in its defaults)."""
    t, pc = cfg.text, cfg.predictor
    out = {}

    def lin(name, d_in, d_out):
        out[f"{name}.weight"] = ((d_out, d_in), ("normal", d_in ** -0.5))

    def norm(name, d):
        out[f"{name}.weight"] = ((d,), ("const", 1.0))

    def layer(b, c, mlp):
        lin(f"{b}.self_attn.q_proj", c.d_model, c.heads * c.head_dim)
        lin(f"{b}.self_attn.k_proj", c.d_model, c.kv_heads * c.head_dim)
        lin(f"{b}.self_attn.v_proj", c.d_model, c.kv_heads * c.head_dim)
        lin(f"{b}.self_attn.o_proj", c.heads * c.head_dim, c.d_model)
        norm(f"{b}.self_attn.q_norm", c.head_dim)
        norm(f"{b}.self_attn.k_norm", c.head_dim)
        norm(f"{b}.input_layernorm", c.d_model)
        norm(f"{b}.post_attention_layernorm", c.d_model)
        for name, ff in mlp:
            lin(f"{b}.{name}.gate_proj", c.d_model, ff)
            lin(f"{b}.{name}.up_proj", c.d_model, ff)
            lin(f"{b}.{name}.down_proj", ff, c.d_model)

    out["model.codec_embedding.weight"] = ((t.vocab_size, t.d_model), ("normal", 1.0))
    for i in range(t.layers):
        b = f"model.layers.{i}"
        layer(b, t, [(f"mlp.experts.{e}", t.moe_d_ff) for e in range(t.num_experts)]
              + [("mlp.shared_expert", t.moe_shared_ff)])
        lin(f"{b}.mlp.gate", t.d_model, t.num_experts)
        lin(f"{b}.mlp.shared_expert_gate", t.d_model, 1)
    norm("model.norm", t.d_model)
    lin("codec_head", t.d_model, t.vocab_size)
    for g in range(cfg.num_code_groups - 1):
        out[f"code_predictor.model.codec_embedding.{g}.weight"] = (
            (pc.vocab_size, pc.d_model), ("normal", 1.0))
        lin(f"code_predictor.lm_head.{g}", pc.d_model, pc.vocab_size)
    for i in range(pc.layers):
        layer(f"code_predictor.model.layers.{i}", pc, [("mlp", pc.d_ff)])
    norm("code_predictor.model.norm", pc.d_model)
    for name in ("text_projection", "hidden_projection"):
        lin(f"{name}.linear_fc1", cfg.thinker_hidden_size, proj_ff)
        lin(f"{name}.linear_fc2", proj_ff, t.d_model)
        out[f"{name}.linear_fc1.bias"] = ((proj_ff,), ("const", 0.0))
        out[f"{name}.linear_fc2.bias"] = ((t.d_model,), ("const", 0.0))
    return out


def hf_code2wav_layout(cfg: Code2WavConfig) -> dict:
    """The tensors of an HF Code2Wav state dict that ``convert_code2wav``
    reads (without the ``code2wav.`` prefix), as ``hf_talker_layout``: the
    random weights of ``init_code2wav``: convolutions and linears N(0,
    1/fan_in) (a transposed convolution's fan-in C_in * K / stride), zero
    biases, embeddings N(0, 1), norms ones, the transformer's layer scales
    ``layer_scale_initial_scale`` (HF's), the ConvNeXt gamma 0.1 (HF's 1e-6
    would leave the block's branch out) and SnakeBeta's log-scale alpha and
    beta zeros (HF's). Two gains keep the waveform inside the clamp: each
    residual unit's second convolution x 0.3 (at unit gain every unit grows
    the signal 1.4x, 90x over the twelve) and the output convolution x
    0.1."""
    h, hd, dd = cfg.hidden_size, cfg.head_dim, cfg.decoder_dim
    nh, nkv, ff = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    out = {"code_embedding.weight": ((cfg.num_quantizers * cfg.codebook_size, h),
                                     ("normal", 1.0))}

    def const(name, shape, v):
        out[name] = (shape, ("const", v))

    def lin(name, d_in, d_out, bias=False):
        out[f"{name}.weight"] = ((d_out, d_in), ("normal", d_in ** -0.5))
        if bias:
            const(f"{name}.bias", (d_out,), 0.0)

    def conv(name, c_out, c_in, k, groups=1, gain=1.0):
        out[f"{name}.conv.weight"] = ((c_out, c_in // groups, k),
                                      ("normal", gain * (c_in // groups * k) ** -0.5))
        const(f"{name}.conv.bias", (c_out,), 0.0)

    def tconv(name, c_in, c_out, k, stride):
        out[f"{name}.conv.weight"] = ((c_in, c_out, k), ("normal", (c_in * k / stride) ** -0.5))
        const(f"{name}.conv.bias", (c_out,), 0.0)

    def snake(name, c):
        const(f"{name}.alpha", (c,), 0.0)
        const(f"{name}.beta", (c,), 0.0)

    for i in range(cfg.num_hidden_layers):
        b = f"pre_transformer.layers.{i}"
        const(f"{b}.input_layernorm.weight", (h,), 1.0)
        const(f"{b}.post_attention_layernorm.weight", (h,), 1.0)
        lin(f"{b}.self_attn.q_proj", h, nh * hd)
        lin(f"{b}.self_attn.k_proj", h, nkv * hd)
        lin(f"{b}.self_attn.v_proj", h, nkv * hd)
        lin(f"{b}.self_attn.o_proj", nh * hd, h)
        lin(f"{b}.mlp.gate_proj", h, ff)
        lin(f"{b}.mlp.up_proj", h, ff)
        lin(f"{b}.mlp.down_proj", ff, h)
        const(f"{b}.self_attn_layer_scale.scale", (h,), cfg.layer_scale_initial_scale)
        const(f"{b}.mlp_layer_scale.scale", (h,), cfg.layer_scale_initial_scale)
    const("pre_transformer.norm.weight", (h,), 1.0)
    for i, factor in enumerate(cfg.upsampling_ratios):
        b = f"upsample.{i}"
        tconv(f"{b}.0", h, h, factor, factor)
        conv(f"{b}.1.dwconv", h, h, 7, groups=h)
        const(f"{b}.1.norm.weight", (h,), 1.0)
        const(f"{b}.1.norm.bias", (h,), 0.0)
        lin(f"{b}.1.pwconv1", h, 4 * h, bias=True)
        lin(f"{b}.1.pwconv2", 4 * h, h, bias=True)
        const(f"{b}.1.gamma", (h,), 0.1)
    conv("decoder.0", dd, h, 7)
    for i, rate in enumerate(cfg.upsample_rates):
        b, c_in, c_out = f"decoder.{i + 1}.block", dd // 2 ** i, dd // 2 ** (i + 1)
        snake(f"{b}.0", c_in)
        tconv(f"{b}.1", c_in, c_out, 2 * rate, rate)
        for j in range(3):
            snake(f"{b}.{j + 2}.act1", c_out)
            conv(f"{b}.{j + 2}.conv1", c_out, c_out, 7)
            snake(f"{b}.{j + 2}.act2", c_out)
            conv(f"{b}.{j + 2}.conv2", c_out, c_out, 1, gain=0.3)
    n_dec, c_last = len(cfg.upsample_rates), dd // 2 ** len(cfg.upsample_rates)
    snake(f"decoder.{n_dec + 1}", c_last)
    conv(f"decoder.{n_dec + 2}", 1, c_last, 7, gain=0.1)
    return out


class SeededState(Mapping):
    """A state dict whose tensors are drawn when read, from ``seed`` and the
    key (a CRC of its name), on ``device`` in ``dtype``, and not kept: the
    random weights of a layout (``hf_talker_layout``, ``hf_code2wav_layout``)
    under ``prefix``, with no second copy of the model ever held."""

    def __init__(self, layout: dict, seed: int, device, dtype, prefix: str = ""):
        self.layout = {prefix + k: v for k, v in layout.items()}
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype

    def __getitem__(self, key):
        shape, (kind, v) = self.layout[key]
        if kind == "const":
            return torch.full(shape, v, device=self.device, dtype=self.dtype)
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + zlib.crc32(key.encode()))
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        return (x * v).to(self.dtype)

    def __iter__(self):
        return iter(self.layout)

    def __len__(self) -> int:
        return len(self.layout)


@torch.no_grad()
def init_talker(cfg: TalkerConfig, seed: int, device, dtype=torch.float32,
                proj_ff: int = 2048) -> TalkerModel:
    """Random talker weights drawn in HF's layout (``hf_talker_layout``) and
    carried through ``convert_talker`` and ``bridge.talker_from_numpy``
    layer by layer, on ``device``."""
    from ..bridge import talker_from_numpy

    sd = SeededState(hf_talker_layout(cfg, proj_ff), seed, device, dtype, "talker.")
    return talker_from_numpy(convert_talker(sd, cfg), cfg, device, dtype)


@torch.no_grad()
def init_code2wav(cfg: Code2WavConfig, seed: int, device,
                  dtype=torch.float32) -> Code2WavModel:
    """Random Code2Wav weights drawn in HF's layout (``hf_code2wav_layout``)
    and carried through ``convert_code2wav`` and the bridge, on ``device``."""
    from ..bridge import code2wav_from_numpy

    sd = SeededState(hf_code2wav_layout(cfg), seed, device, dtype, "code2wav.")
    return code2wav_from_numpy(convert_code2wav(sd, cfg), cfg, device, dtype)


def resize_mlp(p: ResizeMLP, x, act: str = "silu"):
    """Qwen3OmniMoeTalkerResizeMLP: fc2(act(fc1(x)))."""
    return Q.linear(L.ACT_FNS[act](Q.linear(x, p.fc1)), p.fc2)


# ---------------------------------------------------------------------------
# Sampling (HF logits-processor semantics; the JAX package's, copied)
# ---------------------------------------------------------------------------

def sample_logits(logits: np.ndarray, rng, do_sample: bool,
                  top_k: int = 50, top_p: float = 1.0,
                  temperature: float = 1.0, prev_ids=(),
                  repetition_penalty: float = 1.0,
                  suppress=()) -> int:
    """One HF-generation-style sampling step over (V,) fp32 logits."""
    lg = np.asarray(logits, np.float32).copy()
    if repetition_penalty != 1.0 and len(prev_ids):
        ids = np.asarray(sorted(set(int(i) for i in prev_ids)))
        sel = lg[ids]
        lg[ids] = np.where(sel > 0, sel / repetition_penalty,
                           sel * repetition_penalty)
    if len(suppress):
        lg[np.asarray(list(suppress))] = -np.inf
    if not do_sample:
        return int(np.argmax(lg))
    if temperature != 1.0:
        lg = lg / temperature
    if top_k and top_k < lg.shape[-1]:
        kth = np.partition(lg, -top_k)[-top_k]
        lg = np.where(lg < kth, -np.inf, lg)
    if top_p < 1.0:
        order = np.argsort(lg)[::-1]
        p = np.exp(lg[order] - np.max(lg))
        p = p / p.sum()
        cum = np.cumsum(p)
        cut = int(np.searchsorted(cum, top_p) + 1)
        mask = np.full_like(lg, -np.inf)
        mask[order[:cut]] = lg[order[:cut]]
        lg = mask
    p = np.exp(lg - np.max(lg))
    p = p / p.sum()
    return int(rng.choice(lg.shape[-1], p=p))


# ---------------------------------------------------------------------------
# Speech generation (thinker outputs -> codes)
# ---------------------------------------------------------------------------

def table_rows(table: torch.Tensor, ids, what: str) -> torch.Tensor:
    """Rows ``ids`` (host ints, any shape) of ``table`` (V, D), checked on the
    host: an id outside the table raises a ``ValueError`` naming it and the
    table's size (the JAX gathers clamp it to the last row)."""
    ids = np.asarray(ids, np.int64)
    bad = ids[(ids < 0) | (ids >= table.shape[0])]
    if bad.size:
        raise ValueError(f"{what}: id {int(bad[0])} is outside the table of "
                         f"{table.shape[0]} rows")
    return table[torch.as_tensor(ids, device=table.device)]


def build_talker_inputs(cfg: TalkerConfig, params: TalkerModel, thinker_ids: np.ndarray,
                        thinker_embed, thinker_hidden, multimodal_mask,
                        thinker_embed_table, speaker: str, prompt_len: int):
    """Segment the thinker sequence by <|im_start|> roles and assemble the
    talker prefill (HF generate :100-160 and its two ``_get_talker_*``
    helpers).

    thinker_ids: (T,) the whole sequence (prompt + generated) on the host;
    thinker_embed / thinker_hidden: (1, T, D_th) layer-0 / accept-layer
    hiddens on the talker's device; multimodal_mask: (T,) bool. Returns
    (embeds (1, L, D), talker_input_ids (1, L) host, trailing_text_hidden,
    tts_pad_embed).
    """
    speaker_id = dict(cfg.speaker_id).get(speaker.lower())
    if speaker_id is None:
        raise NotImplementedError(f"Speaker {speaker} not implemented")
    dtype = params.decoder.embed.dtype
    thinker_embed, thinker_hidden = thinker_embed.to(dtype), thinker_hidden.to(dtype)
    tts_ids = [[cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id]]
    tts = resize_mlp(params.text_projection,
                     table_rows(thinker_embed_table, tts_ids, "thinker embedding").to(dtype))
    tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]

    im_starts = np.flatnonzero(np.asarray(thinker_ids[:prompt_len]) == cfg.im_start_token_id)
    bounds = np.concatenate([im_starts, [len(thinker_ids)]])
    embeds, ids_out, trailing = [], [], None
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        role = int(thinker_ids[lo + 1])
        if role == cfg.user_token_id:
            mm = np.asarray(multimodal_mask[lo:hi], bool)
            part = resize_mlp(params.text_projection, thinker_embed[:, lo:hi])
            if mm.any():
                mm_part = resize_mlp(params.hidden_projection, thinker_hidden[:, lo:hi])
                part = torch.where(torch.as_tensor(mm, device=part.device)[None, :, None],
                                   mm_part, part)
            embeds.append(part)
            ids_out.append(np.asarray(thinker_ids[lo:hi]))
        elif role == cfg.assistant_token_id and i == len(bounds) - 2:
            ah = resize_mlp(params.text_projection, thinker_embed[:, lo:hi])
            text_hidden = torch.cat([ah[:, :3], tts_pad.expand(1, 4, -1), tts_bos,
                                     ah[:, 3:4]], dim=1)
            codec = table_rows(params.decoder.embed,
                               [[cfg.codec_nothink_id, cfg.codec_think_bos_id,
                                 cfg.codec_think_eos_id, speaker_id, cfg.codec_pad_id,
                                 cfg.codec_bos_id]], "talker codec embedding")
            codec_hidden = torch.cat([torch.zeros_like(codec[:, :3]), codec], dim=1)
            trailing = torch.cat([ah[:, 4:], tts_eos], dim=1)
            embeds.append(text_hidden + codec_hidden)
            ids_out.append(np.full((text_hidden.shape[1],), cfg.tts_pad_token_id, np.int64))
        # system turns and earlier assistant turns are left out (as HF)
    return torch.cat(embeds, dim=1), np.concatenate(ids_out)[None], trailing, tts_pad


class TalkerSession:
    """Talker and code-predictor generation over the port's in-place KV
    cache for one ``TalkerConfig``.

    A frame: one talker step gives the first codebook token; the code
    predictor, prefilled with the talker's post-norm hidden of that step
    and the token's codec embedding, fills the other groups one cached step
    each; the talker's next input is the sum of the frame's group
    embeddings and the next trailing text row (tts-pad once the text is
    spent). Sampling runs on the host over each step's fp32 logits, so one
    ``np.random.Generator`` draws the JAX package's tokens.
    """

    def __init__(self, cfg: TalkerConfig, params: TalkerModel):
        self.cfg = cfg
        self.params = params

    def _valid(self, n_valid: int, max_len: int, device) -> torch.Tensor:
        valid = torch.zeros((1, max_len), dtype=torch.bool, device=device)
        valid[0, :n_valid] = True
        return valid

    def predictor_prefill(self, embeds, valid, cache):
        """The predictor over (1, 2, D) [talker hidden, codec embedding] ->
        (head-0 logits (V,) fp32 on the device, cache)."""
        pred = self.params.predictor
        _, cache, hidden = dec.forward(pred.decoder, self.cfg.predictor, embeds,
                                       torch.arange(2, device=embeds.device)[None], valid,
                                       cache=cache, cache_pos=0, want_hidden=True)
        return (hidden[0, -1] @ pred.heads[0]).float(), cache

    def predictor_step(self, emb, gs: int, valid, cache):
        """One cached predictor step on group ``gs``'s embedding (1, 1, D) at
        slot 1 + gs -> (head-gs logits (V,) fp32 on the device, cache)."""
        pred = self.params.predictor
        cpos = 1 + gs
        valid[0, cpos] = True
        _, cache, hidden = dec.forward(pred.decoder, self.cfg.predictor, emb,
                                       torch.full((1, 1), cpos, device=emb.device), valid,
                                       cache=cache, cache_pos=cpos, want_hidden=True)
        return (hidden[0, -1] @ pred.heads[gs]).float(), cache

    @torch.inference_mode()
    def predict_residuals(self, past_hidden, last_id_hidden, rng,
                          do_sample: bool = True, top_k: int = 50, top_p: float = 0.8):
        """The num_code_groups - 1 residual tokens of one frame (HF
        prepare_inputs_for_generation's inner generate: a prefill on
        [past_hidden, codec_embed(first code)], per-group embeddings and
        heads) -> (tokens, their (1, 1, D) embeddings)."""
        pred = self.params.predictor
        g = self.cfg.num_code_groups - 1
        embeds = torch.cat([past_hidden, last_id_hidden], dim=1).to(pred.group_embeds[0].dtype)
        dev = embeds.device
        cache = dec.init_cache(self.cfg.predictor, 1, g + 1, dtype=embeds.dtype, device=dev)
        valid = self._valid(2, g + 1, dev)
        lg, cache = self.predictor_prefill(embeds, valid, cache)
        toks, embeds_out = [], []
        for gs in range(1, g + 1):
            tok = sample_logits(lg.cpu().numpy(), rng, do_sample, top_k, top_p)
            toks.append(tok)
            emb = table_rows(pred.group_embeds[gs - 1], [[tok]], "predictor codec embedding")
            embeds_out.append(emb)
            if gs == g:
                break
            lg, cache = self.predictor_step(emb.to(embeds.dtype), gs, valid, cache)
        return toks, embeds_out

    def talker_prefill(self, talker_embeds, pos, max_len: int):
        """The talker prompt (1, n, D) into a new cache -> (last row's logits
        (V,) fp32, cache, its post-norm hidden (1, 1, D), validity)."""
        n = talker_embeds.shape[1]
        dev = talker_embeds.device
        cache = dec.init_cache(self.cfg.text, 1, max_len, dtype=talker_embeds.dtype, device=dev)
        valid = self._valid(n, max_len, dev)
        logits, cache, hidden = dec.forward(
            self.params.decoder, self.cfg.text, talker_embeds, pos, valid,
            logit_positions=torch.full((1, 1), n - 1, device=dev), cache=cache,
            cache_pos=0, want_hidden=True)
        return logits[0, 0], cache, hidden[:, n - 1:n], valid

    def talker_step(self, emb, cpos: int, position: int, ndim: int, valid, cache):
        """One cached talker step at slot ``cpos``, rope position
        ``position`` -> (logits (V,) fp32, cache, post-norm hidden (1, 1, D))."""
        valid[0, cpos] = True
        shape = (3, 1, 1) if ndim == 3 else (1, 1)
        logits, cache, hidden = dec.forward(
            self.params.decoder, self.cfg.text, emb,
            torch.full(shape, position, device=emb.device), valid, cache=cache,
            cache_pos=cpos, want_hidden=True)
        return logits[0, 0], cache, hidden[:, 0:1]

    @torch.inference_mode()
    def generate_codes(self, talker_embeds, talker_pos, trailing, tts_pad,
                       max_new_tokens: int = 4096, do_sample: bool = True,
                       top_k: int = 50, top_p: float = 1.0,
                       temperature: float = 0.9,
                       repetition_penalty: float = 1.05, rng=None,
                       predictor_do_sample: bool = True) -> np.ndarray:
        """Autoregressive codec generation -> (num_code_groups, frames) int64.

        talker_embeds (1, n, D) on the device; talker_pos (1, n) or (3, 1, n)
        host ints; trailing (1, m, D) and tts_pad (1, 1, D) from
        ``build_talker_inputs``."""
        if rng is None:
            rng = np.random.default_rng()
        cfg, params = self.cfg, self.params
        dtype = params.decoder.embed.dtype
        talker_embeds = talker_embeds.to(dtype)
        vocab = cfg.text.vocab_size     # the top band is special ids, eos aside
        suppress = [i for i in range(max(vocab - cfg.suppress_band, 0), vocab)
                    if i != cfg.codec_eos_token_id]
        pos_np = np.asarray(talker_pos)
        n = talker_embeds.shape[1]
        last_pos = int(pos_np[:, 0, n - 1].max()) if pos_np.ndim == 3 else int(pos_np[0, n - 1])
        lg, cache, hid, valid = self.talker_prefill(
            talker_embeds, torch.as_tensor(pos_np, device=talker_embeds.device),
            n + max_new_tokens)
        gen, frames = [], []
        for t in range(max_new_tokens):
            tok = sample_logits(lg.cpu().numpy(), rng, do_sample, top_k, top_p, temperature,
                                prev_ids=gen, repetition_penalty=repetition_penalty,
                                suppress=suppress)
            gen.append(tok)
            if tok == cfg.codec_eos_token_id:
                break
            last_id_hidden = table_rows(params.decoder.embed, [[tok]], "talker codec embedding")
            residuals, resid_embeds = self.predict_residuals(hid, last_id_hidden, rng,
                                                             do_sample=predictor_do_sample)
            frames.append([tok] + residuals)
            emb = last_id_hidden
            for e in resid_embeds:
                emb = emb + e
            emb = emb + (trailing[:, t:t + 1] if t < trailing.shape[1] else tts_pad)
            lg, cache, hid = self.talker_step(emb.to(dtype), n + t, last_pos + 1 + t,
                                              pos_np.ndim, valid, cache)
        if not frames:
            return np.zeros((cfg.num_code_groups, 0), np.int64)
        return np.asarray(frames, np.int64).T
