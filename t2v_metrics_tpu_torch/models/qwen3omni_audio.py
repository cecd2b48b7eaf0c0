"""Qwen3-Omni audio encoder in PyTorch (port of
t2v_metrics_tpu/models/qwen3omni_audio.py): the Whisper-style log-mel and
the windowed audio tower of the Qwen3-Omni thinker.

  * ``log_mel_device``: reflect pad, framing, the DFT of each Hann frame as
    two matmuls, power, the Slaney mel projection, log10, the max - 8 clamp
    and (x + 4) / 4, in float64 on the audio's device (the spectrum's small
    bins cancel below fp32's reach; the JAX package computes in fp32 at
    HIGHEST precision for the same reason). The filterbank is the port's own
    numpy copy of ``transformers.audio_utils.mel_filter_bank`` (Slaney scale
    and norm), so no ``transformers`` is needed;
  * the tower: 128-bin mel chunks of 2 * ``n_window`` frames through three
    stride-2 3x3 convs with exact GELU (``F.conv2d`` in the weight dtype),
    a linear to d_model and sinusoid positions per chunk; pre-LN blocks
    (``models/clip.py:Block``: q|k|v packed into one GEMM, LayerNorm and
    add + LN through ``ops/norms.py``) whose attention is block-diagonal over
    windows of ``n_window_infer`` mel frames: the flat kernel with segment
    ids, invalid slots under segment -1 (``audio_geometry``, copied from the
    JAX module); then ln_post, proj1, exact GELU and proj2.
  * ``encode_audios`` runs the distinct audios of a call through one tower
    call: their chunks side by side, each audio's windows under ids of its
    own. The attention is block-diagonal, so each audio's valid rows are
    what it gives alone.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from .clip import Block, Norm, init_blocks_, init_norm_, normal_, pre_ln_block


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    d_model: int = 1280
    layers: int = 32
    heads: int = 20
    ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    n_window: int = 100
    n_window_infer: int = 400
    downsample_hidden: int = 480
    output_dim: int = 3584

    @property
    def chunk_frames(self) -> int:
        return self.n_window * 2

    @property
    def chunk_tokens(self) -> int:
        return _after_cnn(self.chunk_frames)

    @property
    def freq_after(self) -> int:
        return _after_cnn(self.num_mel_bins)


def _after_cnn(n: int) -> int:
    for _ in range(3):
        n = (n - 1) // 2 + 1
    return n


def audio_geometry(feature_len: int, cfg: AudioEncoderConfig):
    """Host geometry for one audio: chunk lengths, per-slot validity and
    window segment ids (HF forward :716-760 semantics)."""
    cf = cfg.chunk_frames
    num_chunks = -(-feature_len // cf)
    chunk_lens = [cf] * num_chunks
    tail = feature_len % cf
    if tail:
        chunk_lens[-1] = tail
    ct = cfg.chunk_tokens
    valid = np.zeros((num_chunks, ct), bool)
    for i, n in enumerate(chunk_lens):
        valid[i, :_after_cnn(n)] = True
    total_valid = int(valid.sum())
    # window grouping over valid ranks: window = padded chunk_tokens *
    # (n_window_infer / chunk_frames)
    window = ct * (cfg.n_window_infer // cf)
    ranks = np.cumsum(valid.reshape(-1)) - 1
    seg = np.where(valid.reshape(-1), ranks // window, -1).astype(np.int32)
    return chunk_lens, valid, seg, total_valid


# ---------------------------------------------------------------------------
# Log-mel
# ---------------------------------------------------------------------------

def _hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    return np.where(log_region, 15.0 + np.log(np.maximum(freq, 1e-30) / 1000.0)
                    * (27.0 / np.log(6.4)), mels)


def _mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)), freq)


@functools.lru_cache(maxsize=8)
def mel_filters(n_fft: int, n_mels: int, sr: int) -> np.ndarray:
    """(1 + n_fft/2, n_mels) float64 Slaney-scale, Slaney-norm triangular
    filterbank from 0 Hz to sr/2: ``transformers.audio_utils.mel_filter_bank
    (norm="slaney", mel_scale="slaney")``, which WhisperFeatureExtractor
    uses."""
    mel_freqs = np.linspace(_hertz_to_mel(0.0), _hertz_to_mel(sr / 2.0), n_mels + 2)
    filter_freqs = _mel_to_hertz(mel_freqs)
    fft_freqs = np.linspace(0, sr // 2, 1 + n_fft // 2)
    diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb * (2.0 / (filter_freqs[2:n_mels + 2] - filter_freqs[:n_mels]))[None, :]


@functools.lru_cache(maxsize=8)
def _dft_mats(n_fft: int) -> np.ndarray:
    """(n_fft, 2 * (1 + n_fft/2)) float64: the periodic-Hann-windowed cos and
    -sin of the real DFT, side by side."""
    win = np.hanning(n_fft + 1)[:-1]
    phase = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(1 + n_fft // 2)) / n_fft
    return np.concatenate([np.cos(phase) * win[:, None], -np.sin(phase) * win[:, None]], 1)


def log_mel_device(audio, n_mels: int = 128, n_fft: int = 400, hop: int = 160,
                   sr: int = 16000, device="cpu") -> torch.Tensor:
    """Whisper-style log-mel of a mono 16 kHz waveform -> (n_mels, frames - 1)
    fp32 on ``device``. Parity target: WhisperFeatureExtractor (center=True
    reflect pad, power 2.0, log10 with a 1e-10 floor, max - 8 clamp, (x + 4) /
    4), in float64 on ``device``. Clips of ``n_fft/2`` samples or fewer
    have no reflect pad and raise, as WhisperFeatureExtractor does (the JAX
    adapter's mel for clips under ``n_fft`` samples)."""
    pad = n_fft // 2
    if len(audio) <= pad:
        raise ValueError(f"log_mel_device: {len(audio)} samples are too few for the "
                         f"reflect pad of {pad}")
    x = torch.from_numpy(np.asarray(audio, np.float32)).to(device).double()
    x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop)                     # (1 + len/hop, n_fft)
    spec = frames @ torch.from_numpy(_dft_mats(n_fft)).to(x.device)
    nb = 1 + n_fft // 2
    power = spec[:, :nb] ** 2 + spec[:, nb:] ** 2
    mel = power @ torch.from_numpy(mel_filters(n_fft, n_mels, sr)).to(x.device)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))[:-1]   # drop the last frame
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).T.float()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def sinusoid_positions(length: int, channels: int, max_timescale=10000.0) -> np.ndarray:
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class AudioEncoder(nn.Module):
    """The tower's parameters: three convs (OIHW), ``conv_out`` (C*F,
    d_model) without bias, pre-LN blocks, ln_post, proj1, proj2."""

    def __init__(self, cfg: AudioEncoderConfig, device, dtype):
        super().__init__()
        dh, d = cfg.downsample_hidden, cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.conv_w = nn.ParameterList([param(dh, 1, 3, 3), param(dh, dh, 3, 3),
                                        param(dh, dh, 3, 3)])
        self.conv_b = nn.ParameterList([param(dh) for _ in range(3)])
        self.conv_out = param(dh * cfg.freq_after, d)
        self.blocks = nn.ModuleList(Block(d, cfg.ffn_dim, cfg.heads, device, dtype)
                                    for _ in range(cfg.layers))
        self.ln_post = Norm(d, True, device, dtype)
        self.proj1 = Q.Linear.empty(d, d, True, device, dtype)
        self.proj2 = Q.Linear.empty(d, cfg.output_dim, True, device, dtype)


@torch.no_grad()
def init_audio_encoder(p: AudioEncoder, gen: torch.Generator) -> AudioEncoder:
    """Fill a tower in place with init_audio_encoder's distributions: linears
    N(0, 1/d_in), convs N(0, 0.05^2), zero biases, LayerNorms (1, 0) (the
    numbers differ from the JAX package's)."""
    for w, b in zip(p.conv_w, p.conv_b):
        normal_(w, 0.05, gen)
        b.zero_()
    normal_(p.conv_out, p.conv_out.shape[0] ** -0.5, gen)
    init_blocks_(p.blocks, gen)
    init_norm_(p.ln_post)
    for leaf in (p.proj1, p.proj2):
        normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    return p


def convert_audio_encoder(sd, cfg: AudioEncoderConfig, prefix: str = "") -> dict:
    """HF Qwen3OmniMoeAudioEncoder state dict -> tree in the JAX layout (CPU
    tensor views, linears (in, out))."""
    from .convert import _lin, _ln, t2np

    blocks = []
    for i in range(cfg.layers):
        b = f"{prefix}layers.{i}"
        blocks.append({
            "ln1": _ln(sd, f"{b}.self_attn_layer_norm"),
            "attn": {"q": _lin(sd, f"{b}.self_attn.q_proj"),
                     "k": _lin(sd, f"{b}.self_attn.k_proj"),
                     "v": _lin(sd, f"{b}.self_attn.v_proj"),
                     "o": _lin(sd, f"{b}.self_attn.out_proj")},
            "ln2": _ln(sd, f"{b}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{b}.fc1"), "fc2": _lin(sd, f"{b}.fc2")},
        })
    conv = {f"conv{i}": {"w": t2np(sd[f"{prefix}conv2d{i}.weight"]),
                         "b": t2np(sd[f"{prefix}conv2d{i}.bias"])} for i in (1, 2, 3)}
    return {**conv,
            "conv_out": {"w": t2np(sd[f"{prefix}conv_out.weight"]).t(), "b": None},
            "blocks": blocks,
            "ln_post": _ln(sd, f"{prefix}ln_post"),
            "proj1": _lin(sd, f"{prefix}proj1"),
            "proj2": _lin(sd, f"{prefix}proj2")}


# ---------------------------------------------------------------------------
# Device: the tower
# ---------------------------------------------------------------------------

def audio_encoder(p: AudioEncoder, cfg: AudioEncoderConfig,
                  mel_chunks: torch.Tensor,   # (N, mel_bins, chunk_frames)
                  seg: torch.Tensor,          # (N*chunk_tokens,) int
                  ) -> torch.Tensor:
    """-> (N*chunk_tokens, output_dim); the caller gathers the valid slots."""
    dtype = p.conv_out.dtype
    x = mel_chunks.to(dtype)[:, None]                      # (N, 1, F, T)
    for w, b in zip(p.conv_w, p.conv_b):
        x = F.gelu(F.conv2d(x, w, b, stride=2, padding=1))
    n, c, f, t = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n, t, c * f) @ p.conv_out   # (N, T', d_model)
    pos = torch.from_numpy(sinusoid_positions(cfg.max_source_positions, cfg.d_model)[:t])
    x = (x + pos.to(x.device, x.dtype)).reshape(1, n * t, cfg.d_model)
    seg = seg.to(x.device)[None]
    branch = None
    for blk in p.blocks:
        x, branch = pre_ln_block(blk, x, branch, cfg.heads, 1e-5, "gelu",
                                 segment_ids=seg)
    _, h = L.add_layer_norm(x, branch, p.ln_post.scale, p.ln_post.bias, 1e-5)
    return Q.linear(L.ACT_FNS["gelu"](Q.linear(h, p.proj1)), p.proj2)[0]


def encode_audios(p: AudioEncoder, cfg: AudioEncoderConfig, mels) -> list[torch.Tensor]:
    """mels: (mel_bins, T_i) log-mel features of several audios on one device
    -> each audio's (n_tokens_i, output_dim) features, from one tower call."""
    chunks, segs, valid_idx = [], [], []
    ct, cf = cfg.chunk_tokens, cfg.chunk_frames
    win, row = 0, 0
    for mel in mels:
        chunk_lens, valid, seg, _ = audio_geometry(mel.shape[1], cfg)
        nc = len(chunk_lens)
        padded = F.pad(mel, (0, nc * cf - mel.shape[1]))           # zeros past the end
        chunks.append(padded.reshape(cfg.num_mel_bins, nc, cf).transpose(0, 1))
        segs.append(np.where(seg >= 0, seg + win, -1))
        win += int(seg.max()) + 1
        valid_idx.append(row + np.flatnonzero(valid.reshape(-1)))
        row += nc * ct
    out = audio_encoder(p, cfg, torch.cat(chunks),
                        torch.from_numpy(np.concatenate(segs).astype(np.int32)))
    return [out[torch.from_numpy(i).to(out.device)] for i in valid_idx]


def encode_audio(p: AudioEncoder, cfg: AudioEncoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (mel_bins, T) log-mel features -> (n_tokens, output_dim)."""
    return encode_audios(p, cfg, [mel])[0]
