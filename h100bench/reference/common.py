"""Plain float32 building blocks the references share: the weights of the
benchmark's rule as the port holds them, matrix products at the reference's
precision or the control's, norms, softmax attention and the rotary
embedding. Nothing here imports the port."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..weights import served


class Weights:
    """Leaves by path, drawn by ``rule`` (``weights.py``), rounded to the
    served dtype and returned in float32; ``quant="fp8"`` makes every
    matrix product take float8 e4m3 operands (the control: the reference
    computed in fp8 as the port computes in bf16, every tensor-core
    product, attention's included, at the lower precision)."""

    def __init__(self, rule, seed: int, device, dtype, quant: str | None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.rule, self.seed, self.device = rule, seed, torch.device(device)
        self.dtype, self.quant = dtype, quant

    def __call__(self, path: str, *shape) -> torch.Tensor:
        return served(self.seed, path, shape, self.rule, self.dtype, self.device)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w; under the control, x per row and w per output column in
        float8 e4m3."""
        if self.quant is None:
            return x @ w
        return fp8(x, -1) @ fp8(w, -2)

    def linear(self, x, path: str, d_in: int, d_out: int, bias: bool = False):
        y = self.mm(x, self(path + ".w", d_in, d_out))
        return y + self(path + ".b", d_out) if bias else y


def fp8(t: torch.Tensor, axis: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with an absmax scale along ``axis``."""
    scale = t.abs().amax(dim=axis, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def layer_norm(x, w: Weights, path: str, width: int, eps: float):
    return F.layer_norm(x, (width,), w(path + ".scale", width), w(path + ".bias", width), eps)


def rms_norm(x, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rotary embedding of (..., S, H, d) heads, cos / sin (..., S, d),
    the halves of each head paired (NeoX layout)."""
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos[..., None, :] + rot * sin[..., None, :]


def attend(q, k, v, heads: int, kv_heads: int | None = None, bias=None, key_mask=None,
           causal: bool = False, scale=None, quant: str | None = None) -> torch.Tensor:
    """Softmax attention of (B, Sq, H*d) queries over (B, Sk, KvH*d) keys
    and values (each kv head serving H / KvH query heads): (B, Sq, H*d).
    ``quant="fp8"``: both products take float8 e4m3 operands, as an fp8
    attention kernel does (q and k per row, the probabilities per row, v
    per column)."""
    kv_heads = kv_heads or heads
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // heads
    q = q.view(b, sq, heads, d).transpose(1, 2)
    k = k.view(b, sk, kv_heads, d).transpose(1, 2).repeat_interleave(heads // kv_heads, 1)
    v = v.view(b, sk, kv_heads, d).transpose(1, 2).repeat_interleave(heads // kv_heads, 1)
    if quant is not None:
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -2)
    s = q @ k.transpose(-1, -2)
    if scale is not None:
        s = s * scale
    if bias is not None:
        s = s + bias
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    if causal:
        s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    probs = torch.softmax(s, -1)
    if quant is not None:
        probs = fp8(probs, -1)
    return (probs @ v).transpose(1, 2).reshape(b, sq, hd)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for float32 products while the context is open."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
