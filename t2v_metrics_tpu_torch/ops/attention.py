"""Attention over the flat (B, S, H*D) projection layout.

Port of the flat half of t2v_metrics_tpu/ops/attention.py:

  * ``attention_flat_reference``: the plain PyTorch version, with the flat
    kernel's semantics (fp32 scores and softmax, P rounded to v's dtype
    before P.V, a fully masked row gives 0);
  * ``flash_attention_flat`` / ``flash_attention_flat_packed``: wrappers of
    the CUDA kernel in ``csrc/flash_flat.cu`` (see the note there for what
    it replaces, what bounds it and how it is built); a CPU tensor takes the
    plain version, a CUDA tensor launches the kernel or raises;
  * ``attention_flat`` / ``attention_flat_packed``: the dispatchers the
    models call.

The TPU package reaches its flat kernel only for sq >= 128 and sk <= 2048
(Mosaic tiling and VMEM limits), so its T5 decoder self- and cross-attention
(sq = 4) ran the XLA reference, and the Qwen2.5-VL and Qwen3-VL ViT layers
over a whole 5120- or 4096-row patch bucket ran the per-head
``_flash_kernel``. The CUDA kernel masks its own ragged edge and streams the
keys, so here every attention site of clip-flant5, Qwen2.5-VL and Qwen3-VL
goes through the one kernel.
"""

from __future__ import annotations

import torch

HEAD_DIMS = (64, 72, 80, 128)   # the head dims the CUDA kernel is built for


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def attention_flat_reference(q, k, v, heads, kv_heads=None, bias=None,
                             kv_mask=None, causal=False, scale=None,
                             segment_ids=None, local_window=None,
                             bidir_ids=None):
    """Softmax attention over flat inputs.

    q: (B, Sq, H*D); k, v: (B, Sk, KvH*D) (GQA when KvH < H).
    bias: additive, broadcastable to (B, H, Sq, Sk). kv_mask: (B, Sk), true
    = attend. causal: the diagonal is aligned to the end of the keys, so q
    row i attends keys <= i + (Sk - Sq). segment_ids, local_window and
    bidir_ids follow t2v_metrics_tpu/ops/attention.py:attention_reference.
    Returns (B, Sq, H*D) in q's dtype.
    """
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    kvh = kv_heads or heads
    if scale is None:
        scale = d ** -0.5
    qh = q.reshape(b, sq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, sk, kvh, d).transpose(1, 2).float()
    vh = v.reshape(b, sk, kvh, d).transpose(1, 2)
    if kvh != heads:
        kh = kh.repeat_interleave(heads // kvh, dim=1)
        vh = vh.repeat_interleave(heads // kvh, dim=1)
    s = qh @ kh.transpose(-1, -2)
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    keep = torch.ones((1, 1, 1, sk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        keep = keep & kv_mask.bool()[:, None, None, :]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
    if causal or local_window is not None:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        band = col - (sk - sq) <= row
        if local_window is not None:
            band = band & (col - (sk - sq) > row - local_window)
        band = band[None, None]
        if bidir_ids is not None:
            same = ((bidir_ids[:, :, None] == bidir_ids[:, None, :])
                    & (bidir_ids[:, :, None] >= 0))
            band = band | same[:, None]
        keep = keep & band
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = p.to(v.dtype).float() @ vh.float()
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype).transpose(1, 2).reshape(b, sq, heads * d)


def _split_packed(qkv, heads, kv_heads):
    kvh = kv_heads or heads
    d = qkv.shape[-1] // (heads + 2 * kvh)
    return (qkv[..., :heads * d], qkv[..., heads * d:(heads + kvh) * d],
            qkv[..., (heads + kvh) * d:], d)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_operand(x, name):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_flat: {name} must be bf16, got {x.dtype}")
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"flash_attention_flat: {name} must be (B, S, cols) "
                         "with unit column stride")
    if (x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8):
        raise ValueError(f"flash_attention_flat: {name} is not 16-byte aligned")


def flash_flat_launch(q, k, v, q_off, k_off, v_off, heads, kv_heads, d, sq,
                      sk, bias, kv_mask, causal, scale, segment_ids=None):
    """Launch the CUDA kernel on column-offset views of q, k and v.

    q/k/v are the base (B, S, cols) tensors (the same tensor three times for
    a packed projection); *_off are element column offsets of head 0; d is
    the head dim.
    """
    from ..build import flash_flat_lib

    b = q.shape[0]
    kvh = kv_heads or heads
    if heads % kvh:
        raise ValueError(f"flash_attention_flat: {heads} heads over {kvh} kv heads")
    for x, name, off, n in ((q, "q", q_off, heads), (k, "k", k_off, kvh),
                            (v, "v", v_off, kvh)):
        _check_operand(x, name)
        if x.device != q.device:
            raise ValueError("flash_attention_flat: operands on different devices")
        if off % 8 or off + n * d > x.shape[2]:
            raise ValueError(f"flash_attention_flat: {name} columns out of range")
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] < sk or v.shape[1] < sk:
        raise ValueError("flash_attention_flat: k/v batch or length mismatch")
    out = torch.empty((b, sq, heads * d), dtype=q.dtype, device=q.device)
    bias_ptr, bias_strides = None, (0, 0, 0)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError("flash_attention_flat: bias must be fp32 on q's device")
        if bias.dim() != 4 or bias.shape[0] != 1:
            raise ValueError("flash_attention_flat: bias must be (1, H, Sq, Sk)")
        bias = bias.expand(1, heads, sq, sk)
        bias_ptr, bias_strides = bias.data_ptr(), tuple(bias.stride()[1:])
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.shape != (b, sk) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention_flat: kv_mask must be ({b}, {sk})")
        kv_mask = kv_mask.to(torch.int32).contiguous()
        mask_ptr = kv_mask.data_ptr()
    seg_ptr = None
    if segment_ids is not None:
        if sq != sk:
            raise ValueError("flash_attention_flat: segment_ids need sq == sk")
        if segment_ids.shape != (b, sk) or segment_ids.device != q.device:
            raise ValueError(f"flash_attention_flat: segment_ids must be ({b}, {sk})")
        segment_ids = segment_ids.to(torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    rc = flash_flat_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias_ptr,
        mask_ptr, seg_ptr, b, heads, kvh, sq, sk, d,
        q.stride(0), q.stride(1), q_off, k.stride(0), k.stride(1), k_off,
        v.stride(0), v.stride(1), v_off, out.stride(0), out.stride(1),
        *bias_strides, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_flat_forward launch failed: CUDA error {rc}")
    flash_flat_launch.launches += 1
    return out


flash_flat_launch.launches = 0


def _kernel_device(x, d):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"flash_attention_flat: no kernel for device {x.device}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_flat: the CUDA kernel takes head dims {HEAD_DIMS}, "
            f"got {d}")
    return True


def flash_attention_flat(q, k, v, heads, kv_heads=None, bias=None,
                         kv_mask=None, causal=False, scale=None,
                         segment_ids=None):
    """Attention over flat q (B, Sq, H*D), k/v (B, Sk, KvH*D): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    d = q.shape[-1] // heads
    if not _kernel_device(q, d):
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids)
    return flash_flat_launch(q, k, v, 0, 0, 0, heads, kv_heads, d, q.shape[1],
                             k.shape[1], bias, kv_mask, causal,
                             d ** -0.5 if scale is None else scale, segment_ids)


def flash_attention_flat_packed(qkv, heads, kv_heads=None, bias=None,
                                kv_mask=None, causal=False, scale=None,
                                segment_ids=None):
    """Self-attention over a packed (B, S, (H + 2*KvH)*D) projection. The
    kernel reads q, k and v as column-offset views of the one array."""
    kvh = kv_heads or heads
    d = qkv.shape[-1] // (heads + 2 * kvh)
    if not _kernel_device(qkv, d):
        q, k, v, _ = _split_packed(qkv, heads, kv_heads)
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids)
    s = qkv.shape[1]
    return flash_flat_launch(qkv, qkv, qkv, 0, heads * d, (heads + kvh) * d,
                             heads, kv_heads, d, s, s, bias, kv_mask, causal,
                             d ** -0.5 if scale is None else scale, segment_ids)


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

def _extra_terms(q, local_window, bidir_ids):
    """True when a term the CUDA kernel lacks is set (CPU only)."""
    if local_window is None and bidir_ids is None:
        return False
    if q.device.type != "cpu":
        raise NotImplementedError(
            "attention_flat: local_window and bidir_ids have no CUDA kernel yet")
    return True


def attention_flat(q, k, v, heads, kv_heads=None, bias=None, kv_mask=None,
                   causal=False, scale=None, segment_ids=None,
                   local_window=None, bidir_ids=None):
    """Attention over flat (B, S, H*D) inputs and output."""
    if _extra_terms(q, local_window, bidir_ids):
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids,
                                        local_window, bidir_ids)
    return flash_attention_flat(q, k, v, heads, kv_heads, bias, kv_mask,
                                causal, scale, segment_ids)


def attention_flat_packed(qkv, heads, kv_heads=None, bias=None, kv_mask=None,
                          causal=False, scale=None, segment_ids=None,
                          local_window=None, bidir_ids=None):
    """Self-attention over a packed (B, S, (H + 2*KvH)*D) qkv projection."""
    if _extra_terms(qkv, local_window, bidir_ids):
        q, k, v, _ = _split_packed(qkv, heads, kv_heads)
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids,
                                        local_window, bidir_ids)
    return flash_attention_flat_packed(qkv, heads, kv_heads, bias, kv_mask,
                                       causal, scale, segment_ids)
