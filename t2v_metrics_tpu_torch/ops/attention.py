"""Attention: the flat (B, S, H*D) and per-head (B, H, S, D) layouts.

Port of t2v_metrics_tpu/ops/attention.py:

  * ``attention_reference`` / ``attention_flat_reference``: the plain PyTorch
    versions, with the kernels' semantics (fp32 scores and softmax, P
    rounded to v's dtype before P.V, a fully masked row gives 0);
  * ``flash_attention_flat`` / ``flash_attention_flat_packed``: wrappers of
    the CUDA kernel in ``csrc/flash_flat.cu`` (the TPU ``_flash_flat_kernel``);
  * ``flash_attention``: the wrapper of the CUDA kernel in
    ``csrc/flash_attention.cu`` (the TPU ``_flash_kernel``), with the T5
    relative-position bias computed in the kernel;
  * ``attention_flat`` / ``attention_flat_packed`` / ``attention``: the
    dispatchers the models call;
  * ``tma_geometry`` (``flat_geometry`` / ``head_geometry``): each
    operand's TMA tensor map (base, extents, byte strides, box, swizzle,
    zero-filled pad columns), which the CUDA entries only encode, and the
    alignment checks the TMA needs;
  * ``segment_tile_plan``: the key tiles a call with segment ids visits and
    the tiles that take the per-element compare, as the kernels plan them,
    which the flat wrappers count while a trace records (``attn_seg_*``).

The notes in ``csrc/`` say what each kernel replaces, what bounds it and how
it is built. A wrapper takes the plain version for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.

The TPU package reaches its flat kernel only for sq >= 128 and sk <= 2048
(Mosaic tiling and VMEM limits), so its T5 decoder self- and cross-attention
(sq = 4) ran the XLA reference, and the ViT layers over 4096 or more rows
(Qwen2.5-VL, Qwen3-VL, SigLIP at 896 px) ran the per-head ``_flash_kernel``.
The CUDA flat kernel masks its own ragged edge and streams the keys, so here
every attention site of clip-flant5, Qwen2.5-VL, Qwen3-VL, the Gemma 3
decoder, CLIPScore's two towers and BLIP-2 ITM (the EVA tower at head dim
88, the Q-Former's self- and cross-attention) goes through it, where the JAX
package sends the CLIP text tower (77 rows), the EVA tower and the Q-Former
to XLA; the SigLIP-896 tower follows the JAX routing to the per-head kernel
(``models/siglip.py``), as does the T5 attention under
``models/t5.py:INKERNEL_REL_BIAS``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import tracing
from .position import compute_position_bias, relative_position_bucket

# the head dims each CUDA kernel is built for (88: BLIP-2's EVA ViT-g, in the
# flat kernel only)
HEAD_DIMS = {"flash_attention_flat": (64, 72, 80, 88, 128, 256),
             "flash_attention": (64, 72, 80, 128, 256)}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def attention_reference(q, k, v, bias=None, kv_mask=None, causal=False,
                        scale=None, segment_ids=None, local_window=None,
                        bidir_ids=None, rel_bias=None, rel_cfg=None):
    """Softmax attention over per-head inputs.

    q: (B, H, Sq, D); k, v: (B, H, Sk, D). bias: additive, broadcastable to
    (B, H, Sq, Sk). kv_mask: (B, Sk), true = attend. causal: the diagonal is
    aligned to the end of the keys, so q row i attends keys <= i + (Sk -
    Sq). segment_ids (B, S): row i attends key j only when their ids are
    equal (Sq == Sk). local_window W (causal): row i also drops keys j with
    j - (Sk - Sq) <= i - W. bidir_ids (B, S), -1 outside blocks: over the
    causal/window band, rows and keys sharing a non-negative id attend each
    other (it overrides the window, as HF Gemma 3 does). rel_bias (H,
    num_buckets) with rel_cfg = (bidirectional, num_buckets, max_distance,
    q_offset): the T5 relative-position bias, added as the dense bias that
    ``ops/position.py:compute_position_bias`` builds (not with ``bias``).
    Returns (B, H, Sq, D) in q's dtype.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if rel_bias is not None:
        if bias is not None:
            raise ValueError("attention: rel_bias and bias are exclusive")
        bidirectional, nb, max_distance, q_offset = rel_cfg
        bias = compute_position_bias(rel_bias.T, sq, sk, bidirectional, nb,
                                     max_distance, q_offset)
    s = q.float() @ k.float().transpose(-1, -2)
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
    o = p.to(v.dtype).float() @ v.float()
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def attention_flat_reference(q, k, v, heads, kv_heads=None, bias=None,
                             kv_mask=None, causal=False, scale=None,
                             segment_ids=None, local_window=None,
                             bidir_ids=None):
    """``attention_reference`` over flat inputs.

    q: (B, Sq, H*D); k, v: (B, Sk, KvH*D) (GQA when KvH < H). The other
    arguments as ``attention_reference``'s. Returns (B, Sq, H*D) in q's
    dtype.
    """
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    kvh = kv_heads or heads
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = k.reshape(b, sk, kvh, d).transpose(1, 2)
    vh = v.reshape(b, sk, kvh, d).transpose(1, 2)
    if kvh != heads:
        kh = kh.repeat_interleave(heads // kvh, dim=1)
        vh = vh.repeat_interleave(heads // kvh, dim=1)
    o = attention_reference(qh, kh, vh, bias, kv_mask, causal, scale,
                            segment_ids, local_window, bidir_ids)
    return o.transpose(1, 2).reshape(b, sq, heads * d)


def _split_packed(qkv, heads, kv_heads):
    kvh = kv_heads or heads
    d = qkv.shape[-1] // (heads + 2 * kvh)
    return (qkv[..., :heads * d], qkv[..., heads * d:(heads + kvh) * d],
            qkv[..., (heads + kvh) * d:], d)


def packed_heads(qkv, heads):
    """A packed (B, S, 3*H*D) q|k|v projection -> q, k, v as (B, H, S, D)
    strided views (no copy)."""
    b, s, lanes = qkv.shape
    d = lanes // (3 * heads)
    return qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def split_heads(t, heads):
    """A flat (B, S, H*D) projection -> (B, H, S, D), a strided view."""
    b, s, lanes = t.shape
    return t.view(b, s, heads, lanes // heads).transpose(1, 2)


def merge_heads(a):
    """(B, H, S, D) -> (B, S, H*D); free on the per-head kernel's output."""
    b, h, s, d = a.shape
    return a.transpose(1, 2).reshape(b, s, h * d)


@functools.lru_cache(maxsize=64)
def rel_bucket_table(sq: int, sk: int, bidirectional: bool, num_buckets: int,
                     max_distance: int, q_offset: int,
                     device: torch.device) -> torch.Tensor:
    """int32 (Sq + Sk - 1,) table: entry ``col - row + Sq - 1`` is the T5
    bucket of the distance ``col - (row + q_offset)``, by the port's own
    ``relative_position_bucket`` (the plain version's function), so the
    kernel's bias equals ``compute_position_bias`` exactly."""
    rel = torch.arange(sq + sk - 1, device=device) - (sq - 1) - q_offset
    return relative_position_bucket(rel, bidirectional, num_buckets,
                                    max_distance).to(torch.int32)


# ---------------------------------------------------------------------------
# TMA geometry
# ---------------------------------------------------------------------------

# The CUDA kernels' tiles (csrc/flash_common.cuh Tile): the head dim padded
# to the 16-wide k-step and loaded as panels of 64 columns (128-byte swizzle)
# where the padded dim is a multiple of 64, else of 16 columns (32-byte
# swizzle).

def padded_dim(d: int) -> int:
    return (d + 15) // 16 * 16


def tile_rows(d: int, sq: int, single: bool = False) -> tuple[int, int]:
    """(q rows a block, keys a tile) of the kernel variant a call runs: one
    consumer warpgroup of 64 rows over 64-key tiles where Sq <= 64 (many
    blocks an SM, for the T5 decoder's 4-row attention) or ``single`` (the
    per-head kernel's T5 bias beside segment ids, a window or bidir ids at
    head dim 256, which needs the registers of a block without a producer
    warpgroup), else two of 64 rows over 128-key tiles (64 at head dim
    256)."""
    if sq <= 64 or single:
        return 64, 64
    return 128, 128 if d <= 128 else 64


# the rows of a consumer warpgroup of the kernels (wgmma's M)
WG_ROWS = 64


def _id_ranges(ids: torch.Tensor, n: int):
    """(smallest, largest) id of each run of ``n`` entries of (B, S) int64
    ids, a ragged last run over its real entries: two (B, ceil(S / n))."""
    pad = -ids.shape[1] % n
    b = ids.shape[0]
    lo = torch.nn.functional.pad(ids, (0, pad), value=2 ** 62).view(b, -1, n).amin(-1)
    hi = torch.nn.functional.pad(ids, (0, pad), value=-2 ** 62).view(b, -1, n).amax(-1)
    return lo, hi


def segment_tile_plan(segment_ids: torch.Tensor, block_rows: int, key_rows: int) -> dict:
    """The kernels' plan of key tiles for (B, S) segment ids (``Sq == Sk``,
    no causal or window band), for one head, on the ids' device with no
    host sync (csrc/flash_common.cuh, "Segment ids per key tile"): a block of
    ``block_rows`` rows visits a tile of ``key_rows`` keys when the id range
    of its rows meets the tile's; a consumer warpgroup of 64 rows runs the
    per-element compare on a visited tile unless their ranges do not meet
    (every score -inf) or its rows and the tile's keys all hold one id.
    Returns ``attn_seg_tiles`` ((block, key tile) pairs, an int),
    ``attn_seg_tiles_run`` (those visited), ``attn_seg_tiles_mixed``
    ((warpgroup, visited tile) pairs with the compare) and
    ``attn_seg_wg_tiles`` (every (warpgroup, visited tile) pair), the last
    three 0-d int64 tensors."""
    ids = segment_ids.to(torch.int64)
    lo_k, hi_k = _id_ranges(ids, key_rows)                    # (B, key tiles)

    def meet(lo, hi):     # (B, R, key tiles): the ranges lo..hi meet the tiles'
        return (lo_k[:, None] <= hi[..., None]) & (hi_k[:, None] >= lo[..., None])

    visit = meet(*_id_ranges(ids, block_rows))                # (B, blocks, key tiles)
    lo_w, hi_w = _id_ranges(ids, WG_ROWS)                     # warpgroups with rows
    wg_visit = (visit[:, :, None].expand(-1, -1, block_rows // WG_ROWS, -1)
                .flatten(1, 2)[:, :lo_w.shape[1]])
    whole = ((lo_w == hi_w)[..., None] & (lo_k == hi_k)[:, None]
             & (lo_k[:, None] == lo_w[..., None]))
    mixed = wg_visit & meet(lo_w, hi_w) & ~whole
    return {"attn_seg_tiles": visit.numel(), "attn_seg_tiles_run": visit.sum(),
            "attn_seg_tiles_mixed": mixed.sum(), "attn_seg_wg_tiles": wg_visit.sum()}


def _count_segment_tiles(segment_ids, heads, d, sq, causal, local_window) -> None:
    """While a trace records (``tracing.enabled()``): the plan of a flat call
    with segment ids and no causal or window band (every segment-id site of
    the port; the kernel classifies tiles only without the band) over its
    ``heads``, into the ``attn_seg_*`` counters, the tile count on the host
    and the rest added on the ids' device."""
    if (segment_ids is None or causal or local_window is not None
            or segment_ids.shape[-1] != sq or not tracing.enabled()):
        return
    for name, n in segment_tile_plan(segment_ids, *tile_rows(d, sq)).items():
        if isinstance(n, int):
            tracing.count(name, heads * n)
        else:
            tracing.count_device(name, heads * n)


def panel_width(d: int) -> int:
    return 64 if padded_dim(d) % 64 == 0 else 16


@dataclasses.dataclass(frozen=True)
class TmaGeometry:
    """One operand's TMA tensor map over (head dim, heads, rows, batch).

    ``offset`` is in elements from the tensor's ``data_ptr()`` to element
    (column 0, head 0, row 0, batch 0). ``dims`` are the map's extents, the
    head dim first and then the head, row and batch axes in the order of
    their strides; ``strides`` the byte strides of map dims 1..3; ``axes``
    the map dim (1..3) of the head, the row and the batch axis; ``box`` the
    elements of one copy (a panel of ``box[0]`` columns over the tile's
    rows); ``swizzle`` in bytes; ``pad`` the columns of the last panel past
    the head dim, which the TMA fills with zeros (they lie outside the
    extent ``dims[0]``)."""

    offset: int
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    axes: tuple[int, int, int]
    box: tuple[int, int, int, int]
    swizzle: int
    pad: int

    def packed(self, x: torch.Tensor) -> list[int]:
        """The 16 int64 the C entries read (flash_common.cuh ``GEO``)."""
        return [x.data_ptr() + x.element_size() * self.offset, *self.dims,
                *self.strides, *self.box, self.swizzle, *self.axes]


def tma_geometry(x: torch.Tensor, offset: int, strides, extents, d: int,
                 tile_rows: int, what: str = "flash_attention_flat",
                 name: str = "x") -> TmaGeometry:
    """The tensor map of the (head, row, batch) grid of d-column heads of
    ``x``: ``strides`` and ``extents`` of the head, row and batch axes in
    elements, ``offset`` in elements from ``x.data_ptr()``. Raises
    ValueError where the TMA refuses: a base address that is not 16-byte
    aligned, or a byte stride of an axis longer than 1 that is not a
    multiple of 16."""
    if d not in HEAD_DIMS[what]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes head dims {HEAD_DIMS[what]}, got {d}")
    size = x.element_size()
    if (x.data_ptr() + size * offset) % 16:
        raise ValueError(f"{what}: {name} is not 16-byte aligned")
    real = [i for i in range(3) if extents[i] > 1]
    if any(strides[i] * size % 16 for i in real):
        raise ValueError(f"{what}: {name} is not 16-byte aligned")
    # axes longer than 1 in the order of their strides; an axis of extent 1
    # goes last, with a stride past the others (its own is never used)
    span = max([d] + [strides[i] * extents[i] for i in real])
    span = (span + 7) // 8 * 8
    order = sorted(real, key=lambda i: strides[i]) + [i for i in range(3) if i not in real]
    byte_strides = tuple((strides[i] if i in real else span) * size for i in order)
    axes = tuple(order.index(i) + 1 for i in range(3))
    pw = panel_width(d)
    box = (pw, *(tile_rows if i == 1 else 1 for i in order))
    return TmaGeometry(offset, (d, *(int(extents[i]) for i in order)), byte_strides,
                       axes, box, pw * size, padded_dim(d) - d)


def flat_geometry(x, col_off, heads, rows, d, tile_rows, name="x"):
    """Geometry of the heads at columns col_off + h*d of a flat (B, S, cols)
    tensor, over its first ``rows`` rows."""
    return tma_geometry(x, col_off, (d, x.stride(1), x.stride(0)),
                        (heads, rows, x.shape[0]), d, tile_rows,
                        "flash_attention_flat", name)


def head_geometry(x, tile_rows, name="x"):
    """Geometry of a (B, H, S, D) tensor (any strides, unit column stride)."""
    b, h, s, d = x.shape
    return tma_geometry(x, 0, (x.stride(1), x.stride(2), x.stride(0)), (h, s, b),
                        d, tile_rows, "flash_attention", name)


def _geo_array(pairs):
    """The C entries' ``geo``: 16 int64 per (tensor, geometry) pair."""
    vals = [v for x, geo in pairs for v in geo.packed(x)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bias_args(bias, b, heads, sq, sk, what):
    """(pointer, (batch, head, row, col) strides, 8-byte pairs, head-major
    grid) of an fp32 bias broadcast to (B, H, Sq, Sk), or Nones."""
    if bias is None:
        return None, (0, 0, 0, 0), 0, 0
    bias = bias.expand(b, heads, sq, sk)
    st = bias.stride()
    vec2 = int(st[3] == 1 and all(x % 2 == 0 for x in st[:3])
               and bias.data_ptr() % 8 == 0)
    head_major = int(st[0] == 0 and b > 1)
    return bias.data_ptr(), tuple(st), vec2, head_major


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_operand(x, name, dims=3, what="flash_attention_flat"):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {name} must be bf16, got {x.dtype}")
    if x.dim() != dims or x.stride(-1) != 1:
        raise ValueError(f"{what}: {name} must have {dims} dims and unit "
                         "column stride")


def _ids(ids, b, sk, device, name, what):
    """A (B, Sk) id or mask array as contiguous int32 on the device."""
    if ids.shape != (b, sk) or ids.device != device:
        raise ValueError(f"{what}: {name} must be ({b}, {sk}) on {device}")
    return ids.to(torch.int32).contiguous()


def _band(causal, local_window, bidir_ids, sq, sk, what):
    """(causal, window, bidir_ids) as the kernels take them: a window
    implies causal (0 = none); the overlay needs a causal or window band
    (without one it changes nothing, as in the plain version)."""
    causal = bool(causal) or local_window is not None
    window = 0 if local_window is None else int(local_window)
    if local_window is not None and window < 1:
        raise ValueError(f"{what}: local_window must be >= 1")
    if bidir_ids is not None:
        if not causal:
            bidir_ids = None
        elif sq != sk:
            raise ValueError(f"{what}: bidir_ids need sq == sk")
    return causal, window, bidir_ids


def flash_flat_launch(q, k, v, q_off, k_off, v_off, heads, kv_heads, d, sq,
                      sk, bias, kv_mask, causal, scale, segment_ids=None,
                      local_window=None, bidir_ids=None):
    """Launch the CUDA kernel on column-offset views of q, k and v.

    q/k/v are the base (B, S, cols) tensors (the same tensor three times for
    a packed projection); *_off are element column offsets of head 0; d is
    the head dim.
    """
    from ..build import flash_flat_lib

    what = "flash_attention_flat"
    b = q.shape[0]
    kvh = kv_heads or heads
    if heads % kvh:
        raise ValueError(f"{what}: {heads} heads over {kvh} kv heads")
    for x, name, off, n in ((q, "q", q_off, heads), (k, "k", k_off, kvh),
                            (v, "v", v_off, kvh)):
        _check_operand(x, name)
        if x.device != q.device:
            raise ValueError(f"{what}: operands on different devices")
        if off % 8 or off + n * d > x.shape[2]:
            raise ValueError(f"{what}: {name} columns out of range")
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] < sk or v.shape[1] < sk:
        raise ValueError(f"{what}: k/v batch or length mismatch")
    if sq == 0 or sk == 0:
        raise ValueError(f"{what}: empty attention ({sq} rows, {sk} keys)")
    bq, bk = tile_rows(d, sq)
    geo = _geo_array(((q, flat_geometry(q, q_off, heads, sq, d, bq, "q")),
                      (k, flat_geometry(k, k_off, kvh, sk, d, bk, "k")),
                      (v, flat_geometry(v, v_off, kvh, sk, d, bk, "v"))))
    causal, window, bidir_ids = _band(causal, local_window, bidir_ids, sq, sk, what)
    out = torch.empty((b, sq, heads * d), dtype=q.dtype, device=q.device)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError(f"{what}: bias must be fp32 on q's device")
        if bias.dim() != 4 or bias.shape[0] != 1:
            raise ValueError(f"{what}: bias must be (1, H, Sq, Sk)")
    bias_ptr, bias_strides, vec2, head_major = _bias_args(bias, b, heads, sq, sk, what)
    if kv_mask is not None:
        kv_mask = _ids(kv_mask, b, sk, q.device, "kv_mask", what)
    if segment_ids is not None:
        if sq != sk:
            raise ValueError(f"{what}: segment_ids need sq == sk")
        segment_ids = _ids(segment_ids, b, sk, q.device, "segment_ids", what)
    if bidir_ids is not None:
        bidir_ids = _ids(bidir_ids, b, sk, q.device, "bidir_ids", what)
    ptr = [None if t is None else t.data_ptr()
           for t in (kv_mask, segment_ids, bidir_ids)]
    rc = flash_flat_lib()(
        geo, out.data_ptr(), bias_ptr, *ptr, None, None, b, heads, kvh, sq, sk,
        d, 0, out.stride(0), out.stride(1), d, *bias_strides, vec2, int(causal),
        window, head_major, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_flat_forward launch failed: CUDA error {rc}")
    tracing.count("launch.flash_attention_flat")
    return out


def _kernel_device(x, d, what="flash_attention_flat"):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if d not in HEAD_DIMS[what]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes head dims {HEAD_DIMS[what]}, got {d}")
    return True


def flash_attention_flat(q, k, v, heads, kv_heads=None, bias=None,
                         kv_mask=None, causal=False, scale=None,
                         segment_ids=None, local_window=None, bidir_ids=None):
    """Attention over flat q (B, Sq, H*D), k/v (B, Sk, KvH*D): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    d = q.shape[-1] // heads
    _count_segment_tiles(segment_ids, heads, d, q.shape[1], causal, local_window)
    if not _kernel_device(q, d):
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids,
                                        local_window, bidir_ids)
    return flash_flat_launch(q, k, v, 0, 0, 0, heads, kv_heads, d, q.shape[1],
                             k.shape[1], bias, kv_mask, causal,
                             d ** -0.5 if scale is None else scale, segment_ids,
                             local_window, bidir_ids)


def flash_attention_flat_packed(qkv, heads, kv_heads=None, bias=None,
                                kv_mask=None, causal=False, scale=None,
                                segment_ids=None, local_window=None,
                                bidir_ids=None):
    """Self-attention over a packed (B, S, (H + 2*KvH)*D) projection. The
    kernel reads q, k and v as column-offset views of the one array."""
    kvh = kv_heads or heads
    d = qkv.shape[-1] // (heads + 2 * kvh)
    _count_segment_tiles(segment_ids, heads, d, qkv.shape[1], causal, local_window)
    if not _kernel_device(qkv, d):
        q, k, v, _ = _split_packed(qkv, heads, kv_heads)
        return attention_flat_reference(q, k, v, heads, kv_heads, bias,
                                        kv_mask, causal, scale, segment_ids,
                                        local_window, bidir_ids)
    s = qkv.shape[1]
    return flash_flat_launch(qkv, qkv, qkv, 0, heads * d, (heads + kvh) * d,
                             heads, kv_heads, d, s, s, bias, kv_mask, causal,
                             d ** -0.5 if scale is None else scale, segment_ids,
                             local_window, bidir_ids)


def flash_attention_launch(q, k, v, bias, kv_mask, causal, scale, segment_ids,
                           local_window, rel_bias, rel_cfg, bidir_ids):
    """Launch the per-head CUDA kernel on (B, H, S, D) CUDA tensors, which
    may be strided views (unit column stride). Returns (B, H, Sq, D): a
    view of a (B, Sq, H, D) buffer, so that merging the heads is free."""
    from ..build import flash_attention_lib

    what = "flash_attention"
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(x, name, dims=4, what=what)
        if x.device != q.device:
            raise ValueError(f"{what}: operands on different devices")
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"{what}: k and v must be ({b}, {h}, Sk, {d})")
    if sq == 0 or sk == 0:
        raise ValueError(f"{what}: empty attention ({sq} rows, {sk} keys)")
    causal, window, bidir_ids = _band(causal, local_window, bidir_ids, sq, sk, what)
    single = (rel_bias is not None and d > 128
              and (segment_ids is not None or bidir_ids is not None or window > 0))
    bq, bk = tile_rows(d, sq, single)
    geo = _geo_array(((q, head_geometry(q, bq, "q")),
                      (k, head_geometry(k, bk, "k")), (v, head_geometry(v, bk, "v"))))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if bias is not None:
        if rel_bias is not None:
            raise ValueError(f"{what}: rel_bias and bias are exclusive")
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError(f"{what}: bias must be fp32 on q's device")
        if bias.dim() != 4:
            raise ValueError(f"{what}: bias must be (B or 1, H or 1, Sq, Sk)")
    bias_ptr, bias_strides, vec2, head_major = _bias_args(bias, b, h, sq, sk, what)
    rel_ptr = bucket_ptr = None
    num_buckets = 0
    if rel_bias is not None:
        bidirectional, num_buckets, max_distance, q_offset = rel_cfg
        if rel_bias.shape != (h, num_buckets) or rel_bias.device != q.device:
            raise ValueError(f"{what}: rel_bias must be ({h}, {num_buckets}) on "
                             f"{q.device}")
        rel_bias = rel_bias.float().contiguous()
        table = rel_bucket_table(sq, sk, bool(bidirectional), int(num_buckets),
                                 int(max_distance), int(q_offset), q.device)
        rel_ptr, bucket_ptr = rel_bias.data_ptr(), table.data_ptr()
    if kv_mask is not None:
        kv_mask = _ids(kv_mask, b, sk, q.device, "kv_mask", what)
    if segment_ids is not None:
        if sq != sk:
            raise ValueError(f"{what}: segment_ids need sq == sk")
        segment_ids = _ids(segment_ids, b, sk, q.device, "segment_ids", what)
    if bidir_ids is not None:
        bidir_ids = _ids(bidir_ids, b, sk, q.device, "bidir_ids", what)
    ptr = [None if t is None else t.data_ptr()
           for t in (kv_mask, segment_ids, bidir_ids)]
    rc = flash_attention_lib()(
        geo, out.data_ptr(), bias_ptr, *ptr, rel_ptr, bucket_ptr, b, h, h, sq, sk,
        d, int(num_buckets), out.stride(0), out.stride(1), out.stride(2),
        *bias_strides, vec2, int(causal), window, head_major, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_forward launch failed: CUDA error {rc}")
    tracing.count("launch.flash_attention")
    return out.transpose(1, 2)


def flash_attention(q, k, v, bias=None, kv_mask=None, causal=False, scale=None,
                    segment_ids=None, local_window=None, rel_bias=None,
                    rel_cfg=None, bidir_ids=None):
    """Per-head attention, q (B, H, Sq, D), k/v (B, H, Sk, D), with
    ``attention_reference``'s contract: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    d = q.shape[-1]
    if not _kernel_device(q, d, "flash_attention"):
        return attention_reference(q, k, v, bias, kv_mask, causal, scale,
                                   segment_ids, local_window, bidir_ids,
                                   rel_bias, rel_cfg)
    return flash_attention_launch(q, k, v, bias, kv_mask, causal,
                                  d ** -0.5 if scale is None else scale,
                                  segment_ids, local_window, rel_bias, rel_cfg,
                                  bidir_ids)


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

# The JAX package's dispatchers choose between its Pallas kernels and XLA by
# device and by shape (Mosaic tiling and VMEM limits). On Hopper the kernels
# take every shape and the wrappers above already choose by device (a CPU
# tensor runs the plain version, a CUDA tensor the kernel), so the
# dispatchers are those wrappers under the JAX names.
attention_flat = flash_attention_flat
attention_flat_packed = flash_attention_flat_packed
attention = flash_attention
