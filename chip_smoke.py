#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile] [--kernels-only]

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card's name and power limit; build every kernel of the
     clip-flant5 and Qwen2.5-VL paths from the sources in this checkout (nvcc
     for the CUDA flash attention at head dims 64/80/128, Triton for
     LayerNorm, RMSNorm and the rotary embedding) and time the build;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the clip-flant5-xl and Qwen2.5-VL-7B paths give it, with its
     tolerance and CUDA-event times (``--kernels-only`` stops here, with no
     result line);
  3. the full-width chains (clip-flant5-xl widths with 2 ViT and 2+2 T5
     layers; Qwen2.5-VL-7B widths with 2 ViT layers, one windowed and one
     full, and 2 decoder layers) on the card in bf16 with the kernels,
     against the CPU in fp32 with the plain versions, on one set of random
     parameters each;
  4. the slices through the public entry point, each with the kernel launch
     counts of its first call, ``batch_forward`` and pairs/s:
     ``VQAScore("clip-flant5-xl", init="random")`` and
     ``VQAScore("qwen2.5-vl-7b", init="random")`` (1024x1024 images, which
     take the untiled window layout, then 300x380 images through
     ``batch_forward``, which take the tiled one); with ``--profile``, the
     device time of one ``batch_forward`` of each, and of the Qwen forward
     at 1024x1024, by kernel family (torch.profiler) and the device's busy
     share.
The last lines are the kernel table (JSON; ``launches`` is a kernel's count
summed over the first calls of the two slices), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

Needs torch with CUDA, nvcc (``/usr/local/cuda`` or ``CUDA_HOME``) and triton;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
WARMUP, ITERS = 3, 20

# Tolerances of the kernel checks, |kernel - plain| <= atol + rtol*|plain|.
# Norms: both sides round one fp32 value to bf16, and its last bits depend
# on the summation order and on the kernel's fused multiply-add, so a result
# may land one bf16 ulp away (rtol 8e-3); T5's RMSNorm rounds twice (the
# normalized value, then the product), so two (1.6e-2); atol 1e-5 covers
# results near zero, where the bias add cancels. Attention: P is rounded to
# bf16 against the running max of each key tile in the kernel and against
# the row max in the plain version, and the sums run in another order.
LN_RTOL, RMS_RTOL, NORM_ATOL = 8e-3, 1.6e-2, 1e-5
ATTN_ATOL = ATTN_RTOL = 2e-2
# Rotary embedding: both sides round one f32 value to bf16; the kernel may
# fuse a multiply-add the plain version rounds twice, so one bf16 ulp.
ROPE_RTOL = 8e-3
# Chain: bf16 on the card against fp32 on the CPU, 2+2 T5 layers, with the
# T5 attention scale folded into W_q (see phase_chain): bf16 against fp32 of
# the same chain on the CPU differs by ~6e-3 nats, so 2.5e-2 is ~4x that.
CHAIN_TOL_NATS = 2.5e-2
# Slice: per-sample forward rows against batch_forward rows, with the T5
# attention scale folded into W_q as in the chain. The two run other GEMM
# shapes (1 image, 4 pairs against 8 images, 32 pairs), so other cuBLAS
# tilings and bf16 roundings: measured 0.037 nats at 24+24 layers with the
# fold (and 1.5 nats without it, where near-argmax attention amplifies them).
ROWS_TOL_NATS = 0.1
# Qwen chain: 7B widths, 2 ViT + 2 decoder layers, bf16 on the card against
# fp32 on the CPU. Random init gives q.k scores of std ~1 (no fold needed);
# the bf16 roundings of ~12 matmuls and the 152064-way log-softmax put the
# gap near 1e-2 nats, so the limit is 5x that.
QWEN_CHAIN_TOL_NATS = 5e-2

KERNELS = {
    "flash_attention_flat": ("cuda", "t2v_metrics_tpu_torch/csrc/flash_flat.cu",
                             "t2v_metrics_tpu/ops/attention.py:565"),
    "layer_norm": ("triton", "t2v_metrics_tpu_torch/ops/norms.py",
                   "t2v_metrics_tpu/ops/norms.py:65"),
    "rms_norm": ("triton", "t2v_metrics_tpu_torch/ops/norms.py",
                 "t2v_metrics_tpu/ops/norms.py:113"),
    "rope_pack": ("triton", "t2v_metrics_tpu_torch/ops/rope.py",
                  "t2v_metrics_tpu/ops/rope.py:51"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Median device milliseconds of ``fn`` over ITERS runs after WARMUP, by
    CUDA events around each run. A sleep kernel queued before the start
    event keeps the card busy while the host enqueues ``fn``'s launches, so
    the interval is device time and not the host's launch overhead."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def outside(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> int:
    """Number of elements with |out - ref| > atol + rtol * |ref|."""
    ref = ref.float()
    return int(((out.float() - ref).abs() > atol + rtol * ref.abs()).sum())


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units of the last place."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from t2v_metrics_tpu_torch import build
    from t2v_metrics_tpu_torch.ops import norms, rope

    t0 = time.perf_counter()
    build.flash_flat_lib()
    t_nvcc = time.perf_counter() - t0
    # Triton compiles at first launch: launch each kernel once at its widths
    dev = torch.device("cuda")

    def ones(*shape, dtype=torch.bfloat16):
        return torch.ones(shape, device=dev, dtype=dtype)

    norms.layer_norm_fused(ones(8, 1024), ones(1024), ones(1024))
    for d in (2048, 1280, 3584):
        norms.rms_norm_fused(ones(8, d), ones(d))
    for heads, d in ((32, 80), (36, 128)):
        rope.rope_pack(ones(1, 8, heads * d), ones(1, 8, d, dtype=torch.float32),
                       ones(1, 8, d, dtype=torch.float32), 32, d)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"[build] nvcc flash_flat.cu (head dims 64/80/128): {t_nvcc:.2f} s; "
        f"with the Triton norms and rotary embedding: {total:.2f} s")
    for line in build.build_log("flash_flat").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels() -> dict:
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def record(name, label, out, ref, ok, detail, fn, plain_fn, main):
        err = float((out.float() - ref.float()).abs().max())
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain_fn)
        log(f"[kernel] {name} {label}: max_abs_err {err:.3e} ({detail}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(ok, f"{name} {label} disagrees with its plain version: {detail}")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # LayerNorm: ln_pre at (M*577, 1024), ln1/ln2 at (M*640, 1024), M=4
    for rows, main in ((4 * 577, False), (4 * 640, True)):
        x, w, b = randn(rows, 1024, std=3.0), randn(1024), randn(1024)
        out, ref = N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b)
        bad = outside(out, ref, NORM_ATOL, LN_RTOL)
        record("layer_norm", f"({rows}, 1024)", out, ref, bad == 0,
               f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps",
               lambda: N.layer_norm_fused(x, w, b),
               lambda: N.layer_norm_plain(x, w, b), main)

    # RMSNorm: T5 encoder at (P*640, 2048), decoder at (P*4, 2048), P=32;
    # Qwen2.5-VL-7B ViT at (M*5120, 1280), M=4, decoder at (P*1280, 3584), P=16
    for rows, d, main in ((32 * 640, 2048, False), (32 * 4, 2048, False),
                          (4 * 5120, 1280, False), (16 * 1280, 3584, True)):
        x, w = randn(rows, d, std=3.0), randn(d)
        out, ref = N.rms_norm_fused(x, w), N.rms_norm_plain(x, w)
        bad = outside(out, ref, NORM_ATOL, RMS_RTOL)
        record("rms_norm", f"({rows}, {d})", out, ref, bad == 0,
               f"{bad} outside atol {NORM_ATOL} + rtol {RMS_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps",
               lambda: N.rms_norm_fused(x, w),
               lambda: N.rms_norm_plain(x, w), main)

    # Rotary embedding on the packed q|k|v rows of Qwen2.5-VL-7B: the ViT
    # (M=4 images x 5120 patch rows, 16 q + 16 k heads of 80, 3840 lanes)
    # and the decoder prefill (P=16 x 1280, 28 q + 4 k heads of 128, 4608)
    for b, s, lanes, d, main in ((4, 5120, 3840, 80, False),
                                 (16, 1280, 4608, 128, True)):
        pk = randn(b, s, lanes)
        ang = (torch.randint(0, 4096, (b, s, 1), generator=gen, device=dev).float()
               * randn(d, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        buf = pk.clone()
        out = R.rope_pack(buf, cos, sin, 32, d)     # in place on buf
        ref = R.rope_pack_plain(pk, cos, sin, 32, d)
        bad = outside(out, ref, NORM_ATOL, ROPE_RTOL)
        v_same = bool(torch.equal(out[..., 32 * d:], pk[..., 32 * d:]))
        record("rope_pack", f"({b}, {s}, {lanes}) 32 heads of {d}", out, ref,
               bad == 0 and v_same,
               f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps; v lanes untouched {v_same}",
               lambda: R.rope_pack(buf, cos, sin, 32, d),
               lambda: R.rope_pack_plain(pk, cos, sin, 32, d), main)

    # Attention at the four sites of the xl path, P=32 pairs, M=4 images
    def lengths_mask(b, s, lo, hi):
        lens = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
        return torch.arange(s, device=dev)[None, :] < lens[:, None]

    sites = []
    qkv = randn(4, 640, 3 * 1024)
    mask = (torch.arange(640, device=dev) < 577).expand(4, 640)
    sites.append(("ViT self (4, 640, 3*1024) packed, kv_mask", False,
                  (qkv, 16), dict(kv_mask=mask)))
    qkv = randn(32, 640, 3 * 2048)
    sites.append(("T5 encoder self (32, 640, 3*2048) packed, bias, kv_mask",
                  False, (qkv, 32),
                  dict(bias=randn(1, 32, 640, 640, dtype=torch.float32),
                       kv_mask=lengths_mask(32, 640, 590, 640), scale=1.0)))
    qkv = randn(32, 4, 3 * 2048)
    sites.append(("T5 decoder self (32, 4, 3*2048) packed, bias, causal",
                  False, (qkv, 32),
                  dict(bias=randn(1, 32, 4, 4, dtype=torch.float32),
                       causal=True, scale=1.0)))
    q, k, v = randn(32, 4, 2048), randn(32, 640, 2048), randn(32, 640, 2048)
    sites.append(("T5 cross q (32, 4, 2048) k/v (32, 640, 2048), kv_mask",
                  False, (q, k, v, 32),
                  dict(kv_mask=lengths_mask(32, 640, 590, 640), scale=1.0)))
    # Qwen2.5-VL-7B: the ViT's windowed layers on the tile layout of 300x380
    # images (4 images x 6 tiles of 128 rows) and over the whole 5120-row
    # bucket of a 980x980 grid, its full layers, and the decoder prefill
    tile_seg, bucket_seg, full_seg = qwen_vit_segments(dev)
    sites.append(("Qwen ViT window tiles (24, 128, 3*1280) d=80, segment ids",
                  False, (randn(24, 128, 3 * 1280), 16),
                  dict(segment_ids=tile_seg.repeat(4, 1).reshape(24, 128))))
    sites.append(("Qwen ViT windowed (1, 5120, 3*1280) d=80, 81 window segments",
                  True, (randn(1, 5120, 3 * 1280), 16),
                  dict(segment_ids=bucket_seg[None])))
    sites.append(("Qwen ViT full (1, 5120, 3*1280) d=80, segment 0 / -1 pads",
                  False, (randn(1, 5120, 3 * 1280), 16),
                  dict(segment_ids=full_seg[None])))
    sites.append(("Qwen decoder prefill (16, 1280, 36*128) d=128, GQA 28/4, "
                  "causal, kv_mask", False, (randn(16, 1280, 36 * 128), 28),
                  dict(kv_heads=4, causal=True,
                       kv_mask=lengths_mask(16, 1280, 1200, 1280))))

    for label, main, args, kw in sites:
        if len(args) == 2:
            packed, heads = args
            split = A._split_packed(packed, heads, kw.get("kv_heads"))[:3]
            fn = lambda: A.flash_attention_flat_packed(packed, heads, **kw)  # noqa: E731
            plain_fn = lambda: A.attention_flat_reference(*split, heads, **kw)  # noqa: E731
        else:
            fn = lambda: A.flash_attention_flat(*args, **kw)  # noqa: E731
            plain_fn = lambda: A.attention_flat_reference(*args, **kw)  # noqa: E731
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        bad = outside(out, ref, ATTN_ATOL, ATTN_RTOL)
        ok = bad == 0 and bool(torch.isfinite(out).all())
        record("flash_attention_flat", label, out, ref, ok,
               f"{bad} elements outside atol {ATTN_ATOL} + rtol {ATTN_RTOL}",
               fn, plain_fn, main)
    return results


def qwen_vit_segments(dev):
    """Window segment ids of Qwen2.5-VL-7B's ViT at the two layouts: the
    tiled one of a 300x380 image (smart-resized to 308x392, 616 patches in
    5 tiles, bucket 768) and the untiled one of a 1024x1024 image (980x980,
    4900 patches whose tiles overflow bucket 5120), with its full-attention
    ids (0 on patches, -1 on pads)."""
    from t2v_metrics_tpu_torch.models.qwen2vl import QWEN2_VL_MODELS
    from t2v_metrics_tpu_torch.models.qwen2vl_adapter import _padded_geometry

    vis = QWEN2_VL_MODELS["qwen2.5-vl-7b"]["config"].vision
    *_, tile_seg, _, _, tiled = _padded_geometry(vis, (1, 22, 28), 616, 768)
    check(tiled, "300x380 should take the tiled window layout")
    *_, bucket_seg, full_seg, _, tiled = _padded_geometry(vis, (1, 70, 70), 4900, 5120)
    check(not tiled, "1024x1024 should take the untiled window layout")
    return tuple(torch.from_numpy(a).to(dev) for a in (tile_seg, bucket_seg, full_seg))


# ---------------------------------------------------------------------------
# Phase 3: the full-width chain, card (bf16, kernels) against CPU (fp32, plain)
# ---------------------------------------------------------------------------

def seeded_images(n: int, seed: int, h: int = 300, w: int = 380) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def seeded_texts(n: int, seed: int) -> list[str]:
    words = ("a red cube on a wooden table two dogs running across "
             "green field small cat asleep under blue lamp old city street "
             "at night").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=rng.integers(3, 8))) for _ in range(n)]


def chain_config(layers_vit: int = 2, layers_t5: int = 2):
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS

    cfg = CLIP_T5_CONFIGS["clip-flant5-xl"]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=layers_vit),
        t5=dataclasses.replace(cfg.t5, enc_layers=layers_t5, dec_layers=layers_t5))


@torch.no_grad()
def fold_t5_attention_scale(params, cfg) -> None:
    """Scale T5's self- and cross-attention W_q by 1/sqrt(d_kv), in place.

    T5 checkpoints carry the attention scale folded into W_q (HF T5 draws q
    with std (d_model*d_kv)^-0.5). The random init's std 0.02 puts the
    unscaled T5 scores at std ~6.5 at xl widths: near-argmax attention that
    turns bf16 rounding into 0.1-0.2 nats between any two bf16 evaluations
    of a 2+2-layer chain, kernels or not, and ~1.5 nats at 24+24 layers.
    With the fold (x 1/8, exact in bf16) a comparison measures the code.
    """
    inner = cfg.t5.num_heads * cfg.t5.d_kv
    for blk in [*params.t5.encoder.blocks, *params.t5.decoder.blocks]:
        blk.attn.qkv.w[:, :inner] *= cfg.t5.d_kv ** -0.5
    for blk in params.t5.decoder.blocks:
        blk.cross.q.w *= cfg.t5.d_kv ** -0.5


def phase_chain(cfg, device: str = "cuda", m: int = 2, n: int = 4) -> None:
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.engine.scoring import CLIPT5Engine
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIPT5Model, init_clip_t5

    card = init_clip_t5(cfg, SEED + 1, device, torch.bfloat16)
    fold_t5_attention_scale(card, cfg)
    host = CLIPT5Model(cfg, "cpu", torch.float32)
    host.load_state_dict({k: t.float().cpu() for k, t in card.state_dict().items()})
    tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
    images, texts = seeded_images(m, 11), seeded_texts(n, 12)
    t0 = time.perf_counter()
    on_card = np.log(CLIPT5Engine(card, cfg, tok, device).score_matrix(images, texts))
    t1 = time.perf_counter()
    on_cpu = np.log(CLIPT5Engine(host, cfg, tok, "cpu").score_matrix(images, texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    log(f"[chain] xl widths, {len(card.vision.blocks)} ViT + "
        f"{len(card.t5.encoder.blocks)}+{len(card.t5.decoder.blocks)} T5 layers, "
        f"M={m} N={n}: card bf16 {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s")
    log(f"[chain] mean answer log-probs card {on_card.ravel().round(4).tolist()}")
    log(f"[chain] mean answer log-probs cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"[chain] max |card - cpu| {diff:.4e} nats (limit {CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          "chain: card scores not finite or wrong shape")
    check(diff <= CHAIN_TOL_NATS, f"chain: card and CPU differ by {diff} nats")
    del card, host


# ---------------------------------------------------------------------------
# Phase 4: the slice through the public entry point
# ---------------------------------------------------------------------------

def phase_slice(model: str = "clip-flant5-xl", device: str = "cuda",
                expected=(95, 47, 122, 0), profile: bool = False) -> dict:
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model=model, init="random", seed=SEED, device=device)
    sync()
    log(f"[slice] {model} random init on {device}: {time.perf_counter() - t0:.2f} s")
    images, texts = seeded_images(4, 21), seeded_texts(8, 22)

    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    sync()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[slice] first forward (4 images x 8 texts): {t_first:.3f} s; "
        f"launches {json.dumps(counts)}")
    check(scores.shape == (4, 8), f"slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          "slice: scores not finite in [0, 1]")
    want = dict(zip(KERNELS, expected))
    check(counts == want, f"slice: launch counts {counts} != {want}")
    again = scorer(images=images, texts=texts)
    check(np.array_equal(scores, again), "slice: second call differs")
    log(f"[slice] log scores row 0: {np.log(scores[0]).round(4).tolist()}")

    pool_images, pool_texts = seeded_images(16, 23), seeded_texts(64, 24)
    data = [{"images": [pool_images[i]], "texts": pool_texts[4 * i:4 * i + 4]}
            for i in range(16)]
    rows = scorer.batch_forward(data, batch_size=8)
    check(rows.shape == (16, 1, 4), f"batch_forward shape {rows.shape}")
    # the same pairs through the pairwise forward, chunk by chunk: the same
    # shapes, so the same numbers
    for lo in (0, 8):
        media, texts_ = scorer._flatten_pairs(data[lo:lo + 8], "images", 8)
        pairwise = scorer.model.forward(media, texts_)
        check(np.array_equal(rows[lo:lo + 8].ravel(), pairwise),
              f"batch_forward rows {lo}..{lo + 7} differ from the pairwise forward")
    log("[slice] batch_forward rows equal the pairwise forward of the same chunks")
    fold_t5_attention_scale(scorer.model.engine.params, scorer.model.config)
    rows = scorer.batch_forward(data, batch_size=8)
    worst = 0.0
    for i, sample in enumerate(data):
        one = scorer(images=sample["images"], texts=sample["texts"])
        worst = max(worst, float(np.abs(np.log(rows[i, 0]) - np.log(one[0])).max()))
    log(f"[slice] T5 scale folded into W_q: batch_forward rows vs per-sample "
        f"forward max {worst:.4e} nats (limit {ROWS_TOL_NATS}); spread "
        f"{float(np.ptp(np.log(rows))):.4e} nats")
    check(worst <= ROWS_TOL_NATS, f"batch_forward rows differ by {worst} nats")

    sync()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=8)
    sync()
    pairs_s = 64 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    sync()
    fwd_s = 32 / (time.perf_counter() - t0)
    log(f"[slice] pairs/s after warm-up: batch_forward (64 pairs, batch 8) "
        f"{pairs_s:.2f}; forward (4 x 8) {fwd_s:.2f}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=8),
                      f"{model} batch_forward")
    return counts


# ---------------------------------------------------------------------------
# Qwen2.5-VL-7B: chain (phase 3) and slice (phase 4)
# ---------------------------------------------------------------------------

QWEN = "qwen2.5-vl-7b"


def qwen_chain_config(vit_layers: int = 2, dec_layers: int = 2):
    """Qwen2.5-VL-7B widths cut to one windowed and one full ViT layer and
    ``dec_layers`` decoder layers."""
    from t2v_metrics_tpu_torch.models.qwen2vl import QWEN2_VL_MODELS

    cfg = QWEN2_VL_MODELS[QWEN]["config"]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=vit_layers,
                                        fullatt_block_indexes=(vit_layers - 1,)),
        text=dataclasses.replace(cfg.text, layers=dec_layers))


def phase_qwen_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2) -> None:
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.qwen2vl import Qwen2VLModel, init_qwen2vl

    card = init_qwen2vl(cfg, SEED + 1, device, torch.bfloat16)
    host = Qwen2VLModel(cfg, "cpu", torch.float32)
    host.load_state_dict({k: t.float().cpu() for k, t in card.state_dict().items()})
    tok = t2v.SimpleT5Tokenizer(cfg.text.vocab_size)
    images, texts = seeded_images(m, 31), seeded_texts(n, 32)
    scorers = [t2v.VQAScore(QWEN, params=p, config=cfg, tokenizer=tok, device=d)
               for p, d in ((card, device), (host, "cpu"))]
    t0 = time.perf_counter()
    on_card = np.log(scorers[0](images=images, texts=texts))
    t1 = time.perf_counter()
    on_cpu = np.log(scorers[1](images=images, texts=texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    log(f"[qwen chain] 7B widths, {cfg.vision.depth} ViT layers (full at "
        f"{cfg.vision.fullatt_block_indexes}) + {cfg.text.layers} decoder layers, "
        f"M={m} N={n} 300x380 images: card bf16 {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s")
    log(f"[qwen chain] mean answer log-probs card {on_card.ravel().round(4).tolist()}")
    log(f"[qwen chain] mean answer log-probs cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"[qwen chain] max |card - cpu| {diff:.4e} nats (limit {QWEN_CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          "qwen chain: card scores not finite or wrong shape")
    check(diff <= QWEN_CHAIN_TOL_NATS, f"qwen chain: card and CPU differ by {diff} nats")


def phase_qwen_slice(model: str = QWEN, device: str = "cuda", side: int = 1024,
                     profile: bool = False) -> dict:
    """``VQAScore("qwen2.5-vl-7b", init="random")``: 4 x 4 on 1024x1024
    images (980x980 after smart_resize, 4900 patches in bucket 5120; the
    window tiles overflow it, so the windowed layers run over the whole
    bucket under segment ids), then ``batch_forward`` on 300x380 images (the
    tiled layout, 6 tiles of 128 rows)."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    sync()
    log(f"[qwen slice] {model} random init on {device}: {time.perf_counter() - t0:.2f} s")
    images = seeded_images(4, 41, side, side)
    texts = seeded_texts(4, 42)

    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    sync()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[qwen slice] first forward (4 images {side}x{side} x 4 texts): "
        f"{t_first:.3f} s; launches {json.dumps(counts)}")
    check(scores.shape == (4, 4), f"qwen slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          "qwen slice: scores not finite in [0, 1]")
    # one same-shape image group (one tower call) and one prefill: attention
    # and rope once a layer; RMSNorm twice a layer plus the merger's and the
    # final norm (7B: 60 / 60 / 122)
    vit, layers = scorer.model.config.vision.depth, scorer.model.config.text.layers
    want = {"flash_attention_flat": vit + layers, "layer_norm": 0,
            "rms_norm": 2 * vit + 1 + 2 * layers + 1, "rope_pack": vit + layers}
    if device != "cuda":  # the plain versions launch nothing
        want = dict.fromkeys(want, 0)
    check(counts == want, f"qwen slice: launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          "qwen slice: second call differs")
    log(f"[qwen slice] log scores: {np.log(scores).round(4).tolist()}")

    pool = seeded_images(8, 43)
    pool_texts = seeded_texts(32, 44)
    data = [{"images": [pool[i]], "texts": pool_texts[4 * i:4 * i + 4]}
            for i in range(8)]
    rows = scorer.batch_forward(data, batch_size=4)
    check(rows.shape == (8, 1, 4) and np.isfinite(rows).all(),
          f"qwen batch_forward shape {rows.shape} or values")
    for lo in (0, 4):
        media, texts_ = scorer._flatten_pairs(data[lo:lo + 4], "images", 8)
        pairwise = scorer.model.forward(media, texts_)
        check(np.array_equal(rows[lo:lo + 4].ravel(), pairwise),
              f"qwen batch_forward rows {lo}..{lo + 3} differ from the pairwise forward")
    log("[qwen slice] batch_forward rows (300x380, tiled windows) equal the "
        "pairwise forward of the same chunks")

    sync()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=4)
    sync()
    pairs_s = 32 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    sync()
    fwd_s = 16 / (time.perf_counter() - t0)
    log(f"[qwen slice] pairs/s after warm-up: batch_forward (32 pairs of 300x380, "
        f"batch 4) {pairs_s:.2f}; forward (4 x 4 at {side}x{side}) {fwd_s:.2f}")
    if device == "cuda":
        log(f"[qwen slice] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"allocated; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=4),
                      f"{model} batch_forward 300x380")
        phase_profile(lambda: scorer(images=images, texts=texts),
                      f"{model} forward 4 x 4 at {side}x{side}")
    return counts


# ---------------------------------------------------------------------------
# Optional phase (--profile): where the device time of batch_forward goes
# ---------------------------------------------------------------------------

# kernel families by substrings of the kernel's name; the rest is "other"
# (elementwise ops, gathers, copies, log-softmax)
KERNEL_FAMILIES = (("attention", ("flash_flat_kernel",)),
                   ("rope", ("rope_kernel",)),
                   ("rms_norm", ("rms_kernel",)),
                   ("layer_norm", ("ln_kernel",)),
                   ("gemm", ("gemm", "nvjet", "cutlass", "xmma")))


def kernel_family(name: str) -> str:
    name = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES
                 if any(k in name for k in keys)), "other")


def phase_profile(run, label: str) -> None:
    """Device time of one call of ``run`` by kernel family (torch.profiler,
    device events only), and the device's busy share: the summed device time
    over the wall time of the same call run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms, launches = {}, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        fam = kernel_family(evt.name)
        ms[fam] = ms.get(fam, 0.0) + evt.device_time_total / 1e3
        launches[fam] = launches.get(fam, 0) + 1
    total = sum(ms.values())
    check(total > 0, "profile: the trace holds no device time")
    for fam in sorted(ms, key=ms.get, reverse=True):
        log(f"[profile] {label}: {fam}: {ms[fam]:.2f} ms, {launches[fam]} "
            f"device events, {100 * ms[fam] / total:.1f}%")
    log(f"[profile] {label}: device time {total:.2f} ms; unprofiled wall "
        f"{wall_ms:.2f} ms; device busy {100 * total / wall_ms:.1f}%")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batch_forward of each slice (and the "
                         "Qwen forward at 1024x1024) with torch.profiler and "
                         "print the device time by kernel family")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-2); prints "
                         "no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    results = phase_kernels()
    if args.kernels_only:
        return 0
    phase_chain(chain_config())
    phase_qwen_chain(qwen_chain_config())
    counts = phase_slice(profile=args.profile)
    torch.cuda.empty_cache()
    qwen_counts = phase_qwen_slice(profile=args.profile)
    table = [{"name": name, "route": route, "source": src, "replaces": rep,
              "launches": counts[name] + qwen_counts[name],
              "max_abs_err": results[name]["max_abs_err"],
              "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
             for name, (route, src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
