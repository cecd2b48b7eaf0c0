#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile] [--kernels-only]

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card's name and power limit; build every kernel of the
     clip-flant5 (bf16 and W8A8), Qwen2.5-VL, Qwen3-VL, Gemma 3, CLIPScore
     and ITMScore paths from the sources in this checkout (one nvcc per CUDA
     source, started together: the flat flash attention at head dims
     64/72/80/88/128/256 and the per-head one at 64/72/80/128/256, the MoE
     grouped GEMM, the int8 GEMM, LayerNorm and RMSNorm (one row-norm body);
     Triton for the rotary embedding with the qk-norm folded in and the
     per-row int8 quant) and time the build;
  checkpoint: the whole clip-flant5-xl (random bf16 weights from a seed, the
     T5 scale folded into W_q) written by this script's own HF key map and
     safetensors writer as 4 shards and ``model.safetensors.index.json`` in
     a temporary directory (free disk checked first, removed after), loaded
     with ``VQAScore("clip-flant5-xl", checkpoint=dir)`` on the card, and a
     seeded 4 x 8 set scored bitwise equal to the same weights passed as
     ``params=``, with its launch counts; prints load seconds and GB/s, host
     RSS growth and the device peak at load against the weights' bytes; the
     checkpoint is staged as the repo's snapshot in a temporary hub cache
     (``models--zhiqiulin--clip-flant5-xl/snapshots/<rev>/`` and
     ``refs/main``) and kept for the next phase;
  genai_bench: GenAI-Bench image evaluation through the port's harness, as
     an offline user runs it (BASELINE config 3): a staged
     ``GenAI-Image-1600`` fixture (16 prompts x 6 models, seeded Likert
     ratings, every skill tag) read by ``GenAIBench_Image`` with a seeded
     1024x1024 image for each of its 96 items, scored by
     ``cli.genai_image_eval.load_or_compute_scores`` with ``--cache_dir`` the
     staged hub cache (the snapshot found and loaded by ``get_score_model``;
     pairs/s, launch counts against the code's), bitwise equal to
     ``VQAScore(checkpoint=<snapshot>)`` on the same arrays, the npz cache hit
     building no scorer, the skill tables, correlations and per-skill JSON;
     then TIFA160 (``TIFA160_DSG``, BASELINE config 2, 80 staged items at
     512x512) through ``batch_forward`` and ``evaluate_scores`` on the same
     scorer; no pandas, sklearn, Pillow, cv2 or matplotlib imported;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the clip-flant5-xl/xxl, Qwen2.5-VL-7B, Qwen3-VL-30B-A3B and
     Gemma-3-4B paths give it (the per-head kernel also with the in-kernel
     T5 bias at the clip-flant5-xl shapes), with its tolerance, CUDA-event
     times, its bound (the least time the card could take: bytes over 3.35
     TB/s or operations over the peak rate of their type) and, where one
     PyTorch call computes the same function, that call's time; LayerNorm
     also with the residual add folded in, at each of its four sites,
     RMSNorm at each of its sites alone and through its add entry (the
     residual add folded in; also at the T5-xl and -xxl encoders' (20480,
     2048 / 4096)), the decoders' qk-norm folded into the rotary embedding
     (Qwen3-VL's 32 + 4 heads of 128, Gemma 3's 8 + 4 of 256 with the
     offset); and
     at the CLIPScore / ITMScore shapes: the flat kernel at the EVA ViT-g
     site (head dim 88, with two wrong plain versions that must fail), the
     Q-Former's cross- and self-attention and the CLIP text tower's causal
     attention, LayerNorm at d 1408 and add + LN at d 768, eps 1e-12; and
     at the video shapes: the flat kernel at the Qwen2.5-VL-7B ViT's full
     layers over a 40-frame clip (1, 16384) and at the Qwen3-VL ViT (1,
     12288), both with the pads under segment -1, and at Gemma-3-4B's
     10-frame prefill in bucket 4096 (the 1024 window and ten image blocks
     both live, with two wrong plain versions that must fail: no window, no
     overlay), the per-head kernel at SigLIP-896 over 10 frames; and at the
     decode sites of generation (one generated token a sequence against a
     KV cache, DECODE_STEP steps in): the flat kernel at sq = 1 over cache
     views (Qwen2.5-VL-7B: 4 sequences, GQA 28/4, pad slots in kv_mask;
     Gemma-3-4B: 2 sequences past a 4096-slot prompt bucket, GQA 8/4, the
     1024 window biting, with two wrong plain versions that must fail: no
     window, a window of 1023), the T5-xl decoder step (self-attention over
     cpos + 1 cached keys with the bias row offset to cpos, dense in the
     flat kernel and in the per-head kernel's table; cross-attention over
     640 encoder rows), RMSNorm (alone and with the add) and rope at one row
     a sequence, the qk-norm + rope of a Qwen3-VL decode step, the grouped
     GEMM at 4 tokens' 32 routed rows of 128 experts, the int8 GEMM and the
     row quant at M = 4; and at the sites of PaliGemma, Gemma 4, LLaVA-1.5
     and InstructBLIP (``family_kernels``: PaliGemma's MQA 8/1 prefill with
     one bidirectional group over each whole prompt at 448 and 896 px,
     Gemma 4-31b's d = 128 band with ten image blocks and Gemma 4-12b's GQA
     16/8, LLaVA-7b's MHA prefill, SigLIP-224/448 in the flat kernel, the
     Q-Former over 32 queries + the instruction, the T5-xl encoder over 32
     query rows + the prompt, three decode sites, each with two wrong
     plain versions that must fail; RMSNorm (alone and with the add) at d
     2048 / 3840 / 4096 / 5376 and rope on the new packed layouts); and at
     the sites of InternVL and
     Molmo2 (``new_family_kernels``: InternViT-300M's packed attention at d
     64 over 1025 rows for 10 and 32 tiles, InternViT-6B's separate q, k, v
     at d 128 over 1025 rows, internvl3.5-8b's prefill over 16 x ~2650 rows
     and its 32-tile video prefill over 2 x ~8330 rows (GQA 32/8, causal,
     kv_mask), its decode step over ~2700 slots, molmo2-4b's prefill and
     decode at d 80, each with two wrong plain versions that must fail;
     RMSNorm (alone and with the add) at 3200, LayerNorm at 4096 / 12800,
     add + LN at 1024 eps 1e-6, the qk-norm + rope of 32 + 8 heads, rope on
     40 heads of 128 and of 80); and at
     the sites of the Qwen3-Omni audio tower (``omni_kernels``: the flat
     kernel with segment ids over a 300 s clip's 3750 rows and over a
     4-clip call, each with two wrong plain versions that must fail;
     LayerNorm and add + LN at (3750, 1280)), the float64 log-mel of 300 s
     against the CPU's; and at the sites of Qwen3-Omni's speech path at HF's
     talker widths (``talker_kernels``: the flat kernel at the talker's
     prefill and decode step (GQA 16/2 at d 64), the code predictor's step
     (GQA 16/8 at d 128) and a 325-row Code2Wav chunk (causal, window 72),
     each with two wrong plain versions that must fail; the grouped GEMM at
     the talker's gate_up and down over a prefill's and a decode token's
     routing; RMSNorm (alone and with the add) at 1024, the qk-norm + rope of
     16 + 2 heads of 64 and 16 + 8 of 128, rope on 18 heads of 64, 24 of 128
     and 32 of 64, the ConvNeXt
     LayerNorm at (650 / 1300, 1024)); and the exact resize at each
     Pillow-resize site's shape, bitwise the CPU's, with its time
     (``resize_sites``) (``--kernels-only`` stops here, with no result
     line);
  3. the full-width chains (clip-flant5-xl widths with 2 ViT and 2+2 T5
     layers; Qwen2.5-VL-7B widths with 2 ViT layers, one windowed and one
     full, and 2 decoder layers; Qwen3-VL-30B-A3B widths with 2 ViT and 2
     decoder layers of 128 experts, deepstack at ViT layers 0 and 1;
     clip-flant5-xxl widths with 2 ViT and 2+2 T5 layers in bf16, ``int8``
     and ``int8+vit`` on the same int8 weights; Gemma-3-4B widths with 2
     SigLIP layers at 896 px and 2 decoder layers, one sliding and one full)
     on the card in bf16 with the kernels, against the CPU in fp32 with the
     plain versions, on one set of random parameters each; and the
     clip-flant5-xl chain under ``INKERNEL_REL_BIAS`` (the per-head kernel
     with the T5 bias in the kernel) against its dense-bias path on the same
     parameters, both on the card; CLIPScore at ViT-B/32 widths (2 vision +
     2 text layers) and ITMScore at blip2-itm widths (2 EVA + 2 Q-Former
     layers, one with cross-attention), card bf16 against CPU fp32; the
     Qwen2.5-VL, Qwen3-VL and Gemma chains again on seeded clips decoded in
     memory (8 frames of 480x640; Gemma takes 4), card bf16 against CPU fp32;
     generation on the xl, Qwen2.5-VL, Qwen3-VL and Gemma (video, untied
     head) chains' models: the CPU's fp32 greedy tokens forced through the
     prefill and GEN_STEPS cached steps on both sides, log P(next token)
     card against CPU a step and, on the card, the cached steps against
     one teacher-forced pass over the same slots, both within the chain's
     bar; for Qwen, ``forward_with_trace`` (one token, start) against
     ``forward_with_trace_teacher_forcing`` on the card (printed); the
     PaliGemma-448, LLaVA-7b and InstructBLIP-xl chains (2 tower + 2
     decoder layers, or 2 EVA + 2 Q-Former + 2+2 T5 layers with the T5
     scale folded) on 1024x1024 images, card bf16 against CPU fp32 (5e-2
     and 2.5e-2 nats), and Gemma 4 at 12b and 31b widths through forced
     tokens (``generation_chain``, 5e-2 a row and a step); internvl3.5-8b
     (a 1024x1024 image, 10 tiles), internvl3.5-38b (the 6B tower's RMSNorm
     blocks and flattened qk-norm) and internvl3.5-30b-a3b (the MoE) at 2
     tower + 2 decoder layers on one image x 2 texts (5e-2 nats, launch
     counts against the code's) and molmo2-8b through forced tokens (5e-2
     a row and a step); qwen3-omni-30b-a3b at 2 audio + 2 vision + 2
     thinker layers on image + audio, audio-only and image-only pairs (5e-2
     nats, launch counts against the code's); Qwen3-Omni's speech path at
     HF's widths cut to 2 talker layers of 128 experts with the shared
     expert, 2 code predictor layers and Code2Wav's conv stack behind 2
     transformer layers (``phase_talker_chain``: the CPU's greedy codec
     frames forced through card bf16 and CPU fp32, each talker step within
     0.3 nats and each predictor step within 5e-2, the waveform within 5% of
     rms(CPU));
  4. the slices through the public entry point, each with the kernel launch
     counts of its first call (checked against the counts the code gives),
     ``batch_forward``, pairs/s and its peak device memory, each slice's
     model freed before the next is built:
     ``VQAScore("clip-flant5-xl", init="random")``,
     ``VQAScore("qwen2.5-vl-7b", init="random")`` (1024x1024 images, which
     take the untiled window layout, then 300x380 images through
     ``batch_forward``, which take the tiled one),
     ``VQAScore("qwen3-vl-30b-a3b", init="random")`` (1024x1024 images),
     (the xl bf16 and the qwen2.5-vl-7b slices also score 4 seeded BGR float
     ``.npy`` images by path at 300x380 and at 1024x1024, bitwise equal to
     their flipped and clipped arrays (``[npy]``); the xl slice loads a
     seeded FFV1 clip written with cv2 through ``media.video_utils``'s
     ``ApolloMMLoader`` and scores its first clip's ``concatenate_grid``
     collage (``[apollo]``; one line says so where cv2 is absent))
     ``VQAScore("gemma-3-4b-it", init="random")`` (1024x1024 images) and
     ``VQAScore("clip-flant5-xxl", init="random", quant=q)`` for q in None,
     "int8", "int8+vit", with each int8 mode's score gap from bf16 on the
     same rows; ``CLIPScore("openai:ViT-B-32", init="random")`` (8 x 32,
     ``batch_forward`` of 64 x (1, 4)) and ``ITMScore("blip2-itm",
     init="random")`` (39 EVA + 12 Q-Former layers, 1.17 B parameters; 4 x 8,
     ``batch_forward`` of 16 x (1, 4)); each Qwen and Gemma slice then scores
     video on the same model: seeded clips of 5 s at 30 fps, 480x640, decoded
     in memory (``media.video.DecodedVideo``, the way in where no video
     reader is installed), 2 clips x 4 texts and ``batch_forward`` of 4 x (1 clip, 4
     texts) (Qwen2.5-VL-7B at fps 8: 40 frames, ViT bucket 16384, prompts in
     4096; Qwen3-VL: 12288 and 3072; Gemma: 10 frames, 4096); with
     ``--profile``, the device time of one ``batch_forward`` of each, and of
     the Qwen forwards at 1024x1024, by kernel family (torch.profiler) and
     the device's busy share; then generation on the same models:
     ``generate`` of 4 images x 32 tokens (clip-flant5-xl, qwen2.5-vl-7b at
     1024x1024, qwen3-vl-30b-a3b), 4 x 8 (xxl ``int8``), Gemma's batched
     path over 2 seeded clips (10 frames, prompts in bucket 4096) and its
     per-sequence path over one image, x 32 tokens; each prints the prefill
     ms, the median ms a decode step on the card and the host's enqueue ms
     a step, the steps run, generated tokens/s, the peak memory beside the
     KV cache's bytes and the launches a decode step by kernel (with
     ``--profile`` also the busy share of a generate); qwen2.5-vl-7b also
     ``forward_with_trace`` at max_new_tokens 1 and 4, start and end; then
     ``VQAScore("paligemma-3b-mix-448" / "gemma-4-12b-it" /
     "llava-v1.5-7b" / "instructblip-flant5-xl", init="random")`` at full
     depth: 4 x 4 on 1024x1024 images with launch counts against the
     code's, ``batch_forward`` of 8 x (1, 4), pairs/s, peak memory at load
     and while scoring, and ``generate`` of 8 tokens (PaliGemma one
     sequence, LLaVA and InstructBLIP 4; Gemma 4's score is its rollout);
     ``VQAScore("internvl3.5-8b" / "molmo2-8b", init="random")`` at full
     depth: 4 x 4 on 1024x1024 images (10 tiles an image for InternVL),
     ``batch_forward`` of 8 x (1, 4) at 300x380 (13 tiles), one seeded clip
     as a ``DecodedVideo`` x 2 texts (32 tiles, or 8 frames for Molmo2),
     each with launch counts against the code's, pairs/s, peak memory, and
     ``generate`` of 8 tokens over the 4 images; ``VQAScore(
     "qwen3-omni-30b-a3b", init="random")``, the whole thinker: 4 x 4 on
     1024x1024 images each with a seeded 10 s .wav, 8 x (1, 4) audio-only
     with 30 s clips, one clip x 2 texts, each with launch counts against
     the code's, pairs/s and peak memory (``--profile``: the image + audio
     and audio-only calls' busy share); then the same thinker with a random
     talker and Code2Wav at HF's widths (``phase_talker_slice``: generate
     batched and per sequence, forward_with_trace, generate(return_audio=
     True) greedy and sampled, chunked_decode of 600 frames; launch counts
     against the code's, ms a thinker step, ms a talker frame by part,
     frames/s, Code2Wav ms a chunk, peak memory).
  parallel (``phase_parallel``; phase 2 also checks its per-rank kernel
     sites, ``parallel_kernels``): parallel/ as two ranks on the one card
     over a gloo group (NCCL refuses two ranks on one GPU), spawned with a
     time limit; a rank that fails or hangs fails the run. Each case is
     run first as one rank in this process: tp 2 on clip-flant5-xxl's
     2+2-layer chain, bf16 (the chain bar) and ``int8`` (0.1 nats; the
     row-parallel products' int32 partials all-reduced, the row absmax
     all-reduced before the quantize); tp 2 on the whole xxl, 4 x 4 pairs
     (bitwise the same on both ranks, launch counts against the code's,
     each rank's peak beside its ``abstract_sharded_params`` bytes,
     pairs/s of two ranks sharing one card, not a multi-GPU rate); dp 2 on
     the whole xl, 32 pairs split by image through ``batch_forward``
     (bitwise one rank's on the same two chunks); pp 2 on the xl encoder,
     12 + 12 layers, 4 microbatches of 4 x 640 rows (bitwise one rank's
     encode of each microbatch, else 1e-3 of the rms); sp 2 on the xl
     chain (320 of 640 encoder rows a rank; the chain bar); ep 2 on
     qwen3-vl-30b-a3b widths, 2 ViT + 2 decoder layers (64 of 128 experts a
     rank; 5e-2 nats on pairs routed alike, 0.3 apart); each rank's launch
     counts and bytes staged through the host; then NCCL at world 1
     through parallel/comm.py.
Before the last lines, ``[time]``: each stage's wall seconds and the Triton
variants the run compiled. The last lines are the kernel table (JSON;
``launches`` is a kernel's count
summed over the first calls of the checkpoint-loaded xl, the GenAI-Bench
and TIFA160 calls, the sixteen slices and the video slices and calls, over
the generate and trace runs, and over both ranks of each parallel case; a
row's
``sites`` are
further shapes of the main path, each with its times, bound and library
time: the grouped GEMM's down projection, the int8 GEMM's split-K decoder
shape, LayerNorm's other shapes and its add + LayerNorm entry, the flat
kernel's CLIPScore / ITMScore, video and decode sites, each kernel's decode
site, the per-rank sites of the parallel phase), the card's name and power limit, and ``{"ok": true,
"device": {...}}``.

Needs torch with CUDA, nvcc (``/usr/local/cuda`` or ``CUDA_HOME``) and triton;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time

# the ~31 B bf16 parameters of qwen3-vl-30b-a3b follow two freed slices: let
# the caching allocator grow segments rather than fragment (set before CUDA
# starts)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SEED = 0
WARMUP, ITERS = 3, 20

# Tolerances of the kernel checks, |kernel - plain| <= atol + rtol*|plain|.
# Norms: both sides round one fp32 value to bf16, and its last bits depend
# on the summation order and on the kernel's fused multiply-add, so a result
# may land one bf16 ulp away (rtol 8e-3); T5's RMSNorm rounds twice (the
# normalized value, then the product), so two (1.6e-2); atol 1e-5 covers
# results near zero, where the bias add cancels.
LN_RTOL, RMS_RTOL, NORM_ATOL = 8e-3, 1.6e-2, 1e-5
# Attention: P is rounded to bf16 against the running max of each key tile
# in the kernel and against the row max in the plain version, the sums run
# in another order, and each side rounds its output to bf16 once. So per
# element |kernel - plain| <= ATTN_ATOL_RMS * rms(plain) + ATTN_RTOL *
# |plain| (rtol 2^-7: one bf16 rounding flip; atol: the P roundings, scaled
# to the outputs compared, which are ~0.026 at the SigLIP shape and O(1) at
# the T5 sites), and over the tensor rms(kernel - plain) <= ATTN_RMS_RATIO *
# rms(plain). A scale of 1/8 for 1/sqrt(72) moves the SigLIP outputs by ~6%
# of their rms and a dropped last key tile by ~12%: the SigLIP check runs
# both as negative controls, which must fail it.
ATTN_ATOL_RMS, ATTN_RTOL, ATTN_RMS_RATIO = 5e-2, 2 ** -7, 1e-2
# Rotary embedding: both sides round one f32 value to bf16; the kernel may
# fuse a multiply-add the plain version rounds twice, so one bf16 ulp.
ROPE_RTOL = 8e-3
# The qk-norm folded into the rotation: each side rounds the normalized head
# to bf16 (T5's cast twice) before it rotates, so each of a normalized pair
# (n1, n2) may differ by two bf16 ulps, 2^-6 of itself, and a rotated value
# n1 cos - n2 sin by up to 2^-6 hypot(n1, n2), whatever its own size (the
# rotation may cancel): |out - ref| <= NORM_ATOL + ROPE_RTOL * |ref| +
# QK_ROPE_PAIR_RTOL * hypot(n1, n2) per element, with the plain version's n
# and 2^-6 = 1.6e-2 under QK_ROPE_PAIR_RTOL.
QK_ROPE_PAIR_RTOL = 2.5e-2
# Chain: bf16 on the card against fp32 on the CPU, 2+2 T5 layers, with the
# T5 attention scale folded into W_q (see phase_chain): bf16 against fp32 of
# the same chain on the CPU differs by ~6e-3 nats, so 2.5e-2 is ~4x that.
CHAIN_TOL_NATS = 2.5e-2
# Slice: per-sample forward rows against batch_forward rows, with the T5
# attention scale folded into W_q as in the chain. The two run other GEMM
# shapes (1 image, 4 pairs against 8 images, 32 pairs), so other cuBLAS
# tilings and bf16 roundings: measured 0.037 nats at 24+24 layers with the
# fold (and 1.5 nats without it, where near-argmax attention amplifies them).
# xxl (24+24 layers at d_model 4096) amplifies them more: measured 0.082
# nats in bf16 on an H100 80GB HBM3 at 700 W, so 0.25; in the int8 modes the T5
# products are exact per row, but the bf16 ViT / projector / lm_head GEMMs
# still change with the batch, and an int8 rounding flip downstream is a
# whole int8 step: 0.238 nats under int8, so 0.6.
ROWS_TOL_NATS = {("clip-flant5-xl", None): 0.1, ("clip-flant5-xxl", None): 0.25,
                 ("clip-flant5-xxl", "int8"): 0.6, ("clip-flant5-xxl", "int8+vit"): 0.6}
# Qwen chain: 7B widths, 2 ViT + 2 decoder layers, bf16 on the card against
# fp32 on the CPU. Random init gives q.k scores of std ~1 (no fold needed);
# the bf16 roundings of ~12 matmuls and the 152064-way log-softmax put the
# gap near 1e-2 nats, so the limit is 5x that.
QWEN_CHAIN_TOL_NATS = 5e-2
# Grouped GEMM: kernel and plain version both sum in fp32 and round once to
# bf16, in other orders, so a result may land one bf16 ulp away (rtol
# 2^-7); atol 1e-4 covers sums that cancel to near zero.
GMM_RTOL, GMM_ATOL = 2 ** -7, 1e-4
# Qwen3 chain: 30b-a3b widths, 2 ViT + 2 decoder layers of 128 experts,
# bf16 on the card against fp32 on the CPU. Besides the roundings of the
# Qwen2.5 chain, the router's bf16 logits swap the 8th and 9th expert of
# some tokens, each such swap moving ~1/12 of that token's MoE output:
# predicted ~2e-2 nats, limit 5e-2 as for Qwen2.5.
QWEN3_CHAIN_TOL_NATS = 5e-2
# The int8 GEMM and the row quant: bitwise (an exact int32 sum and the same
# f32 operations, each correctly rounded, in the kernel and the plain
# version). xxl int8 chain: see phase_xxl_chain.
XXL_INT8_CHAIN_TOL_NATS = 0.1
# Gemma chain: 4b widths, 2 SigLIP layers at 896 px + 2 decoder layers, bf16
# on the card against fp32 on the CPU: the Qwen chains' roundings (a 4096-
# patch tower, ~12 matmuls, the 262208-way log-softmax) and the Gemma norms
# multiplied in fp32; limit 5e-2 as for Qwen.
GEMMA_CHAIN_TOL_NATS = 5e-2
# The xl chain with the T5 bias in the per-head kernel against the dense
# bias in the flat kernel, both on the card in bf16: the same GEMMs, the
# same fp32 bias values and the same tile order in both kernels, so only
# the two kernels' own instruction schedules differ; limit as the chain's.
INKERNEL_TOL_NATS = CHAIN_TOL_NATS

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W) for the
# bound: the larger of bytes over the HBM rate and operations over the peak
# rate of their type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

# ptxas usage (registers, spill store bytes, spill load bytes) of the attention
# instantiations without segment ids, keyed (head dim, consumer warpgroups,
# BAND, REL), as built before the segment-id tile plan (nvcc 12.8, sm_90a): the
# plan's code sits behind SEG, so phase_build prints today's beside these
SEG_FALSE_PTXAS = {
  "flash_flat": {
    (64, 1, 0, 0): (168, 0, 0), (64, 1, 1, 0): (136, 0, 0), (64, 2, 0, 0): (168, 0, 0),
    (64, 2, 1, 0): (168, 0, 0), (72, 1, 0, 0): (128, 0, 0), (72, 1, 1, 0): (136, 0, 0),
    (72, 2, 0, 0): (168, 0, 0), (72, 2, 1, 0): (168, 0, 0), (80, 1, 0, 0): (128, 0, 0),
    (80, 1, 1, 0): (136, 0, 0), (80, 2, 0, 0): (168, 0, 0), (80, 2, 1, 0): (168, 0, 0),
    (88, 1, 0, 0): (138, 0, 0), (88, 1, 1, 0): (152, 0, 0), (88, 2, 0, 0): (168, 0, 0),
    (88, 2, 1, 0): (168, 0, 0), (128, 1, 0, 0): (152, 0, 0), (128, 1, 1, 0): (168, 0, 0),
    (128, 2, 0, 0): (168, 0, 0), (128, 2, 1, 0): (168, 0, 0), (256, 1, 0, 0): (216, 0, 0),
    (256, 1, 1, 0): (224, 0, 0), (256, 2, 0, 0): (168, 0, 0), (256, 2, 1, 0): (168, 0, 0)},
  "flash_attention": {
    (64, 1, 0, 0): (168, 0, 0), (64, 1, 0, 1): (167, 0, 0), (64, 2, 0, 0): (168, 0, 0),
    (64, 2, 0, 1): (168, 0, 0), (72, 1, 0, 0): (128, 0, 0), (72, 1, 0, 1): (168, 0, 0),
    (72, 2, 0, 0): (168, 0, 0), (72, 2, 0, 1): (168, 0, 0), (80, 1, 0, 0): (128, 0, 0),
    (80, 1, 0, 1): (168, 0, 0), (80, 2, 0, 0): (168, 0, 0), (80, 2, 0, 1): (168, 0, 0),
    (128, 1, 0, 0): (152, 0, 0), (128, 1, 0, 1): (196, 0, 0), (128, 2, 0, 0): (168, 0, 0),
    (128, 2, 0, 1): (168, 0, 0), (256, 1, 0, 0): (216, 0, 0), (256, 1, 0, 1): (254, 0, 0),
    (256, 2, 0, 0): (168, 0, 0), (256, 2, 0, 1): (168, 0, 0)},
}

KERNELS = {
    "flash_attention_flat": ("cuda", "t2v_metrics_tpu_torch/csrc/flash_flat.cu",
                             "t2v_metrics_tpu/ops/attention.py:565"),
    "flash_attention": ("cuda", "t2v_metrics_tpu_torch/csrc/flash_attention.cu",
                        "t2v_metrics_tpu/ops/attention.py:151"),
    "layer_norm": ("cuda", "t2v_metrics_tpu_torch/csrc/layer_norm.cu",
                   "t2v_metrics_tpu/ops/norms.py:65"),
    "rms_norm": ("cuda", "t2v_metrics_tpu_torch/csrc/rms_norm.cu",
                 "t2v_metrics_tpu/ops/norms.py:113"),
    "rope_pack": ("triton", "t2v_metrics_tpu_torch/ops/rope.py",
                  "t2v_metrics_tpu/ops/rope.py:51"),
    "grouped_gemm": ("cuda", "t2v_metrics_tpu_torch/csrc/grouped_gemm.cu",
                     "t2v_metrics_tpu/ops/moe.py:105"),
    "quant_matmul": ("cuda", "t2v_metrics_tpu_torch/csrc/quant_matmul.cu",
                     "t2v_metrics_tpu/ops/quant_matmul.py:48"),
    # no TPU kernel: the jnp chain _quantize_rows
    "quantize_rows": ("triton", "t2v_metrics_tpu_torch/ops/quant.py",
                      "t2v_metrics_tpu/ops/quant.py:52"),
}


def bound(ops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes") for ``ops`` operations
    of type ``kind`` that must move ``nbytes`` through HBM."""
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


STAGES: list[tuple[str, float]] = []


@contextlib.contextmanager
def stage(name: str):
    """Time a stage of the run on the host's clock, into ``STAGES``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STAGES.append((name, time.perf_counter() - t0))


def log_stages() -> None:
    """The wall seconds of each stage, and the Triton variants this run
    compiled (the compile cache starts empty in a new checkout), by kernel."""
    from pathlib import Path

    from t2v_metrics_tpu_torch import build

    build.triton_cache_env()
    compiled: dict[str, int] = {}
    for f in Path(os.environ["TRITON_CACHE_DIR"]).glob("*/*.cubin"):
        compiled[f.stem] = compiled.get(f.stem, 0) + 1
    log("[time] " + "; ".join(f"{name} {sec:.1f} s" for name, sec in STAGES)
        + f"; Triton variants in the cache: {json.dumps(compiled)}")


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


def host_ms(fn, n: int = 20) -> float:
    """Median host milliseconds to enqueue one call of ``fn``, the card idle
    before each (no queue backs the launch up): the Python wrapper, its
    checks and tensor maps, and the launch itself."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def log_host(name: str, label: str, fn) -> None:
    log(f"[kernel] {name} {label}: host enqueue {host_ms(fn):.4f} ms a call")


def outside(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> int:
    """Number of elements with |out - ref| > atol + rtol * |ref|."""
    ref = ref.float()
    return int(((out.float() - ref).abs() > atol + rtol * ref.abs()).sum())


def attention_agrees(out: torch.Tensor, ref: torch.Tensor) -> tuple[bool, str]:
    """(within the attention tolerance, what was measured against it)."""
    out, ref = out.float(), ref.float()
    rms = float(ref.square().mean().sqrt())
    err = out - ref
    atol = ATTN_ATOL_RMS * rms
    bad = int((err.abs() > atol + ATTN_RTOL * ref.abs()).sum())
    ratio = float(err.square().mean().sqrt()) / rms
    ok = bad == 0 and ratio <= ATTN_RMS_RATIO and bool(torch.isfinite(out).all())
    return ok, (f"{bad} elements outside atol {atol:.3e} (= {ATTN_ATOL_RMS} x rms(plain) "
                f"{rms:.3e}) + rtol 2^-7; error rms {ratio:.3e} x rms(plain) "
                f"(limit {ATTN_RMS_RATIO})")


def free_cuda() -> None:
    """Return the memory of dropped tensors to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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
    from t2v_metrics_tpu_torch.ops import quant, rope

    t0 = time.perf_counter()
    build.build_all()          # one nvcc per CUDA source, all at once
    t_nvcc = time.perf_counter() - t0
    # Triton compiles at first launch: launch each kernel once at its widths
    dev = torch.device("cuda")

    def ones(*shape, dtype=torch.bfloat16):
        return torch.ones(shape, device=dev, dtype=dtype)

    # rope with and without the qk-norm (T5's cast; Gemma's offset without
    # it), at the prefills' 16-row blocks
    for hq, hk, d, offset, cast in ((32, 4, 128, 0.0, True), (32, 8, 128, 0.0, True),
                                    (8, 4, 256, 1.0, False), (16, 2, 64, 0.0, True),
                                    (16, 8, 128, 0.0, True)):
        rope.rms_norm_rope_pack(ones(1, 32, (hq + 2 * hk) * d), ones(d), ones(d),
                                ones(1, 32, d, dtype=torch.float32),
                                ones(1, 32, d, dtype=torch.float32), hq, hk, d, 1e-6, offset,
                                cast)
    for heads, d in ((32, 80), (36, 128), (32, 72), (16, 256), (20, 64), (32, 128), (48, 64)):
        rope.rope_pack(ones(1, 32, heads * d), ones(1, 32, d, dtype=torch.float32),
                       ones(1, 32, d, dtype=torch.float32), min(heads, 32), d)
    for d in (1024, 4096, 10240):
        quant.quantize_rows(ones(8, d))
    for d in (2048, 5120):     # the row-parallel K-shards of xxl at tp 2: both steps
        quant.quantize_rows_scaled(ones(8, d), quant.row_absmax(ones(8, d)))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"[build] nvcc flash_flat.cu (head dims 64/72/80/88/128/256) and "
        f"flash_attention.cu (64/72/80/128/256), grouped_gemm.cu, quant_matmul.cu, "
        f"layer_norm.cu and rms_norm.cu in parallel: {t_nvcc:.2f} s; with the Triton "
        f"rotary embedding (with and without the qk-norm) and row quant: {total:.2f} s")
    for lib in ("flash_flat", "flash_attention", "grouped_gemm", "quant_matmul"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] ptxas {lib}: {line.strip()}")
    # the flat kernel at head dim 88 (DP 96) and every attention instantiation:
    # no spills, and no wgmma serialized by ptxas (warnings C7513 / C7515)
    d88 = {k: u for k, u in build.ptxas_usage("flash_flat").items() if "ILi88E" in k}
    check(d88, "flash_flat.cu: no head-dim-88 instantiation in its build log")
    log(f"[build] ptxas flash_flat d=88: {len(d88)} kernels, registers "
        f"{sorted(u[0] for u in d88.values())}, spill bytes "
        f"{sum(u[1] + u[2] for u in d88.values())}")
    check(not any(u[1] or u[2] for u in d88.values()), "flash_flat.cu d=88 spills")
    # the instantiations without segment ids, beside their usage before the
    # segment-id tile plan
    for lib, recorded in SEG_FALSE_PTXAS.items():
        now = {tuple(int(x) for x in (m[1], m[2], m[4], m[5])): u
               for k, u in build.ptxas_usage(lib).items()
               if (m := re.search(r"kernelILi(\d+)ELi(\d)ELb([01])ELb([01])ELb([01])E", k))
               and m[3] == "0"}
        check(set(now) == set(recorded), f"{lib}: SEG=false instantiations {sorted(now)}")
        for key, was in recorded.items():
            log(f"[build] ptxas {lib} SEG=false d={key[0]} WG={key[1]} BAND={key[2]} "
                f"REL={key[3]}: registers, spill stores, spill loads {now[key]} (before the "
                f"segment-id tile plan {was})")
        log(f"[build] ptxas {lib}: {sum(now[k] == v for k, v in recorded.items())} of "
            f"{len(recorded)} SEG=false instantiations as before the segment-id tile plan")
    for lib in ("flash_flat", "flash_attention"):
        serial = [ln for ln in build.build_log(lib).splitlines()
                  if "C7513" in ln or "C7515" in ln]
        log(f"[build] ptxas {lib}: {len(serial)} wgmma serialization warnings")
        check(not serial, f"{lib}: ptxas serializes wgmma: {serial[:2]}")
    # the row norms' 100 small instantiations each, summed up
    for lib in ("layer_norm", "rms_norm"):
        usage = build.ptxas_usage(lib)
        check(usage, f"{lib}.cu: no ptxas lines in its build log")
        regs = [u[0] for u in usage.values()]
        log(f"[build] ptxas {lib}: {len(usage)} kernels, {min(regs)}-{max(regs)} "
            f"registers; spill stores {sum(u[1] for u in usage.values())} bytes, spill "
            f"loads {sum(u[2] for u in usage.values())} bytes in all")


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

    def record(name, label, out, ref, ok, detail, fn, plain_fn, main, flop=None,
               lower=None, library=None, site=False):
        """Check one launch against its plain version and time both. The
        main shape's numbers go into the kernel table: ``lower`` is (ops,
        bytes, type) for its bound; ``library`` (name, ms) of the one
        PyTorch call that computes the same function, or None. A ``site``
        (a second shape of the main path) goes into the row's ``sites``
        with its own bound and library time."""
        err = float((out.float() - ref.float()).abs().max())
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain_fn)
        rate = "" if flop is None else (
            f" ({flop / ms / 1e9:.1f} / {flop / plain_ms / 1e9:.1f} TFLOP/s)")
        log(f"[kernel] {name} {label}: max_abs_err {err:.3e} ({detail}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{rate}")
        check(ok, f"{name} {label} disagrees with its plain version: {detail}")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main or site:
            lo_ms, lo_by = bound(*lower)
            lib_ms = None if library is None else library[1]
            lib = ("no single PyTorch call" if library is None
                   else f"{library[0]} {library[1]:.4f} ms")
            log(f"[kernel] {name} {label} ({'the table' if main else 'a site'}'s shape): "
                f"bound {lo_ms:.4f} ms by {lo_by}; {lib}")
        if main:
            r["ms"], r["plain_ms"] = ms, plain_ms
            r["bound_ms"], r["bound_by"], r["library_ms"] = lo_ms, lo_by, lib_ms
        elif site:
            r.setdefault("sites", []).append(
                {"label": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": lo_ms,
                 "bound_by": lo_by, "library_ms": lib_ms})
        return ms, plain_ms

    # LayerNorm: the CLIP ViT-L ln_pre at (M*577, 1024) and ln1/ln2 at
    # (M*640, 1024), M=4 (the table's shape); the Qwen3-VL ViT (and
    # SigLIP-896) blocks at (M*4096, 1152); the Qwen3-VL deepstack mergers
    # (post-shuffle) at (M*1024, 4608). Each also with the residual add
    # folded in (add_layer_norm: s bitwise the eager x + r, y against the
    # plain LayerNorm of it), whose library yardstick is two calls, x + r
    # then F.layer_norm. Bounds: bf16 in and out, weights once; the add
    # reads x and r and writes s and y.
    for rows, d, main in ((4 * 577, 1024, False), (4 * 640, 1024, True),
                          (4 * 4096, 1152, False), (4 * 1024, 4608, False)):
        x, w, b = randn(rows, d, std=3.0), randn(d), randn(d)
        r = randn(rows, d, std=3.0)
        out, ref = N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b)
        bad = outside(out, ref, NORM_ATOL, LN_RTOL)
        record("layer_norm", f"({rows}, {d})", out, ref, bad == 0,
               f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps",
               lambda: N.layer_norm_fused(x, w, b),  # noqa: B023
               lambda: N.layer_norm_plain(x, w, b), main,  # noqa: B023
               lower=(8 * rows * d, 4 * rows * d + 4 * d, "fp32"),
               library=("F.layer_norm", cuda_ms(
                   lambda: F.layer_norm(x, (d,), w, b, 1e-5))),  # noqa: B023
               site=not main)
        (s, out), s_ref = N.add_layer_norm_fused(x, r, w, b), x + r
        ref = N.layer_norm_plain(s_ref, w, b)
        bad, same = outside(out, ref, NORM_ATOL, LN_RTOL), bool(torch.equal(s, s_ref))
        record("layer_norm", f"add + LN ({rows}, {d})", out, ref, bad == 0 and same,
               f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max "
               f"{bf16_ulps(out, ref)} bf16 ulps; s bitwise x + r: {same}",
               lambda: N.add_layer_norm_fused(x, r, w, b),  # noqa: B023
               lambda: N.add_layer_norm_plain(x, r, w, b), False,  # noqa: B023
               lower=(9 * rows * d, 8 * rows * d + 4 * d, "fp32"),
               library=("x + r, then F.layer_norm (two calls)", cuda_ms(
                   lambda: F.layer_norm(x + r, (d,), w, b, 1e-5))),  # noqa: B023
               site=True)
        del x, r, s, out, ref, s_ref

    # RMSNorm: T5 encoder at (P*640, 2048), decoder at (P*4, 2048), P=32;
    # Qwen2.5-VL-7B ViT at (M*5120, 1280), M=4, decoder at (P*1280, 3584),
    # P=16; each alone and through the add entry (the residual add folded
    # in), and the add entry at the T5-xxl encoder's (P*640, 4096)
    for rows, d, main in ((32 * 640, 2048, False), (32 * 4, 2048, False),
                          (4 * 5120, 1280, False), (16 * 1280, 3584, True),
                          (32 * 640, 4096, None)):
        x, r, w = randn(rows, d, std=3.0), randn(rows, d, std=3.0), randn(d)
        if main is not None:
            rms_site(record, f"({rows}, {d})", x, w, main=main)
        rms_site(record, f"add + RMSNorm ({rows}, {d})", x, w, r=r)
        if d in (3584, 4096):
            rms_grid_check(x, w, r)
        del x, r

    # the qk-norm folded into the rotation: the Qwen3-VL-30B-A3B decoder, 16
    # pairs x 1024 tokens (the 4 x 4 slice at 1024x1024: 984-987-token
    # prompts + 8 in bucket 1024), the 32 q + 4 k heads of 128 of each packed
    # (32 + 2*4) x 128 row, T5's cast; Gemma-3-4b's prefill, 8 + 4 heads of
    # 256 with the offset and no cast
    gen_r = torch.Generator(device=dev).manual_seed(SEED + 3)
    for label, b, s, hq, hk, d, offset, cast in (
            ("Qwen3-VL-30B-A3B", 16, 1024, 32, 4, 128, 0.0, True),
            ("Gemma-3-4b (offset 1)", 16, 1024, 8, 4, 256, 1.0, False)):
        pk, qs, ks = randn(b, s, (hq + 2 * hk) * d, std=3.0), randn(d), randn(d)
        qk_rope_site(record, f"qk-norm + rope {label} ({b}, {s}, {(hq + 2 * hk) * d}), "
                     f"{hq}+{hk} heads of {d} in place", pk, qs, ks,
                     *rope_angles(gen_r, b, s, d), hq, hk, d, offset, cast)
        del pk

    # Rotary embedding on the packed q|k|v rows of Qwen2.5-VL-7B: the ViT
    # (M=4 images x 5120 patch rows, 16 q + 16 k heads of 80, 3840 lanes)
    # and the decoder prefill (P=16 x 1280, 28 q + 4 k heads of 128, 4608);
    # of Qwen3-VL-30B-A3B: the ViT (4 x 4096, 16 + 16 heads of 72, 3456)
    # and the decoder prefill (16 x 1024, 32 + 4 heads of 128, 5120)
    for b, s, lanes, d, rot, main in ((4, 5120, 3840, 80, 32, False),
                                      (16, 1280, 4608, 128, 32, True),
                                      (4, 4096, 3456, 72, 32, False),
                                      (16, 1024, 5120, 128, 36, False)):
        pk = randn(b, s, lanes)
        ang = (torch.randint(0, 4096, (b, s, 1), generator=gen, device=dev).float()
               * randn(d, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        buf = pk.clone()
        out = R.rope_pack(buf, cos, sin, rot, d)     # in place on buf
        ref = R.rope_pack_plain(pk, cos, sin, rot, d)
        bad = outside(out, ref, NORM_ATOL, ROPE_RTOL)
        v_same = bool(torch.equal(out[..., rot * d:], pk[..., rot * d:]))
        record("rope_pack", f"({b}, {s}, {lanes}) {rot} heads of {d}", out, ref,
               bad == 0 and v_same,
               f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps; v lanes untouched {v_same}",
               lambda: R.rope_pack(buf, cos, sin, rot, d),
               lambda: R.rope_pack_plain(pk, cos, sin, rot, d), main,
               lower=(3 * b * s * rot * d, 4 * b * s * rot * d + 8 * b * s * d, "fp32"))

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
                  True, (qkv, 32),
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
                  False, (randn(1, 5120, 3 * 1280), 16),
                  dict(segment_ids=bucket_seg[None])))
    sites.append(("Qwen ViT full (1, 5120, 3*1280) d=80, segment 0 / -1 pads",
                  False, (randn(1, 5120, 3 * 1280), 16),
                  dict(segment_ids=full_seg[None])))
    sites.append(("Qwen decoder prefill (16, 1280, 36*128) d=128, GQA 28/4, "
                  "causal, kv_mask", False, (randn(16, 1280, 36 * 128), 28),
                  dict(kv_heads=4, causal=True,
                       kv_mask=lengths_mask(16, 1280, 1200, 1280))))
    # Qwen3-VL-30B-A3B: the ViT over 4 images of 992x992 (3844 patches in
    # bucket 4096, pads under segment -1), d=72; the decoder prefill
    seg3 = torch.where(torch.arange(4096, device=dev) < 3844, 0, -1).int()
    sites.append(("Qwen3 ViT (4, 4096, 3*1152) d=72, 3844 rows then -1 pads",
                  False, (randn(4, 4096, 3 * 1152), 16),
                  dict(segment_ids=seg3.expand(4, 4096))))
    sites.append(("Qwen3 decoder prefill (16, 1024, 40*128) d=128, GQA 32/4, "
                  "causal, kv_mask", False, (randn(16, 1024, 40 * 128), 32),
                  dict(kv_heads=4, causal=True,
                       kv_mask=lengths_mask(16, 1024, 985, 988))))
    # Gemma-3-4B: the decoder prefill of the 4 x 4 slice (16 pairs of ~290
    # tokens in bucket 512; the image block of 256 tokens at rows 4..259;
    # q_scale 1/16; window 1024 on the sliding layers), and a 2048-row
    # prefill where the window bites and the overlay reopens tiles
    # outside it
    def image_block(b, s, start):
        ids = torch.full((b, s), -1, dtype=torch.int32, device=dev)
        ids[:, start:start + 256] = 0
        return ids

    sites.append(("Gemma decoder prefill (16, 512, 16*256) d=256, GQA 8/4, causal, "
                  "window 1024, bidir block, kv_mask", False, (randn(16, 512, 16 * 256), 8),
                  dict(kv_heads=4, causal=True, scale=256 ** -0.5, local_window=1024,
                       bidir_ids=image_block(16, 512, 4),
                       kv_mask=lengths_mask(16, 512, 285, 295))))
    sites.append(("Gemma prefill (2, 2048, 16*256) d=256, GQA 8/4, window 1024 "
                  "bites, bidir block at 1500", False, (randn(2, 2048, 16 * 256), 8),
                  dict(kv_heads=4, causal=True, scale=256 ** -0.5, local_window=1024,
                       bidir_ids=image_block(2, 2048, 1500),
                       kv_mask=lengths_mask(2, 2048, 2000, 2048))))

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
        ok, detail = attention_agrees(out, ref)
        extra = t5_attention_yardsticks(args, kw) if main else {}
        if "bidir_ids" in kw:
            extra["flop"] = masked_attention_yardsticks(label, *args, kw)[0]
        record("flash_attention_flat", label, out, ref, ok, detail, fn, plain_fn, main,
               **extra)
        del out, ref, extra
    del sites
    free_cuda()
    per_head_kernels(randn, record, lengths_mask)
    free_cuda()

    # Grouped GEMM at the Qwen3-VL-30B-A3B expert shapes of the slice: a
    # seeded top-8 routing of 16 x 1024 tokens over 128 experts (P = 147,456
    # buffer rows with the padding), gate_up (P, 2048) x (128, 2048, 1536)
    # and down (P, 768) x (128, 768, 2048); and a skewed routing where
    # experts 5 and 77 take every assignment and the other 126 are empty.
    # Each with num_blocks, as the dispatch calls it (the table's row and
    # the down site), and over every block, as the TPU kernel computes.
    from t2v_metrics_tpu_torch.ops import moe as M

    tokens = 16 * 1024
    top8 = torch.randn((tokens, 128), generator=gen, device=dev).topk(8).indices
    skewed = torch.tensor([5, 77], device=dev).repeat(tokens * 4)
    weights = {"gate_up": randn(128, 2048, 1536, std=2048 ** -0.5),
               "down": randn(128, 768, 2048, std=768 ** -0.5)}
    for routing, ids in (("top-8", top8.reshape(-1)), ("skewed", skewed)):
        _, _, be, p, used, _ = M._plan(ids, 128, M.BLOCK_M)
        be_host, used_host = be.cpu(), used.cpu()   # the plain version reads them on the host
        # the experts' groups end at these rows of the block-aligned buffer
        counts = torch.bincount(ids, minlength=128)
        offs = torch.cumsum((counts + 127) // 128 * 128, 0).int()
        tk = ids.numel()
        for wname, w in weights.items():
            xg = randn(p, w.shape[1])
            k, n = w.shape[1], w.shape[2]
            for nb, nb_host in ((used, used_host), (None, None)):
                out = M.grouped_matmul(xg, w, be, M.BLOCK_M, nb)
                ref = M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M, nb_host)
                torch.cuda.synchronize()
                bad = outside(out, ref, GMM_ATOL, GMM_RTOL)
                table = routing == "top-8" and nb is not None
                main, site = table and wname == "gate_up", table and wname == "down"
                library = None
                if main or site:
                    ms = library_ms(lambda: torch._grouped_mm(xg, w, offs=offs),  # noqa: B023
                                    "torch._grouped_mm")
                    library = None if ms is None else ("torch._grouped_mm", ms)
                rows = p if nb is None else int(used_host) * M.BLOCK_M
                ms, plain_ms = record(
                    "grouped_gemm",
                    f"{wname} ({p}, {k}) x (128, {k}, {n}), {routing} routing, "
                    + ("every block" if nb is None else f"num_blocks {rows // M.BLOCK_M}"),
                    out, ref, bad == 0 and bool(torch.isfinite(out).all()),
                    f"{bad} outside atol {GMM_ATOL} + rtol 2^-7; max "
                    f"{bf16_ulps(out, ref)} bf16 ulps",
                    lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, nb),  # noqa: B023
                    lambda: M.grouped_matmul_reference(  # noqa: B023
                        xg, w, be_host, M.BLOCK_M, nb_host), main,
                    flop=2 * rows * k * n,
                    # the work this routing needs: its tk assignments, not
                    # the buffer's pad rows
                    lower=(2 * tk * k * n, 2 * (tk * k + 128 * k * n + tk * n), "bf16"),
                    library=library, site=site)
                if routing == "skewed":
                    log(f"[kernel] grouped_gemm {wname} skewed routing: kernel / plain "
                        f"{ms / plain_ms:.3f}")
                del out, ref
    del weights, xg
    free_cuda()
    quant_kernels(randn, record)
    free_cuda()
    scorer_kernels(randn, record)
    free_cuda()
    video_kernels(randn, record, lengths_mask)
    free_cuda()
    decode_kernels(randn, record, lengths_mask)
    free_cuda()
    family_kernels(randn, record, lengths_mask)
    free_cuda()
    new_family_kernels(randn, record, lengths_mask)
    free_cuda()
    omni_kernels(randn, record)
    free_cuda()
    talker_kernels(randn, record)
    free_cuda()
    parallel_kernels(randn, record, lengths_mask)
    free_cuda()
    resize_sites()
    return results


def per_head_kernels(randn, record, lengths_mask) -> None:
    """The per-head kernel against its plain version: the SigLIP-896 tower's
    attention (the table's shape: 16 images, 16 heads of 72 over 4096
    patches, q/k/v strided views of the packed projection; the plain
    version runs in batch chunks of 4 to bound its (B, H, S, S) fp32
    scores) with ``F.scaled_dot_product_attention`` beside it, and two
    wrong plain versions (scale 1/8; the last key tile dropped) that must
    fail the tolerance; and the T5
    attention of clip-flant5-xl with the bias in the kernel (encoder: 32
    pairs x 640, bidirectional buckets, key mask; decoder: 32 x 4, causal
    buckets), with SDPA on the materialized bias beside the encoder."""
    from t2v_metrics_tpu_torch.ops.position import compute_position_bias
    from t2v_metrics_tpu_torch.ops import attention as A

    b, h, s, d = 16, 16, 4096, 72
    q, k, v = A.packed_heads(randn(b, s, 3 * h * d), h)

    def plain(**kw):
        return torch.cat([A.attention_reference(q[i:i + 4], k[i:i + 4], v[i:i + 4], **kw)
                          for i in range(0, b, 4)])

    fn = lambda: A.flash_attention(q, k, v)  # noqa: E731
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    cut = (torch.arange(s, device=q.device) < s - 64).expand(4, s)
    for wrong, kw in (("scale 1/8", dict(scale=0.125)), ("last key tile dropped",
                                                          dict(kv_mask=cut))):
        caught, why = attention_agrees(plain(**kw), ref)
        log(f"[kernel] flash_attention SigLIP-896 negative control, plain version with "
            f"{wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    name = "F.scaled_dot_product_attention (no mask)"
    ms = library_ms(lambda: F.scaled_dot_product_attention(q, k, v), name)
    flop = 4 * b * h * s * s * d
    record("flash_attention", f"SigLIP-896 ({b}, {h}, {s}, {d}) views of the "
           "packed projection, no mask", out, ref, ok, detail, fn, plain, True,
           flop=flop, lower=(flop, 2 * 4 * b * s * h * d, "bf16"),
           library=None if ms is None else (name, ms))
    del q, k, v, out, ref, cut
    free_cuda()

    heads, nb, md = 32, 32, 128
    rel = randn(heads, nb, dtype=torch.float32, std=3.0)
    for label, (bq, sq), bidirectional in (("T5 encoder", (32, 640), True),
                                           ("T5 decoder self", (32, 4), False)):
        q, k, v = A.packed_heads(randn(bq, sq, 3 * heads * 64), heads)
        kw = dict(scale=1.0, rel_bias=rel, rel_cfg=(bidirectional, nb, md, 0))
        if bidirectional:
            kw["kv_mask"] = lengths_mask(bq, sq, 590, 640)
        else:
            kw["causal"] = True
        fn = lambda: A.flash_attention(q, k, v, **kw)  # noqa: E731
        plain_fn = lambda: A.attention_reference(q, k, v, **kw)  # noqa: E731
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        ok, detail = attention_agrees(out, ref)
        if bidirectional:
            # contiguous: compute_position_bias returns a permuted view, and a
            # sum that keeps its strides sends SDPA to its math fallback
            bias = compute_position_bias(rel.T, sq, sq, True, nb, md).contiguous()
            mask = (bias + torch.where(kw["kv_mask"], 0.0, float("-inf"))[:, None, None, :]
                    ).to(torch.bfloat16).contiguous()
            lib = "F.scaled_dot_product_attention (materialized bias + mask, bf16)"
            ms = library_ms(lambda: F.scaled_dot_product_attention(  # noqa: B023
                q, k, v, attn_mask=mask, scale=1.0), lib)
            flop = 4 * bq * heads * sq * sq * 64
            lo = bound(flop, 2 * 4 * bq * sq * heads * 64 + 4 * heads * nb + bq * sq,
                       "bf16")
            log(f"[kernel] flash_attention {label} in-kernel bias: bound {lo[0]:.4f} ms "
                f"by {lo[1]}; {lib} " + ("refused" if ms is None else f"{ms:.4f} ms"))
            del mask
        record("flash_attention", f"{label} ({bq}, {heads}, {sq}, 64), T5 bias in the "
               f"kernel ({'bidirectional, kv_mask' if bidirectional else 'causal'})",
               out, ref, ok, detail, fn, plain_fn, False,
               flop=4 * bq * heads * sq * sq * 64)
        del q, k, v, out, ref


def masked_attention_yardsticks(label, packed, heads, kw) -> tuple:
    """Log the bound of a causal flat attention site, from the (row, col)
    pairs its masks keep (the causal band, cut by the window where there is
    one, OR the overlay where there is one, AND the key mask), and the time
    of ``F.scaled_dot_product_attention`` on the same q/k/v views with that
    mask materialized (GQA through enable_gqa). Returns (the operations
    those pairs need, the bound's (ops, bytes, type), the yardstick)."""
    from t2v_metrics_tpu_torch.ops import attention as A

    b, s, _ = packed.shape
    kvh = kw.get("kv_heads") or heads
    q, k, v, d = A._split_packed(packed, heads, kvh)
    qh, kh, vh = (t.view(b, s, n, d).transpose(1, 2)
                  for t, n in ((q, heads), (k, kvh), (v, kvh)))
    pos = torch.arange(s, device=packed.device)
    band = pos[None] <= pos[:, None]
    if kw.get("local_window"):
        band = band & (pos[None] > pos[:, None] - kw["local_window"])
    keep = band[None].expand(b, s, s)
    ids = kw.get("bidir_ids")
    if ids is not None:
        keep = keep | ((ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0))
    keep = keep & kw["kv_mask"][:, None, :]                          # (B, S, S)
    ops = 4 * d * heads * int(keep.sum())
    lower = (ops, 2 * b * s * (2 * heads + 2 * kvh) * d + 5 * b * s, "bf16")
    lo = bound(*lower)
    name = "F.scaled_dot_product_attention (bool mask, enable_gqa)"
    ms = library_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=keep[:, None], scale=kw.get("scale"), enable_gqa=True), name)
    log(f"[kernel] flash_attention_flat {label}: bound {lo[0]:.4f} ms by {lo[1]} "
        f"({ops / 1e9:.2f} GFLOP kept by the masks); {name} "
        + ("refused" if ms is None else f"{ms:.4f} ms"))
    return ops, lower, None if ms is None else (name, ms)


def qk_norm_library(pk: torch.Tensor, qk_heads: int, heads: int, d: int, w: torch.Tensor):
    """The qk-norm's library yardstick: one ``F.rms_norm`` over the q|k
    heads of the packed rows viewed as (rows, heads, d), its first
    ``qk_heads`` heads (the normalisation the kernel does; one weight where
    the kernel takes the q and the k scale)."""
    view = pk.view(-1, heads, d)[:, :qk_heads]
    name = f"F.rms_norm over the ({view.shape[0]} x {qk_heads}, {d}) q|k view"
    return name, cuda_ms(lambda: F.rms_norm(view, (d,), w, 1e-6))


def rms_site(record, label, x, w, r=None, main=False, eps=1e-6, offset=0.0, cast=True):
    """RMSNorm at one site against its plain version: alone, or with ``r``
    through the add entry (s bitwise the eager x + r, y against the plain
    RMSNorm of it). Bounds: bf16 in and out, the weight once; the add reads
    x and r and writes s and y. Library: ``F.rms_norm``, after the eager add
    for the add entry (two calls)."""
    from t2v_metrics_tpu_torch.ops import norms as N

    d = x.shape[-1]
    rows = x.numel() // d
    kw = dict(eps=eps, offset=offset, cast_weight_dtype=cast)
    if r is None:
        out, ref, same = N.rms_norm_fused(x, w, **kw), N.rms_norm_plain(x, w, **kw), True
        fn, plain = (lambda: N.rms_norm_fused(x, w, **kw)), (lambda: N.rms_norm_plain(x, w, **kw))
        lower = (5 * rows * d, 4 * rows * d + 2 * d, "fp32")
        library = ("F.rms_norm", cuda_ms(lambda: F.rms_norm(x, (d,), w, eps)))
    else:
        (s, out), s_ref = N.add_rms_norm_fused(x, r, w, **kw), x + r
        ref, same = N.rms_norm_plain(s_ref, w, **kw), bool(torch.equal(s, s_ref))
        fn = lambda: N.add_rms_norm_fused(x, r, w, **kw)  # noqa: E731
        plain = lambda: N.add_rms_norm_plain(x, r, w, **kw)  # noqa: E731
        lower = (6 * rows * d, 8 * rows * d + 2 * d, "fp32")
        library = ("x + r, then F.rms_norm (two calls)",
                   cuda_ms(lambda: F.rms_norm(x + r, (d,), w, eps)))
    bad = outside(out, ref, NORM_ATOL, RMS_RTOL)
    record("rms_norm", label, out, ref, bad == 0 and same,
           f"{bad} outside atol {NORM_ATOL} + rtol {RMS_RTOL}; max {bf16_ulps(out, ref)} "
           f"bf16 ulps" + ("" if r is None else f"; s bitwise x + r: {same}"),
           fn, plain, main, lower=lower, library=library, site=not main)


def rms_grid_check(x, w, r) -> None:
    """The RMSNorm kernel's rows do not depend on its grid: launches of the
    plan on one block an SM and on one block, which loop over many rows a
    block (the shared buffers of the warps' partial sums taken by turns from
    row to row), bitwise against the wrapper's one wave, alone and through
    the add entry. Not counted: the launch counts are reset before the main
    path."""
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops.gemm import sm_count

    rows, d = x.shape
    for add in (None, r):
        ref = N._norm_launch("rms_norm", x, add, w, None, 1e-6, (0.0, True))
        for grid in (sm_count(x.device), 1):
            s, y = N._norm_launch("rms_norm", x, add, w, None, 1e-6, (0.0, True), grid=grid)
            same = torch.equal(y, ref[1]) and (add is None or torch.equal(s, ref[0]))
            check(same, f"rms_norm ({rows}, {d}){' add' if add is not None else ''}: "
                        f"{grid} blocks differ from the plan's grid")
    log(f"[kernels] rms_norm ({rows}, {d}), alone and with the add: bitwise the same on the "
        f"plan's grid, {sm_count(x.device)} blocks and 1 block")


def qk_rope_site(record, label, pk, qs, ks, cos, sin, hq, hk, d, offset=0.0, cast=True):
    """The qk-norm folded into the rotation at one site, in place on a copy
    of ``pk`` (B, S, L), against ``rms_norm_rope_pack_plain`` (the pair
    tolerance QK_ROPE_PAIR_RTOL), the v lanes untouched. Bound: one read and
    one write of the q|k lanes, cos/sin and the weights once. Library: the
    qk-norm alone as one ``F.rms_norm`` over the q|k view (no PyTorch call
    rotates)."""
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    b, s, lanes = pk.shape
    rot, rows = hq + hk, b * s
    args = (qs, ks, cos, sin, hq, hk, d, 1e-6, offset, cast)
    buf = pk.clone()
    out, ref = R.rms_norm_rope_pack(buf, *args), R.rms_norm_rope_pack_plain(pk, *args)
    o = out[..., :rot * d].float().reshape(rows, rot, 2, d // 2)
    r = ref[..., :rot * d].float().reshape(rows, rot, 2, d // 2)
    n = N.rms_norm_heads_plain(pk, qs, ks, hq, hk, d, 1e-6, offset, cast)
    n = n[..., :rot * d].float().reshape(rows, rot, 2, d // 2)
    pair = torch.hypot(n[:, :, :1], n[:, :, 1:])
    del n
    bad = int(((o - r).abs() > NORM_ATOL + ROPE_RTOL * r.abs() + QK_ROPE_PAIR_RTOL * pair).sum())
    v_same = bool(torch.equal(out[..., rot * d:], pk[..., rot * d:]))
    in_place = out.data_ptr() == buf.data_ptr()
    record("rope_pack", label, out, ref, bad == 0 and v_same and in_place,
           f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL} + {QK_ROPE_PAIR_RTOL} x the "
           f"normalized pair's length; max {bf16_ulps(out, ref)} bf16 ulps; v lanes untouched "
           f"{v_same}; in place {in_place}",
           lambda: R.rms_norm_rope_pack(buf, *args), lambda: R.rms_norm_rope_pack_plain(pk, *args),
           False, lower=(10 * rows * rot * d, 4 * rows * rot * d + 8 * rows * d + 4 * d, "fp32"),
           library=qk_norm_library(pk, rot, lanes // d, d, qs), site=True)
    return buf


def rope_angles(gen, b, s, d, span=4096):
    """Seeded f32 cos / sin (B, S, d) of positions below ``span``."""
    ang = (torch.randint(0, span, (b, s, 1), generator=gen, device=gen.device).float()
           * torch.rand(d, generator=gen, device=gen.device))
    return torch.cos(ang), torch.sin(ang)


def library_ms(fn, name: str) -> float | None:
    """CUDA-event ms of a PyTorch call used as a yardstick, or None (said
    so) where it refuses the inputs."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
        log(f"[kernel] yardstick {name} refused: {type(e).__name__}: {str(e)[:300]}")
        return None
    return cuda_ms(fn)


def t5_attention_yardsticks(args, kw) -> dict:
    """The bound of the T5 encoder attention site and the time of
    ``F.scaled_dot_product_attention`` on its inputs: q, k, v viewed as
    (B, H, S, D) from the packed projection, the fp32 bias and the key mask
    folded into one bf16 additive mask (its dtype must be the query's)."""
    from t2v_metrics_tpu_torch.ops.attention import packed_heads

    packed, heads = args
    b, s, lanes = packed.shape
    d = lanes // (3 * heads)
    bias, kv_mask = kw["bias"], kw["kv_mask"]
    lower = (4 * b * heads * s * s * d,
             2 * b * s * lanes + 2 * b * s * heads * d + 4 * heads * s * s + b * s, "bf16")
    q, k, v = packed_heads(packed, heads)
    mask = (bias + torch.where(kv_mask, 0.0, float("-inf"))[:, None, None, :]
            ).to(torch.bfloat16)
    name = "F.scaled_dot_product_attention (bf16 float mask, scale 1.0)"
    ms = library_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                           scale=1.0), name)
    return {"lower": lower, "flop": lower[0],
            "library": None if ms is None else (name, ms)}


# clip-flant5-xxl W8A8 shapes at 32 pairs (the slice's 4 x 8 call and its
# batch_forward chunks; encoder rows 32 x 640, decoder rows 32 x A with A=4)
# and 4 images (ViT rows 4 x 640): (label, M, K, N, the table's shape, a
# site of the table: the decoder's split-K shape)
XXL_GEMMS = (("T5 encoder q|k|v", 32 * 640, 4096, 12288, True, False),
             ("T5 encoder o; cross k, v on encoder rows", 32 * 640, 4096, 4096, False, False),
             ("T5 encoder wi_0|wi_1", 32 * 640, 4096, 20480, False, False),
             ("T5 encoder wo", 32 * 640, 10240, 4096, False, False),
             ("T5 decoder q|k|v", 32 * 4, 4096, 12288, False, False),
             ("T5 decoder wo", 32 * 4, 10240, 4096, False, True),
             ("T5 decoder o, 25 pairs (ragged rows)", 25 * 4, 4096, 4096, False, False),
             ("ViT-L q|k|v", 4 * 640, 1024, 3072, False, False),
             ("ViT-L fc1", 4 * 640, 1024, 4096, False, False),
             ("ViT-L fc2", 4 * 640, 4096, 1024, False, False))


def quant_kernels(randn, record) -> None:
    """The int8 GEMM and the row quant against their plain versions at the
    xxl shapes, bitwise; beside each GEMM, ``torch._int_mm`` with the same
    f32 epilogue (the library yardstick) and the bf16 ``torch.matmul`` of
    the same product (does int8 pay on this card at all?)."""
    from t2v_metrics_tpu_torch.ops import quant as Q

    for label, m, k, n, main, site in XXL_GEMMS:
        x = randn(m, k, std=3.0)
        w = randn(k, n, std=k ** -0.5)
        leaf = Q.Linear(w.clone()).quantize_()
        x_q, xs = Q.quantize_rows_plain(x)
        w_q, ws = leaf.w_q, leaf.scale
        fn = lambda: Q.quant_matmul(x_q, w_q, xs, ws)  # noqa: E731
        plain_fn = lambda: Q.quant_matmul_plain(x_q, w_q, xs, ws)  # noqa: E731
        lib_fn = lambda: (torch._int_mm(x_q, w_q).float() * xs * ws  # noqa: E731
                          ).to(torch.bfloat16)
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        lib = library_ms(lib_fn, f"torch._int_mm ({m}, {k}) x ({k}, {n})")
        lib_same = lib is not None and bool(torch.equal(lib_fn(), ref))
        bf16_ms = cuda_ms(lambda: x @ w)
        ops = 2 * m * k * n
        lower = (ops, m * k + k * n + 4 * (m + n) + 2 * m * n, "int8")
        log(f"[kernel] quant_matmul ({m}, {k}) x ({k}, {n}) {label}: bound "
            f"{bound(*lower)[0]:.4f} ms by {bound(*lower)[1]}; torch._int_mm + "
            f"epilogue {'refused' if lib is None else f'{lib:.4f} ms'} "
            f"(bitwise equal to the plain version: {lib_same}); bf16 torch.matmul "
            f"{bf16_ms:.4f} ms ({ops / bf16_ms / 1e9:.1f} TFLOP/s)")
        record("quant_matmul", f"({m}, {k}) x ({k}, {n}) {label}", out, ref,
               bool(torch.equal(out, ref)), "bitwise equal required",
               fn, plain_fn, main, flop=ops, lower=lower,
               library=None if lib is None else ("torch._int_mm + f32 epilogue", lib),
               site=site)
        del x, w, leaf, x_q, xs, out, ref
        free_cuda()

    for rows, k, main in ((32 * 640, 4096, True), (32 * 640, 10240, False),
                          (32 * 4, 4096, False), (4 * 640, 1024, False)):
        x = randn(rows, k, std=3.0)
        (out, out_s), (ref, ref_s) = Q.quantize_rows(x), Q.quantize_rows_plain(x)
        same = bool(torch.equal(out, ref) and torch.equal(out_s, ref_s))
        record("quantize_rows", f"({rows}, {k})", out, ref, same,
               "int8 values and f32 scales bitwise equal required",
               lambda: Q.quantize_rows(x), lambda: Q.quantize_rows_plain(x), main,
               lower=(4 * rows * k, 3 * rows * k + 4 * rows, "fp32"))


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


def plain_by_kv_heads(q, k, v, heads, kv_heads=None, **kw):
    """``attention_flat_reference`` over one kv head (and its query heads)
    at a time: bounds the plain version's (B, H, S, S) fp32 scores at the
    video sites (16 x 16384^2 x 4 B = 17 GB at once for the Qwen ViT)."""
    from t2v_metrics_tpu_torch.ops import attention as A

    kvh = kv_heads or heads
    rep, d = heads // kvh, q.shape[-1] // heads
    return torch.cat([A.attention_flat_reference(
        q[..., g * rep * d:(g + 1) * rep * d], k[..., g * d:(g + 1) * d],
        v[..., g * d:(g + 1) * d], rep, 1 if rep > 1 else None, **kw)
        for g in range(kvh)], dim=-1)


def video_blocks(b: int, s: int):
    """Gemma's image-block ids of a 10-frame prompt in a (b, s) bucket, as
    the adapter lays it out: after 5 tokens, per frame 3 tokens of "Frame at
    {t}s:", begin-of-image, 256 image tokens (block id = the frame),
    end-of-image; -1 elsewhere. Returns (ids, prompt rows)."""
    ids = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    row = 5
    for f in range(10):
        row += 4
        ids[:, row:row + 256] = f
        row += 257
    return ids, row + 20


def video_kernels(randn, record, lengths_mask) -> None:
    """The kernel sites of video scoring, each against its plain version
    with its bound and SDPA on the same inputs: the flat kernel at the
    Qwen2.5-VL-7B ViT's full layers over a 40-frame 480x640 clip (grid (20,
    24, 32), 15,360 patches in bucket 16,384 in the tile order, pads under
    segment -1), at the Qwen3-VL-30B-A3B ViT (grid (20, 20, 28), 11,200
    patches in 12,288), at the Gemma-3-4B decoder prefill of 10 frames (8
    pairs in bucket 4,096, window 1,024 and ten 256-token image blocks both
    live, with two wrong plain versions that must fail: no window, no
    overlay); the per-head kernel at SigLIP-896 over one video's 10 frames.
    The plain versions run one kv head at a time."""
    from t2v_metrics_tpu_torch.models.qwen2vl import QWEN2_VL_MODELS
    from t2v_metrics_tpu_torch.models.qwen2vl_adapter import _padded_geometry
    from t2v_metrics_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    sdpa = F.scaled_dot_product_attention

    def seg_site(label, b, s, heads, d, seg):
        packed = randn(b, s, 3 * heads * d)
        q, k, v, _ = A._split_packed(packed, heads, None)
        kw = dict(segment_ids=seg)
        same = seg[:, :, None] == seg[:, None, :]
        pairs = int(same.sum())
        qh, kh, vh = A.packed_heads(packed, heads)
        attention_site(
            record, label, lambda: A.flash_attention_flat_packed(packed, heads, **kw),
            lambda: plain_by_kv_heads(q, k, v, heads, **kw), 4 * d * heads * pairs,
            2 * b * s * 4 * heads * d + 4 * b * s,
            ("F.scaled_dot_product_attention (bool mask)",
             lambda: sdpa(qh, kh, vh, attn_mask=same[:, None])))

    vis = QWEN2_VL_MODELS["qwen2.5-vl-7b"]["config"].vision
    *_, full_seg, _, tiled = _padded_geometry(vis, (20, 24, 32), 15360, 16384)
    check(tiled, "the 40-frame 336x448 grid should take the tiled window layout")
    seg_site("Qwen ViT full, video (1, 16384, 3x1280) d=80, 15360 rows, -1 pads",
             1, 16384, 16, 80, torch.from_numpy(full_seg).to(dev)[None])
    free_cuda()
    seg3 = torch.where(torch.arange(12288, device=dev) < 11200, 0, -1).int()[None]
    seg_site("Qwen3 ViT, video (1, 12288, 3x1152) d=72, 11200 rows, -1 pads",
             1, 12288, 16, 72, seg3)
    free_cuda()
    # the qwen3-vl-30b-a3b.genai-image cell's call: 16 images at 992x992, 3844
    # patches in bucket 4096 (key tile 31 skipped by q tiles 0-29)
    seg_img = torch.where(torch.arange(4096, device=dev) < 3844, 0, -1).int()
    seg_site("Qwen3 ViT, images (16, 4096, 3x1152) d=72, 3844 rows, -1 pads",
             16, 4096, 16, 72, seg_img.expand(16, 4096))
    free_cuda()

    # Gemma 3 decoder prefill of a 10-frame prompt: the window's lower edge
    # (kt_lo from each q tile's first row) and the overlay's block range both
    # move the tiles a q tile visits
    p, s = 8, 4096
    ids, rows = video_blocks(p, s)
    packed = randn(p, s, 16 * 256)
    kw = dict(kv_heads=4, causal=True, scale=256 ** -0.5, local_window=1024,
              bidir_ids=ids, kv_mask=lengths_mask(p, s, rows - 8, rows))
    q, k, v, _ = A._split_packed(packed, 8, 4)
    ref = plain_by_kv_heads(q, k, v, 8, **kw)
    for wrong, drop in (("no window", "local_window"), ("no overlay", "bidir_ids")):
        caught, why = attention_agrees(
            plain_by_kv_heads(q, k, v, 8, **{**kw, drop: None}), ref)
        log(f"[kernel] flash_attention_flat Gemma video prefill negative control, plain "
            f"version with {wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    del ref
    label = (f"Gemma video prefill ({p}, {s}, 16x256) d=256, GQA 8/4, window 1024 and "
             "ten 256-row image blocks, kv_mask")
    ops, lower, library = masked_attention_yardsticks(label, packed, 8, kw)
    out, ref = A.flash_attention_flat_packed(packed, 8, **kw), plain_by_kv_heads(q, k, v, 8, **kw)
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    record("flash_attention_flat", label, out, ref, ok, detail,
           lambda: A.flash_attention_flat_packed(packed, 8, **kw),
           lambda: plain_by_kv_heads(q, k, v, 8, **kw), False, flop=ops, lower=lower,
           library=library, site=True)
    del packed, q, k, v, out, ref, ids
    free_cuda()

    # SigLIP-896 over one video's 10 frames, the per-head kernel
    b, h, sq, d = 10, 16, 4096, 72
    q, k, v = A.packed_heads(randn(b, sq, 3 * h * d), h)

    def plain():
        return torch.cat([A.attention_reference(q[i:i + 2], k[i:i + 2], v[i:i + 2])
                          for i in range(0, b, 2)])

    fn = lambda: A.flash_attention(q, k, v)  # noqa: E731
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    name = "F.scaled_dot_product_attention (no mask)"
    ms = library_ms(lambda: sdpa(q, k, v), name)
    flop = 4 * b * h * sq * sq * d
    record("flash_attention", f"SigLIP-896, one video's frames ({b}, {h}, {sq}, {d})", out,
           ref, ok, detail, fn, plain, False, flop=flop,
           lower=(flop, 2 * 4 * b * sq * h * d, "bf16"),
           library=None if ms is None else (name, ms), site=True)
    del q, k, v, out, ref
    free_cuda()


# The decode sites (a generated token a sequence, sq = 1, against a KV cache)
# sit this many steps into a rollout: the cache view holds the prompt bucket
# and DECODE_STEP + 1 generated slots
DECODE_STEP = 16


def cache_attention_site(record, randn, label, b, s, heads, kvh, d, valid_prompt,
                         window=None, scale=None, edge=False, wrongs=None):
    """The flat kernel at one decode step: q (B, 1, H*d), the q lanes of the
    step's packed q|k|v row; k and v views of (B, s + 32, KvH*d) caches over
    slots [0, s + DECODE_STEP], the kernel's end-aligned causal band (and
    window) over the view, the prompt's pad slots invalid in kv_mask
    (``valid_prompt`` (B, s)), the generated slots valid. ``edge``: the key at
    the window's lower edge is made to carry the attention of the first
    query head of each kv head (3 x its q), so that a window one slot
    shorter moves the outputs. Checked against the plain version (and, with
    a window, two wrong plain versions that must fail: no window, and the
    window less one; ``wrongs``, (name, kw override) pairs, replace those),
    with the bound (the k / v rows the band reads, q and the output, over
    the HBM rate) and SDPA on the same views with the band and mask as a
    bool mask and enable_gqa."""
    from t2v_metrics_tpu_torch.ops import attention as A

    rep = heads // kvh
    sk = s + DECODE_STEP + 1
    q = randn(b, 1, (heads + 2 * kvh) * d)[..., :heads * d]
    ck, cv = randn(b, s + 32, kvh * d), randn(b, s + 32, kvh * d)
    valid = torch.zeros((b, s + 32), dtype=torch.bool, device=q.device)
    valid[:, :s] = valid_prompt
    valid[:, s:sk] = True
    if edge:
        e = sk - window                  # the oldest slot inside the window
        for g in range(kvh):
            ck[:, e, g * d:(g + 1) * d] = 3 * q[:, 0, g * rep * d:g * rep * d + d]
        valid[:, e] = True
    k, v, mask = ck[:, :sk], cv[:, :sk], valid[:, :sk]
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask, scale=scale, local_window=window)
    fn = lambda: A.flash_attention_flat(q, k, v, heads, **kw)  # noqa: E731
    plain_fn = lambda: A.attention_flat_reference(q, k, v, heads, **kw)  # noqa: E731
    out, ref = fn(), plain_fn()
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    if wrongs is None and window is not None:
        wrongs = (("no window", {"local_window": None}),
                  (f"a window of {window - 1}", {"local_window": window - 1}))
    for wrong, over in wrongs or ():
        caught, why = attention_agrees(
            A.attention_flat_reference(q, k, v, heads, **{**kw, **over}), ref)
        log(f"[kernel] flash_attention_flat {label} negative control, plain version "
            f"with {wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    band = torch.ones(sk, dtype=torch.bool, device=q.device)
    if window is not None:
        band[:sk - window] = False
    keep = band[None] & mask                                      # (B, sk)
    rows = int(band.sum())
    ops = 4 * d * heads * int(keep.sum())
    nbytes = 2 * (2 * b * rows * kvh * d + 2 * b * heads * d) + b * rows
    qh = q.view(b, 1, heads, d).transpose(1, 2)
    kh, vh = (t.view(b, sk, kvh, d).transpose(1, 2) for t in (k, v))
    sdpa_scale = d ** -0.5 if scale is None else scale
    attention_site(record, label, fn, plain_fn, ops, nbytes,
                   ("F.scaled_dot_product_attention (bool mask, enable_gqa)",
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=keep[:, None, None], scale=sdpa_scale,
                        enable_gqa=True)),
                   checked=(out, ref, ok, detail))
    log_host("flash_attention_flat", label, fn)


def decode_kernels(randn, record, lengths_mask) -> None:
    """The kernel sites of generation, each against its plain version with
    its bound and a library call on the same inputs: the flat kernel at sq =
    1 against KV caches (Qwen2.5-VL-7B: 4 sequences, GQA 28/4 at d 128,
    prompts in bucket 1280 with pad slots; Gemma-3-4B: 2 sequences past a
    4096-slot prompt bucket, GQA 8/4 at d 256, where the 1024 window bites);
    the T5-xl decoder step (self-attention over cpos + 1 cached keys with
    the bias row offset to cpos, dense in the flat kernel and in the
    per-head kernel's table; cross-attention over the 640 encoder rows with
    their kv_mask); RMSNorm (alone and with the add), rope and the qk-norm +
    rope at one row a sequence; the grouped GEMM
    over 4 tokens' 32 routed rows of 128 experts; the int8 GEMM and the row
    quant at M = 4 (bitwise)."""
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import moe as M
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import quant as Q
    from t2v_metrics_tpu_torch.ops import rope as R
    from t2v_metrics_tpu_torch.ops.position import compute_position_bias

    sdpa = F.scaled_dot_product_attention
    cache_attention_site(
        record, randn, f"Qwen2.5 decode, q (4, 1, 28x128) over a (4, {1280 + 32}, 4x128) "
        f"cache view of {1280 + DECODE_STEP + 1} slots, GQA 28/4, kv_mask with pad slots",
        4, 1280, 28, 4, 128, lengths_mask(4, 1280, 1200, 1280))
    cache_attention_site(
        record, randn, f"Gemma decode, q (2, 1, 8x256) over a (2, {4096 + 32}, 4x256) "
        f"cache view of {4096 + DECODE_STEP + 1} slots, GQA 8/4, window 1024, kv_mask",
        2, 4096, 8, 4, 256, lengths_mask(2, 4096, 3900, 4096), window=1024,
        scale=256 ** -0.5, edge=True)
    free_cuda()

    # T5-xl decoder step: 4 sequences, 32 heads of 64, slot cpos of a
    # (4, 33, 2048) self-attention cache
    b, heads, d, cpos, nb, md = 4, 32, 64, DECODE_STEP, 32, 128
    sk = cpos + 1
    packed = randn(b, 1, 3 * heads * d)
    q = packed[..., :heads * d]
    ck, cv = randn(b, 33, heads * d), randn(b, 33, heads * d)
    k, v = ck[:, :sk], cv[:, :sk]
    rel = randn(heads, nb, dtype=torch.float32, std=3.0)
    bias = compute_position_bias(rel.T, 1, sk, False, nb, md, q_offset=cpos).contiguous()
    qh = q.view(b, 1, heads, d).transpose(1, 2)
    kh, vh = (t.view(b, sk, heads, d).transpose(1, 2) for t in (k, v))
    nbytes = 2 * (2 * b * sk * heads * d + 2 * b * heads * d)
    ops = 4 * b * heads * sk * d
    label = (f"T5 decoder step self, q (4, 1, 32x64) over the (4, 33, 2048) cache view of "
             f"{sk} slots, bias row offset to cpos {cpos}")
    self_fn = lambda: A.flash_attention_flat(q, k, v, heads, bias=bias, scale=1.0)  # noqa: E731
    attention_site(record, label, self_fn,
                   lambda: A.attention_flat_reference(q, k, v, heads, bias=bias, scale=1.0),
                   ops, nbytes + 4 * heads * sk,
                   ("F.scaled_dot_product_attention (bf16 float mask, scale 1.0)",
                    lambda: sdpa(qh, kh, vh, attn_mask=bias.to(torch.bfloat16), scale=1.0)))
    log_host("flash_attention_flat", label, self_fn)
    kw = dict(scale=1.0, rel_bias=rel, rel_cfg=(False, nb, md, cpos))
    attention_site(record, f"T5 decoder step self, per-head (4, 32, 1, 64) over {sk} cached "
                   f"keys, T5 bias in the kernel (q_offset {cpos})",
                   lambda: A.flash_attention(qh, kh, vh, **kw),
                   lambda: A.attention_reference(qh, kh, vh, **kw),
                   ops, nbytes + 4 * heads * nb,
                   ("F.scaled_dot_product_attention (materialized bias, bf16, scale 1.0)",
                    lambda: sdpa(qh, kh, vh, attn_mask=bias.to(torch.bfloat16), scale=1.0)),
                   kernel="flash_attention")
    log_host("flash_attention", "T5 decoder step self, per-head, T5 bias in the kernel",
             lambda: A.flash_attention(qh, kh, vh, **kw))
    q, k, v = randn(b, 1, heads * d), randn(b, 640, heads * d), randn(b, 640, heads * d)
    mask = lengths_mask(b, 640, 590, 640)
    qh = q.view(b, 1, heads, d).transpose(1, 2)
    kh, vh = (t.view(b, 640, heads, d).transpose(1, 2) for t in (k, v))
    attention_site(record, "T5 decoder step cross, q (4, 1, 32x64) over k/v (4, 640, 2048), "
                   "kv_mask",
                   lambda: A.flash_attention_flat(q, k, v, heads, kv_mask=mask, scale=1.0),
                   lambda: A.attention_flat_reference(q, k, v, heads, kv_mask=mask, scale=1.0),
                   4 * heads * d * int(mask.sum()),
                   2 * (2 * b * 640 * heads * d + 2 * b * heads * d) + b * 640,
                   ("F.scaled_dot_product_attention (bool mask, scale 1.0)",
                    lambda: sdpa(qh, kh, vh, attn_mask=mask[:, None, None], scale=1.0)))
    log_host("flash_attention_flat", "T5 decoder step cross",
             lambda: A.flash_attention_flat(q, k, v, heads, kv_mask=mask, scale=1.0))
    del packed, ck, cv, k, v, q, qh, kh, vh
    free_cuda()

    # RMSNorm and rope over one row a sequence (Qwen2.5-VL-7B decode, 4
    # sequences: the block norms at d 3584, alone and through the add entry;
    # rope on the 28 + 4 q|k heads of the packed 36 x 128 row); the qk-norm
    # + rope of a Qwen3-VL-30B-A3B step (32 + 4 heads of 128)
    x, r, w = randn(4, 3584, std=3.0), randn(4, 3584, std=3.0), randn(3584)
    rms_site(record, "decode (4, 3584), one row a sequence", x, w)
    rms_site(record, "add + RMSNorm decode (4, 3584)", x, w, r=r)
    log_host("rms_norm", "decode (4, 3584)", lambda: N.rms_norm_fused(x, w))
    log_host("rms_norm", "add + RMSNorm decode (4, 3584)",
             lambda: N.add_rms_norm_fused(x, r, w))
    pk, qs, ks = randn(4, 1, 40 * 128, std=3.0), randn(128), randn(128)
    ang = 1290.0 * randn(128, dtype=torch.float32).abs().expand(4, 1, 128)
    cos, sin = torch.cos(ang), torch.sin(ang)
    buf = qk_rope_site(record, "qk-norm + rope decode (4, 1, 5120), 32+4 heads of 128",
                       pk, qs, ks, cos, sin, 32, 4, 128)
    log_host("rope_pack", "qk-norm + rope decode (4, 1, 5120)",
             lambda: R.rms_norm_rope_pack(buf, qs, ks, cos, sin, 32, 4, 128))
    pk = randn(4, 1, 36 * 128)
    buf = pk.clone()
    out, ref = R.rope_pack(buf, cos, sin, 32, 128), R.rope_pack_plain(pk, cos, sin, 32, 128)
    bad = outside(out, ref, NORM_ATOL, ROPE_RTOL)
    record("rope_pack", "decode (4, 1, 4608), 32 heads of 128, one row a sequence", out,
           ref, bad == 0, f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL}; max "
           f"{bf16_ulps(out, ref)} bf16 ulps",
           lambda: R.rope_pack(buf, cos, sin, 32, 128),
           lambda: R.rope_pack_plain(pk, cos, sin, 32, 128), False,
           lower=(3 * 4 * 32 * 128, 4 * 4 * 32 * 128 + 8 * 4 * 128, "fp32"), site=True)
    log_host("rope_pack", "decode (4, 1, 4608)", lambda: R.rope_pack(buf, cos, sin, 32, 128))

    # the grouped GEMM at one decode step of qwen3-vl-30b-a3b: 4 tokens'
    # top-8 routing, 32 routed rows of 128 experts (at most 32 non-empty
    # groups of one row each, one 128-row block apiece)
    ids = randn(4, 128, dtype=torch.float32).topk(8).indices.reshape(-1)
    _, _, be, p, used, _ = M._plan(ids, 128, M.BLOCK_M)
    be_host, used_host = be.cpu(), used.cpu()
    counts = torch.bincount(ids, minlength=128)
    offs = torch.cumsum((counts + 127) // 128 * 128, 0).int()
    experts = int((counts > 0).sum())
    w = randn(128, 2048, 1536, std=2048 ** -0.5)
    xg = randn(p, 2048)
    out = M.grouped_matmul(xg, w, be, M.BLOCK_M, used)
    ref = M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M, used_host)
    torch.cuda.synchronize()
    bad = outside(out, ref, GMM_ATOL, GMM_RTOL)
    ms = library_ms(lambda: torch._grouped_mm(xg, w, offs=offs), "torch._grouped_mm")
    record("grouped_gemm", f"decode gate_up, 32 routed rows ({p} buffer rows) x (128, 2048, "
           f"1536), {experts} experts used", out, ref,
           bad == 0 and bool(torch.isfinite(out).all()),
           f"{bad} outside atol {GMM_ATOL} + rtol 2^-7; max {bf16_ulps(out, ref)} bf16 ulps",
           lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, used),
           lambda: M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M, used_host), False,
           flop=2 * int(used_host) * M.BLOCK_M * 2048 * 1536,
           # the work this routing needs: 32 rows and the used experts' weights
           lower=(2 * 32 * 2048 * 1536, 2 * (32 * 2048 + experts * 2048 * 1536 + 32 * 1536),
                  "bf16"),
           library=None if ms is None else ("torch._grouped_mm", ms), site=True)
    log_host("grouped_gemm", "decode gate_up", lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M,
                                                                        used))
    del w, xg, out, ref
    free_cuda()

    # the int8 GEMM and the row quant at one xxl decode step (M = 4 rows)
    for label, k, n in (("decode q|k|v", 4096, 12288), ("decode wo", 10240, 4096)):
        x = randn(4, k, std=3.0)
        leaf = Q.Linear(randn(k, n, std=k ** -0.5)).quantize_()
        x_q, xs = Q.quantize_rows_plain(x)
        fn = lambda: Q.quant_matmul(x_q, leaf.w_q, xs, leaf.scale)  # noqa: E731
        plain_fn = lambda: Q.quant_matmul_plain(x_q, leaf.w_q, xs, leaf.scale)  # noqa: E731
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        ms = library_ms(lambda: (torch._int_mm(x_q, leaf.w_q).float() * xs  # noqa: B023
                                 * leaf.scale).to(torch.bfloat16),
                        f"torch._int_mm (4, {k}) x ({k}, {n})")
        ops = 2 * 4 * k * n
        record("quant_matmul", f"(4, {k}) x ({k}, {n}) {label}", out, ref,
               bool(torch.equal(out, ref)), "bitwise equal required", fn, plain_fn, False,
               flop=ops, lower=(ops, 4 * k + k * n + 4 * (4 + n) + 2 * 4 * n, "int8"),
               library=None if ms is None else ("torch._int_mm + f32 epilogue", ms),
               site=True)
        log_host("quant_matmul", f"(4, {k}) x ({k}, {n})", fn)
        (qo, qs), (qr, qrs) = Q.quantize_rows(x), Q.quantize_rows_plain(x)
        record("quantize_rows", f"decode (4, {k})", qo, qr,
               bool(torch.equal(qo, qr) and torch.equal(qs, qrs)),
               "int8 values and f32 scales bitwise equal required",
               lambda: Q.quantize_rows(x), lambda: Q.quantize_rows_plain(x), False,  # noqa: B023
               lower=(4 * 4 * k, 3 * 4 * k + 4 * 4, "fp32"), site=True)
        del x, leaf, out, ref
    free_cuda()


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


def seeded_clip(seed: int, frames: int = 150, fps: float = 30.0, h: int = 480,
                w: int = 640):
    """A seeded clip already decoded (``media.video.DecodedVideo``: every
    frame, RGB uint8, and its frame rate), the way in below the file reader:
    a GPU host needs no cv2. Default: 5 s at 30 fps, 480x640."""
    from t2v_metrics_tpu_torch.media.video import DecodedVideo

    rng = np.random.default_rng(seed)
    return DecodedVideo(rng.integers(0, 256, (frames, h, w, 3), dtype=np.uint8), fps)


def npy_check(scorer, tag: str, texts: list[str], seed: int) -> None:
    """Scores of 4 seeded BGR float32 ``.npy`` images (values -20 to 280)
    given by path, at 300x380 and at 1024x1024, against the same call on
    their flipped and clipped arrays: bitwise equal (the loader reads a
    ``.npy`` path as that array truncated to uint8, with no Pillow)."""
    import tempfile

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="npy_") as tmp:
        for h, w in ((300, 380), (1024, 1024)):
            bgrs = [rng.uniform(-20.0, 280.0, (h, w, 3)).astype(np.float32)
                    for _ in range(4)]
            paths = [os.path.join(tmp, f"{h}x{w}_{i}.npy") for i in range(4)]
            for path, bgr in zip(paths, bgrs):
                np.save(path, bgr)
            by_path = scorer(images=paths, texts=texts)
            by_array = scorer(images=[np.clip(b[:, :, [2, 1, 0]], 0, 255) for b in bgrs],
                              texts=texts)
            check(by_path.shape == (4, len(texts)) and np.isfinite(by_path).all()
                  and ((by_path >= 0) & (by_path <= 1)).all(),
                  f"[npy] {tag} {h}x{w}: scores not finite in [0, 1]")
            check(np.array_equal(by_path, by_array),
                  f"[npy] {tag} {h}x{w}: .npy paths score differently from their arrays")
            log(f"[npy] {tag} 4 .npy paths at {h}x{w} x {len(texts)} texts: bitwise "
                f"equal to their flipped and clipped arrays; log scores row 0 "
                f"{np.log(by_path[0]).round(4).tolist()}")


def apollo_check(scorer, tag: str, texts: list[str], seed: int) -> None:
    """Where cv2 imports: a seeded FFV1 clip (5 s at 30 fps, 480x640) written
    with cv2, loaded by ``ApolloMMLoader(clip_duration=2.0,
    frames_per_clip=4).load_video`` (its frames equal to the written ones at
    the sampled indices), and the first clip's ``concatenate_grid`` collage
    scored through ``scorer``. One line, and no check, where cv2 is absent:
    nothing of the device path needs it."""
    import tempfile

    try:
        import cv2
    except ImportError as e:
        log(f"[apollo] not run: cv2 does not import on this machine ({e})")
        return
    from t2v_metrics_tpu_torch.media import video_utils as vu
    from t2v_metrics_tpu_torch.media.video import concatenate_grid

    frames = seeded_clip(seed).frames  # RGB
    with tempfile.TemporaryDirectory(prefix="apollo_") as tmp:
        path = os.path.join(tmp, "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (640, 480))
        check(writer.isOpened(), f"[apollo] cv2 {cv2.__version__} cannot write FFV1")
        for f in frames:
            writer.write(np.ascontiguousarray(f[:, :, ::-1]))
        writer.release()
        t0 = time.perf_counter()
        loader = vu.ApolloMMLoader(clip_duration=2.0, frames_per_clip=4)
        clips, stamps = loader.load_video(path)
        t_load = time.perf_counter() - t0
        total, fps, duration = vu.get_video_details(path)
    _, all_idx, _ = vu.calculate_sample_indices(
        2.0, 4, total, fps, duration,
        clip_sampling_ratio=loader.effective_sampling_ratio(duration))
    check((total, fps) == (150, 30.0) and len(clips) == 3
          and all(c.shape == (4, 480, 640, 3) for c in clips),
          f"[apollo] {total} frames at {fps} fps, clips {[c.shape for c in clips]}")
    check(np.array_equal(np.concatenate(clips), frames[all_idx]),
          "[apollo] loaded frames differ from the written frames at the sampled indices")
    collage = concatenate_grid(list(clips[0]))
    scores = scorer(images=[collage], texts=texts)
    check(scores.shape == (1, len(texts)) and np.isfinite(scores).all()
          and ((scores >= 0) & (scores <= 1)).all(),
          f"[apollo] collage scores {scores} not finite in [0, 1]")
    log(f"[apollo] cv2 {cv2.__version__}: ApolloMMLoader.load_video of a 150-frame "
        f"480x640 FFV1 clip in {t_load:.3f} s: {len(clips)} clips of 4, indices "
        f"{all_idx}, timestamps {[(round(float(a), 4), round(float(b), 4)) for a, b in stamps]}, "
        f"frames equal to the written ones; {tag} on the first clip's 1024x1024 "
        f"collage: log scores {np.log(scores[0]).round(4).tolist()}")


def chain_config(layers_vit: int = 2, layers_t5: int = 2,
                 model: str = "clip-flant5-xl"):
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS

    cfg = CLIP_T5_CONFIGS[model]
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
    On an int8 leaf the q columns' scales take the 1/8: the same int8
    weights and scales as quantizing the folded dense weights (a power of
    two commutes with the rounding).
    """
    f = cfg.t5.d_kv ** -0.5

    def fold(leaf, cols):
        if leaf.quantized:
            leaf.scale[cols] *= f
        else:
            leaf.w[:, cols] *= f

    for blk in [*params.t5.encoder.blocks, *params.t5.decoder.blocks]:
        # the q columns: a third of the packed leaf (this rank's heads under TP)
        fold(blk.attn.qkv, slice(0, blk.attn.qkv.d_out // 3))
    for blk in params.t5.decoder.blocks:
        fold(blk.cross.q, slice(None))


# ---------------------------------------------------------------------------
# Phase: clip-flant5-xl loaded from a staged checkpoint
# ---------------------------------------------------------------------------

# this script's own HF key map and safetensors writer: the card machine has
# neither transformers nor safetensors
_VT = "encoder.vision_tower.vision_tower.vision_model"
_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32", torch.uint8: "U8", torch.bool: "BOOL"}


def hf_clip_t5_tensors(model, cfg) -> dict:
    """The HF CLIP-FlanT5 (LLaVA layout) state dict of a port ``CLIPT5Model``:
    key -> tensor view on the model's device, linear weights (out, in), the
    patch embedding as the conv weight; the T5 embedding under its three
    tied names, as ``T5ForConditionalGeneration.state_dict()`` lists it."""
    sd = {}
    v, w, p = model.vision, cfg.vision.width, cfg.vision.patch_size

    def lin(prefix, leaf, bias=True):
        sd[f"{prefix}.weight"] = leaf.w.t()
        if bias:
            sd[f"{prefix}.bias"] = leaf.b

    def norm(prefix, n):
        sd[f"{prefix}.weight"] = n.scale
        if n.bias is not None:
            sd[f"{prefix}.bias"] = n.bias

    sd[f"{_VT}.embeddings.class_embedding"] = v.class_emb
    sd[f"{_VT}.embeddings.patch_embedding.weight"] = v.patch_w.t().reshape(w, 3, p, p)
    sd[f"{_VT}.embeddings.position_embedding.weight"] = v.pos_emb
    norm(f"{_VT}.pre_layrnorm", v.ln_pre)
    norm(f"{_VT}.post_layernorm", v.ln_post)
    for i, b in enumerate(v.blocks):
        pre = f"{_VT}.encoder.layers.{i}"
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{pre}.self_attn.{name}.weight"] = b.qkv.w[:, j * w:(j + 1) * w].t()
            sd[f"{pre}.self_attn.{name}.bias"] = b.qkv.b[j * w:(j + 1) * w]
        lin(f"{pre}.self_attn.out_proj", b.o)
        norm(f"{pre}.layer_norm1", b.ln1)
        norm(f"{pre}.layer_norm2", b.ln2)
        lin(f"{pre}.mlp.fc1", b.fc1)
        lin(f"{pre}.mlp.fc2", b.fc2)
    lin("encoder.mm_projector.0", model.projector.fc1)
    lin("encoder.mm_projector.2", model.projector.fc2)
    t5 = model.t5
    for name in ("shared", "encoder.embed_tokens", "decoder.embed_tokens"):
        sd[f"{name}.weight"] = t5.shared_emb
    if t5.lm_head is not None:
        sd["lm_head.weight"] = t5.lm_head.t()
    inner = cfg.t5.num_heads * cfg.t5.d_kv
    for side in ("encoder", "decoder"):
        stack = getattr(t5, side)
        norm(f"{side}.final_layer_norm", stack.ln_final)
        for i, b in enumerate(stack.blocks):
            pre = f"{side}.block.{i}.layer"
            attn = f"{pre}.0.SelfAttention"
            for j, name in enumerate("qkv"):
                sd[f"{attn}.{name}.weight"] = b.attn.qkv.w[:, j * inner:(j + 1) * inner].t()
            lin(f"{attn}.o", b.attn.o, bias=False)
            if b.attn.rel_bias is not None:
                sd[f"{attn}.relative_attention_bias.weight"] = b.attn.rel_bias
            norm(f"{pre}.0.layer_norm", b.ln1)
            mlp = f"{pre}.{2 if side == 'decoder' else 1}"
            if side == "decoder":
                for name in "qkvo":
                    lin(f"{pre}.1.EncDecAttention.{name}", getattr(b.cross, name), bias=False)
                norm(f"{pre}.1.layer_norm", b.ln_cross)
            for name, leaf in b.mlp.named_children():
                lin(f"{mlp}.DenseReluDense.{name}", leaf, bias=False)
            norm(f"{mlp}.layer_norm", b.ln2)
    return sd


def write_safetensors(tensors: dict, path: str) -> int:
    """One safetensors file: the 8-byte little-endian header length, the
    JSON header (padded to 8 bytes), the raw bytes in key order; each tensor
    copied to the host once. Returns the bytes written."""
    header, offset = {}, 0
    for k in sorted(tensors):
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for k in sorted(tensors):
            f.write(tensors[k].contiguous().view(torch.uint8).reshape(-1).cpu().numpy())
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(head) + offset


def write_checkpoint(tensors: dict, path: str, shards: int) -> int:
    """``tensors`` as ``shards`` safetensors files of about equal bytes, with
    ``model.safetensors.index.json``; the files' pages are then dropped from
    the page cache where the OS allows, so the load reads the disk."""
    os.makedirs(path, exist_ok=True)
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups, acc = [[] for _ in range(shards)], 0
    for k in sorted(tensors):
        t = tensors[k]
        groups[min(shards - 1, acc * shards // max(total, 1))].append(k)
        acc += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for i, keys in enumerate(groups):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        file = os.path.join(path, name)
        written += write_safetensors({k: tensors[k] for k in keys}, file)
        weight_map.update(dict.fromkeys(keys, name))
        if hasattr(os, "posix_fadvise"):
            fd = os.open(file, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return written


def staging_dir(need: int) -> str:
    """A fresh temporary directory, after checking its filesystem has
    ``need`` bytes free."""
    import shutil
    import tempfile

    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    if free < need:
        raise SmokeFailure(f"checkpoint: staging needs {need / 1e9:.1f} GB of free disk "
                           f"(twice the checkpoint); {base} has {free / 1e9:.1f} GB")
    return tempfile.mkdtemp(prefix="ckpt_", dir=base)


def _vm_rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


# The hub-cache layout the staged checkpoint takes (models/checkpoint.py:
# resolve_snapshot): models--{org}--{name}/snapshots/<rev>/ and refs/main
SNAPSHOT_REV = "0" * 40


def snapshot_dir(cache: str, repo: str) -> str:
    return os.path.join(cache, "models--" + repo.replace("/", "--"), "snapshots",
                        SNAPSHOT_REV)


def stage_snapshot(tensors: dict, cache: str, repo: str, shards: int) -> tuple[str, int]:
    """``tensors`` written as ``repo``'s hub snapshot under ``cache``: the
    safetensors shards and index in ``snapshot_dir`` and ``refs/main``
    naming it, as ``checkpoint.resolve_snapshot`` finds it. Returns the
    snapshot directory and the bytes written."""
    stage = snapshot_dir(cache, repo)
    written = write_checkpoint(tensors, stage, shards)
    refs = os.path.join(os.path.dirname(os.path.dirname(stage)), "refs")
    os.makedirs(refs, exist_ok=True)
    with open(os.path.join(refs, "main"), "w") as f:
        f.write(SNAPSHOT_REV)
    return stage, written


def phase_checkpoint(model: str = "clip-flant5-xl", shards: int = 4) -> tuple[dict, str]:
    """The whole clip-flant5-xl staged as an HF checkpoint and loaded through
    ``VQAScore(model, checkpoint=dir)`` on the card: random bf16 weights from
    a seed with the T5 scale folded into W_q, written by this script's key
    map and writer as ``shards`` safetensors files and the index json, in
    the hub-cache layout of the model's repo (a snapshot and ``refs/main``
    under a temporary cache directory); a seeded 4 x 8 set scored bitwise
    equal to the same weights passed as ``params=``. Prints load seconds and
    GB/s, the host RSS growth (``resource.getrusage`` peak against the RSS
    at the start of the load) and the device peak against the weights'
    bytes. Returns the launch counts of the loaded model's first call (the
    slice's main path) and the cache directory, which the caller removes
    (removed here only where the phase fails)."""
    import resource
    import shutil

    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS, init_clip_t5
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = CLIP_T5_CONFIGS[model]
    rss_start = _vm_rss()
    weights = init_clip_t5(cfg, SEED + 5, "cuda", torch.bfloat16)
    fold_t5_attention_scale(weights, cfg)
    tensors = hf_clip_t5_tensors(weights, cfg)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    cache = staging_dir(2 * nbytes)
    try:
        t0 = time.perf_counter()
        stage, written = stage_snapshot(tensors, cache, CLIP_T5_MODELS[model]["hf_repo"],
                                        shards)
        t_write = time.perf_counter() - t0
        del tensors
        log(f"[checkpoint] {model}: {len(os.listdir(stage)) - 1} safetensors shards + "
            f"index, {written / 1e9:.3f} GB in {t_write:.2f} s (with fsync) under {stage}; "
            f"host RSS {rss_start / 2**30:.2f} GiB before the phase, "
            f"{_vm_rss() / 2**30:.2f} GiB after writing")
        tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
        images, texts = seeded_images(4, 31), seeded_texts(8, 32)
        want = t2v.VQAScore(model=model, params=weights, tokenizer=tok,
                            device="cuda")(images=images, texts=texts)
        weight_bytes = sum(t.numel() * t.element_size() for t in weights.parameters())
        del weights
        free_cuda()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rss0, maxrss0 = _vm_rss(), resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        t0 = time.perf_counter()
        scorer = t2v.VQAScore(model=model, checkpoint=stage, tokenizer=tok, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        maxrss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        held = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base

        reset_launch_counts()
        got = scorer(images=images, texts=texts)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = clip_t5_launches(cfg, 1)
        growth = maxrss1 - rss0
        log(f"[checkpoint] {model} loaded: {t_load:.2f} s, {written / 1e9 / t_load:.2f} GB/s "
            f"({written / 1e9:.3f} GB from disk to the card, bf16 to bf16); host RSS "
            f"{rss0 / 2**30:.2f} GiB at the start, peak {maxrss1 / 2**30:.2f} GiB after "
            f"(getrusage; {maxrss0 / 2**30:.2f} GiB before): growth {growth / 2**30:.3f} GiB, "
            f"{100 * growth / written:.1f}% of the checkpoint; device {held / 2**30:.3f} GiB "
            f"held, peak {peak / 2**30:.3f} GiB at load against {weight_bytes / 2**30:.3f} GiB "
            f"of weights ({peak / weight_bytes:.3f}x); card {card_line()}")
        log(f"[checkpoint] first call launches {json.dumps(counts)}; from the code "
            f"{json.dumps(expect)}")
        same = np.array_equal(got, want)
        log(f"[checkpoint] 4 x 8 scores from the checkpoint {'bitwise equal to' if same else 'DIFFER from'}"
            f" params= (max |diff| {float(np.abs(got - want).max()):.3e}); log row 0 "
            f"{np.log(got[0]).round(4).tolist()}")
        check(got.shape == (4, 8) and np.isfinite(got).all(), "checkpoint: scores not finite")
        check(same, "checkpoint: scores differ from the same weights passed as params=")
        check(counts == expect, f"checkpoint: launch counts {counts} != {expect}")
        check(growth < written / 4, f"checkpoint: host RSS grew by {growth} bytes while "
                                    f"loading {written}")
        del scorer
    except BaseException:
        shutil.rmtree(cache, ignore_errors=True)
        raise
    return counts, cache


# ---------------------------------------------------------------------------
# GenAI-Bench and TIFA160 through the port's harness (BASELINE configs 3, 2)
# ---------------------------------------------------------------------------

GENAI_MODELS = ("DALLE_3", "SDXL_Turbo", "DeepFloyd_I_XL_v1", "Midjourney_6", "SDXL_2_1",
                "SDXL_Base")   # benchmarks/datasets.py:GenAIBench_Image.MODELS
GENAI_SKILLS = {"basic": ("attribute", "scene", "spatial relation", "action relation",
                          "part relation"),
                "advanced": ("counting", "comparison", "differentiation", "negation",
                             "universal")}
TIFA_MODELS = ("mini-dalle", "vq-diffusion", "sd1dot5", "sd2dot1", "sd1dot1")


def seeded_media(path: str, side: int) -> np.ndarray:
    """A dataset's ``image_preprocess`` for staged items: a side x side uint8
    RGB image seeded by the item's path (the files are not in the repo)."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(path.encode()))
    return rng.integers(0, 256, (side, side, 3), dtype=np.uint8)


def stage_genai_bench(root: str, prompts: int, seed: int) -> str:
    """A ``GenAI-Image-1600`` tree under ``root``: ``genai_image.json`` with
    ``prompts`` prompts x the 6 models, 3 seeded Likert ratings (1-5) each,
    and ``genai_skills.json`` with every tag ``cli.genai_image_eval
    .tag_groups`` names: "basic" the first half of the prompts, "advanced"
    the second, each skill a seeded third of its half."""
    rng = np.random.default_rng(seed)
    texts = seeded_texts(prompts, seed)
    data = {f"{i:05d}": {"prompt": texts[i], "models": {
        m: rng.integers(1, 6, 3).tolist() for m in GENAI_MODELS}} for i in range(prompts)}
    half = prompts // 2
    skills = {"basic": list(range(half)), "advanced": list(range(half, prompts))}
    for group, tags in GENAI_SKILLS.items():
        for tag in tags:
            skills[tag] = sorted(int(i) for i in rng.choice(skills[group],
                                                            max(2, half // 3), replace=False))
    d = os.path.join(root, "GenAI-Image-1600")
    os.makedirs(d)
    with open(os.path.join(d, "genai_image.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(d, "genai_skills.json"), "w") as f:
        json.dump(skills, f)
    return d


def stage_tifa160(workdir: str, sources: int, seed: int) -> None:
    """TIFA160's files where ``TIFA160_DSG`` reads them, under ``workdir``
    (the reference reads ``datasets/`` under the working directory, not
    ``root_dir``): ``datasets/tifa160.json`` with ``sources`` texts x the 5
    models and ``datasets/dsg_tifa160_anns.csv`` with 2-4 seeded DSG answers
    (0 / 1) per item; an empty ``tifa160/`` image directory."""
    import csv

    from t2v_metrics_tpu_torch.benchmarks.datasets import TIFA160_DSG

    rng = np.random.default_rng(seed)
    texts = seeded_texts(sources, seed)
    dataset, rows = {}, []
    for mt in TIFA_MODELS:
        for sid in range(sources):
            key = f"{sid}_{TIFA160_DSG.MODEL_NAMES[mt]}"
            dataset[key] = {"text": texts[sid], "text_id": str(sid),
                            "image_path": f"{key}.jpg"}
            rows += [(mt, sid, int(a)) for a in rng.integers(0, 2, rng.integers(2, 5))]
    os.makedirs(os.path.join(workdir, "datasets"))
    os.makedirs(os.path.join(workdir, "tifa160"))
    with open(os.path.join(workdir, "datasets", "tifa160.json"), "w") as f:
        json.dump(dataset, f)
    with open(os.path.join(workdir, "datasets", "dsg_tifa160_anns.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["model_type", "source_id", "answer"])
        w.writerows(rows)


def clip_t5_launches(cfg, passes: int) -> dict:
    """Launches of ``passes`` clip-flant5 chunks, each one ViT pass over the
    chunk's images and one T5 pass over its pairs: attention at the ViT
    layers run (feature layer -2), the encoder, the decoder's self and
    cross; LayerNorm twice a ViT layer and ln_pre; RMSNorm (each but a
    stack's first through its add entry) twice an encoder and three times a
    decoder layer and each stack's final norm."""
    vit, enc, dec = cfg.vision.layers - 1, cfg.t5.enc_layers, cfg.t5.dec_layers
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention_flat=passes * (vit + enc + 2 * dec),
                layer_norm=passes * (1 + 2 * vit),
                rms_norm=passes * (2 * enc + 1 + 3 * dec + 1))
    return want


def phase_genai_bench(cache_dir: str, model: str = "clip-flant5-xl", device: str = "cuda",
                      prompts: int = 16, side: int = 1024, tifa_side: int = 512,
                      batch_size: int = 16, profile: bool = False) -> list[dict]:
    """GenAI-Bench image evaluation through the port's CLI path, offline, as
    a user runs it from a local snapshot: a staged ``GenAI-Image-1600``
    fixture (``prompts`` x 6 models, seeded Likert ratings, every skill tag)
    read by ``benchmarks.datasets.GenAIBench_Image`` with
    ``return_image_paths=False`` and a seeded side x side image for each item
    (GenAI-Bench's 1024 px: the Pillow-exact resize on the card);
    ``cli.genai_image_eval.load_or_compute_scores`` with ``--cache_dir`` the
    staged hub cache (``get_score_model`` finds the snapshot; no init flag),
    then ``show_performance_per_skill``, ``evaluate_scores`` and
    ``evaluate_scores_per_skill`` and the per-skill JSON, as the CLI's
    ``main`` does. Checks: scores (n, 1, 1), finite, in [0, 1], bitwise equal
    to ``VQAScore(model, checkpoint=<snapshot>)``'s ``batch_forward`` of the
    same arrays; a second call reads the npz and builds no scorer; launch
    counts the code's. Then TIFA160 (``TIFA160_DSG``, BASELINE config 2,
    staged in a temporary working directory) through ``batch_forward`` and
    ``evaluate_scores`` on the same scorer. The phase may import no pandas,
    sklearn, Pillow, cv2 or matplotlib. With ``profile``, the device time of
    one ``batch_forward`` of the set by kernel family. Returns the launch
    counts of the CLI's scoring call and of the TIFA160 call."""
    import shutil
    import tempfile

    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.benchmarks.datasets import GenAIBench_Image, TIFA160_DSG
    from t2v_metrics_tpu_torch.cli import genai_image_eval as cli
    from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    modules_before = set(sys.modules)
    work = tempfile.mkdtemp(prefix="genai_bench_")
    cwd, real_get = os.getcwd(), t2v.get_score_model
    loaded = {}

    def get_score_model(**kw):      # the CLI's own call, timed and kept
        sync()
        t0 = time.perf_counter()
        loaded["scorer"] = real_get(**kw)
        sync()
        loaded["s"] = time.perf_counter() - t0
        return loaded["scorer"]

    def no_scorer(**kw):
        raise SmokeFailure("genai_bench: the cached call built a scorer")

    try:
        stage_genai_bench(work, prompts, SEED + 40)
        dataset = GenAIBench_Image(root_dir=work, num_prompts=1600, return_image_paths=False,
                                   image_preprocess=lambda p: seeded_media(p, side))
        n = len(dataset)
        check(n == prompts * len(GENAI_MODELS), f"genai_bench: {n} samples")
        argv = sys.argv
        sys.argv = ["genai_image_eval", "--root_dir", work, "--model", model,
                    "--cache_dir", cache_dir, "--batch_size", str(batch_size),
                    "--result_dir", os.path.join(work, "results"),
                    *(("--device", device) if device != "cuda" else ())]
        try:
            args = cli.config()
        finally:
            sys.argv = argv
        check(device != "cuda" or args.device is None, "genai_bench: --device default")
        os.makedirs(args.result_dir)
        result_path = f"{args.result_dir}/{args.model}_{args.num_prompts}_prompts.npz"

        t2v.get_score_model = get_score_model
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores = cli.load_or_compute_scores(args, dataset, result_path)
        sync()
        t_call = time.perf_counter() - t0
        counts = launch_counts()
        t2v.get_score_model = no_scorer
        reset_launch_counts()
        cached = cli.load_or_compute_scores(args, dataset, result_path)
        cached_counts = launch_counts()
        t2v.get_score_model = real_get
        scorer = loaded["scorer"]
        cfg = scorer.model.config
        chunks = -(-n // batch_size)
        want = clip_t5_launches(cfg, chunks)
        pairs_s = n / (t_call - loaded["s"])
        log(f"[genai_bench] {model} from the snapshot in --cache_dir: load "
            f"{loaded['s']:.2f} s; load_or_compute_scores over {n} pairs at {side}x{side} "
            f"(batch {batch_size}, {chunks} chunks) {t_call - loaded['s']:.3f} s after "
            f"the load: {pairs_s:.2f} pairs/s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card_line()}")
        log(f"[genai_bench] launches {json.dumps(counts)}; from the code {json.dumps(want)}")
        check(scores.shape == (n, 1, 1), f"genai_bench: scores {scores.shape}")
        check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
              "genai_bench: scores not finite in [0, 1]")
        check(counts == want, f"genai_bench: launch counts {counts} != {want}")
        check(np.array_equal(cached, scores) and not any(cached_counts.values()),
              "genai_bench: the cached call differs or launched a kernel")

        snapshot = snapshot_dir(cache_dir, CLIP_T5_MODELS[model]["hf_repo"])
        ref = t2v.VQAScore(model, checkpoint=snapshot, device=device)
        ref_scores = ref.batch_forward(dataset, batch_size=batch_size)
        same = np.array_equal(scores, ref_scores)
        log(f"[genai_bench] the CLI's scores {'bitwise equal' if same else 'DIFFER from'} "
            f"VQAScore(checkpoint=<snapshot>).batch_forward of the same arrays (max |diff| "
            f"{float(np.abs(scores - ref_scores).max()):.3e}); log spread "
            f"{float(np.ptp(np.log(scores))):.4e} nats")
        check(same, "genai_bench: CLI scores differ from VQAScore(checkpoint=)")
        del ref
        free_cuda()
        sync()
        t0 = time.perf_counter()
        again = scorer.batch_forward(dataset, batch_size=batch_size)
        sync()
        warm_s = n / (time.perf_counter() - t0)
        check(np.array_equal(again, scores), "genai_bench: a second batch_forward differs")
        t0 = time.perf_counter()
        for i in range(n):
            dataset[i]
        t_items = (time.perf_counter() - t0) * 1e3
        if profile:
            phase_profile(lambda: scorer.batch_forward(dataset, batch_size=batch_size),
                          f"{model} GenAI-Bench batch_forward ({n} pairs at {side} px)")

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as table:
            cli.show_performance_per_skill(np.asarray(scores).mean(axis=1)[:, 0], dataset,
                                           print_std=True)
            overall = dataset.evaluate_scores(scores)
            skill_result = dataset.evaluate_scores_per_skill(scores)
            output_file = f"{args.result_dir}/{args.model}_{args.num_prompts}_per_skill.json"
            with open(output_file, "w") as f:
                json.dump(skill_result, f, default=float)
        t_eval = (time.perf_counter() - t0) * 1e3
        with open(output_file) as f:
            written = json.load(f)
        with open(os.path.join(dataset.root_dir, "genai_skills.json")) as f:
            tags = set(json.load(f))
        align = overall["alignment"]
        log(f"[genai_bench] warm batch_forward {warm_s:.2f} pairs/s (the {n} items' "
            f"seeded images alone take {t_items:.1f} ms on the host); evaluation (skill "
            f"tables, {len(table.getvalue().splitlines())} lines; correlation; per-skill JSON "
            f"of {len(written)} tags) {t_eval:.1f} ms on the host; pearson "
            f"{align['pearson']:.4f}, kendall_b {align['kendall_b']:.4f}, pairwise_acc "
            f"{align['pairwise_acc'][0]:.4f} (random weights against seeded ratings)")
        check(set(written) == tags and all(
            np.isfinite(written[t]["alignment"]["pearson"]) for t in tags),
            "genai_bench: per-skill JSON incomplete or not finite")
        check(all(np.isfinite(np.asarray(align[k], np.float64)).all() for k in align),
              "genai_bench: correlations not finite")

        os.chdir(work)
        stage_tifa160(work, prompts, SEED + 41)
        tifa = TIFA160_DSG(root_dir=work, download=False, return_image_paths=False,
                           image_preprocess=lambda p: seeded_media(p, tifa_side))
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        tifa_scores = scorer.batch_forward(tifa, batch_size=batch_size)
        sync()
        tifa_s = len(tifa) / (time.perf_counter() - t0)
        tifa_counts = launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            tifa_result = tifa.evaluate_scores(tifa_scores)
        tifa_want = clip_t5_launches(cfg, -(-len(tifa) // batch_size))
        log(f"[genai_bench] TIFA160_DSG: {len(tifa)} pairs at {tifa_side}x{tifa_side}, "
            f"batch_forward {tifa_s:.2f} pairs/s; {json.dumps(tifa_result)}; launches "
            f"{json.dumps(tifa_counts)}")
        check(tifa_scores.shape == (len(tifa), 1, 1) and np.isfinite(tifa_scores).all(),
              "genai_bench: TIFA160 scores")
        check(all(np.isfinite(np.asarray(v, np.float64)).all() for v in tifa_result.values()),
              "genai_bench: TIFA160 correlations not finite")
        check(tifa_counts == tifa_want, f"genai_bench: TIFA160 launches {tifa_counts} != "
                                        f"{tifa_want}")
        host_only = sorted(m for m in set(sys.modules) - modules_before
                           if m.split(".")[0] in ("pandas", "sklearn", "PIL", "cv2",
                                                  "matplotlib"))
        check(not host_only, f"genai_bench: imported {host_only}")
        del scorer, loaded["scorer"]
    finally:
        t2v.get_score_model = real_get
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return [counts, tifa_counts]


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
    engines = (CLIPT5Engine(card, cfg, tok, device), CLIPT5Engine(host, cfg, tok, "cpu"))
    t0 = time.perf_counter()
    on_card = np.log(engines[0].score_matrix(images, texts))
    t1 = time.perf_counter()
    on_cpu = np.log(engines[1].score_matrix(images, texts))
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
    t5_generation_chain(engines, [images[i % m] for i in range(n)], texts, CHAIN_TOL_NATS)
    del card, host, engines


def int8_launches(cfg, quant: str | None, t5_passes: int = 1,
                  vision_encodes: int = 1) -> int:
    """quant_matmul launches (and quantize_rows launches: one each per int8
    product) that the code gives: per T5 pass 4 a gated encoder layer
    (q|k|v, o, wi_0|wi_1, wo) and 8 a decoder layer (q|k|v, o, cross q, k,
    v, o, wi_0|wi_1, wo); under int8+vit 4 per ViT layer run (q|k|v, o,
    fc1, fc2; feature_layer=-2 runs all but the last). A non-gated MLP
    (wi, wo) has as many products as the packed gated one."""
    if not quant:
        return 0
    n = t5_passes * (4 * cfg.t5.enc_layers + 8 * cfg.t5.dec_layers)
    if quant == "int8+vit":
        n += vision_encodes * 4 * (cfg.vision.layers - 1)
    return n


@torch.no_grad()
def phase_xxl_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2) -> None:
    """clip-flant5-xxl widths, 2 ViT + 2+2 T5 layers, T5 scale folded: bf16,
    then ``int8``, then ``int8+vit`` on the same weights, each on the card
    (bf16 activations, the kernels) against the CPU (fp32 activations, the
    plain versions). Both sides quantize the same bf16 weights (the CPU copy
    in fp32 is exact), and the int8 weights and scales are checked equal.

    The int8 limit, XXL_INT8_CHAIN_TOL_NATS = 0.1: the card's activations
    are bf16, the CPU's fp32, so the two quantize ~10-15% of the elements
    of each activation row to neighbouring int8 levels (bf16 rounding is
    ~0.4% of a value, the int8 step ~2.8% of the row's std); that adds an
    error of the order of the W8A8 error itself, predicted 3-6e-2 nats on
    top of the bf16-vs-fp32 gap (~1.5e-2).
    """
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.engine.scoring import CLIPT5Engine
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIPT5Model, init_clip_t5
    from t2v_metrics_tpu_torch.ops import launch_counts, quant as Q, reset_launch_counts

    card = init_clip_t5(cfg, SEED + 2, device, torch.bfloat16)
    fold_t5_attention_scale(card, cfg)
    host = CLIPT5Model(cfg, "cpu", torch.float32)
    host.load_state_dict({k: t.float().cpu() for k, t in card.state_dict().items()})
    tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
    images, texts = seeded_images(m, 13), seeded_texts(n, 14)
    engines = (CLIPT5Engine(card, cfg, tok, device), CLIPT5Engine(host, cfg, tok, "cpu"))
    label = (f"[xxl chain] xxl widths, {len(card.vision.blocks)} ViT + "
             f"{len(card.t5.encoder.blocks)}+{len(card.t5.decoder.blocks)} T5 layers, "
             f"M={m} N={n}")
    bf16 = None
    for mode in (None, "int8", "int8+vit"):
        if mode:
            for model in (card, host):
                Q.quantize_t5_(model.t5)
                if mode == "int8+vit":
                    Q.quantize_clip_vision_(model.vision)
            host_sd = host.state_dict()
            same = all(torch.equal(t.cpu(), host_sd[k]) for k, t in card.state_dict().items()
                       if k.endswith((".w_qt", ".scale")) and t.dtype != torch.bfloat16)
            check(same, f"xxl chain {mode}: card and CPU int8 weights differ")
        reset_launch_counts()
        t0 = time.perf_counter()
        on_card = np.log(engines[0].score_matrix(images, texts))
        t1 = time.perf_counter()
        counts = launch_counts()
        on_cpu = np.log(engines[1].score_matrix(images, texts))
        t2 = time.perf_counter()
        diff = float(np.abs(on_card - on_cpu).max())
        limit = XXL_INT8_CHAIN_TOL_NATS if mode else CHAIN_TOL_NATS
        log(f"{label} {mode or 'bf16'}: card {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; "
            f"card launches quant_matmul {counts['quant_matmul']}, quantize_rows "
            f"{counts['quantize_rows']}")
        log(f"{label} {mode or 'bf16'}: log-probs card {on_card.ravel().round(4).tolist()}, "
            f"cpu {on_cpu.ravel().round(4).tolist()}")
        log(f"{label} {mode or 'bf16'}: max |card - cpu| {diff:.4e} nats (limit {limit}); "
            f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
        if bf16 is None:
            bf16 = (on_card, on_cpu)
        else:
            log(f"{label} {mode}: against bf16 on the same weights: card "
                f"{float(np.abs(on_card - bf16[0]).max()):.4e} nats, cpu (int8 vs fp32) "
                f"{float(np.abs(on_cpu - bf16[1]).max()):.4e} nats")
        want = int8_launches(cfg, mode)
        check(np.isfinite(on_card).all() and on_card.shape == (m, n),
              f"xxl chain {mode}: card scores not finite or wrong shape")
        check(counts["quant_matmul"] == want and counts["quantize_rows"] == want,
              f"xxl chain {mode}: launches {counts} (want {want} of each int8 kernel)")
        check(diff <= limit, f"xxl chain {mode}: card and CPU differ by {diff} nats")
    del card, host, engines


# ---------------------------------------------------------------------------
# Generation chains (phase 3): the cached decode path at full width
# ---------------------------------------------------------------------------

# Random-init bf16 greedy tokens part from fp32's after a few steps, so the
# card and the CPU are fed the same ids: the CPU's fp32 greedy rollout of
# GEN_STEPS + 1 tokens, the first GEN_STEPS of them forced through the cache
# (the prefill and GEN_STEPS steps give GEN_STEPS + 1 distributions). Each
# step's log P(the next forced token) is compared and printed. Two bars hold
# it: the chain bar on the statistic the scoring chains hold, a row's mean
# log-prob of its answer (here the forced continuation), and a step bar on
# the largest gap of any one step. The step bar is the chain bar for the
# dense families (xl, Qwen2.5, Gemma). The Qwen3-VL MoE step bar is
# QWEN3_STEP_TOL_NATS, from bf16's own noise there: on an H100 80GB HBM3 at
# 700 W the 30b-a3b chain's steps differed from fp32 by up to 0.197 nats
# with the plain versions in bf16 on the CPU (the router's bf16 logits
# change the top-8 set of 156 of 1056 token rows) and by 0.152 with the
# kernels on the card (164 rows), their row means by 2.07e-2 and 1.58e-2;
# Qwen2.5-VL-7B's steps by 3.2e-2 and 2.7e-2. On the card the cached steps
# are also held against one teacher-forced pass over the same slots (bf16
# both; other kernel shapes, so other roundings), with the same two bars.
GEN_STEPS = 8
QWEN3_STEP_TOL_NATS = 0.3


def rounded(x: np.ndarray) -> list:
    return np.round(x.astype(np.float64), 4).tolist()


def generation_gaps(card: np.ndarray, other: np.ndarray) -> tuple[float, float]:
    """(largest gap of one step's log P, largest gap of a row's mean over
    its steps) between two (B, steps) arrays of log-probs."""
    return (float(np.abs(card - other).max()),
            float(np.abs(card.mean(1) - other.mean(1)).max()))


def forced_rollout(lm, params_dec, prompt, fed):
    """The prefill and one cached step for each column of ``fed`` (B, K)
    host ids: (fp32 log-softmax (B, K + 1, V) of the prefill's last prompt
    row and of each step, the cache validity after the last step)."""
    from t2v_metrics_tpu_torch.models import decoder as D

    embeds, pos, n_prompts, bidir_full, deepstack = prompt
    b, s = embeds.shape[:2]
    k = fed.shape[1]
    dev = embeds.device
    valid = torch.zeros((b, s + k), dtype=torch.bool, device=dev)
    for j, n in enumerate(n_prompts):
        valid[j, :n] = True
    first, cache = lm._prefill(params_dec, embeds, pos, valid, s + k, n_prompts,
                               bidir_full, deepstack)
    last = torch.from_numpy(lm._last_pos(pos, n_prompts)).to(dev)
    ids = torch.from_numpy(fed).to(dev)
    out = [first.float().log_softmax(-1)]
    for i in range(k):
        valid[:, s + i] = True
        logits, cache = D.forward(params_dec, lm.cfg, lm._embed(params_dec, ids[:, i:i + 1]),
                                  lm._step_pos(last, i + 1, np.ndim(pos)), valid,
                                  cache=cache, cache_pos=s + i)
        out.append(logits[:, 0].log_softmax(-1))
    return torch.stack(out, 1), valid


def teacher_forced_rollout(lm, params_dec, prompt, fed, valid):
    """The rows of ``forced_rollout`` from one teacher-forced pass over the
    same slots: the prompt bucket then the fed tokens, their rope positions
    running on from each row's last prompt token, the prompt's pad slots
    invalid. (B, K + 1, V) fp32 log-softmax."""
    from t2v_metrics_tpu_torch.models import decoder as D

    embeds, pos, n_prompts, bidir_full, deepstack = prompt
    b, s = embeds.shape[:2]
    k = fed.shape[1]
    dev = embeds.device
    seq = torch.cat([embeds, lm._embed(params_dec, torch.from_numpy(fed).to(dev))], 1)
    steps = lm._last_pos(pos, n_prompts)[:, None] + 1 + np.arange(k)[None]
    if np.ndim(pos) == 3:
        steps = np.broadcast_to(steps, (3, b, k))
    pos_full = torch.from_numpy(np.concatenate([pos, steps], -1)).to(dev)
    rows = np.concatenate([np.asarray(n_prompts)[:, None] - 1,
                           np.broadcast_to(s + np.arange(k), (b, k))], 1)
    ds = None if deepstack is None else [
        torch.cat([x, x.new_zeros((b, k, x.shape[-1]))], 1) for x in deepstack]
    bidir = None if bidir_full is None else torch.from_numpy(bidir_full).to(dev)
    logits = D.forward(params_dec, lm.cfg, seq, pos_full, valid,
                       logit_positions=torch.from_numpy(rows).to(dev), deepstack=ds,
                       bidir_ids=bidir)
    return logits.log_softmax(-1)


def qwen_generation_prompt(adapter, images, texts, max_new):
    """A Qwen adapter's batched generation prompt on its device: (embeds,
    host positions, prompt lengths, None, deepstack residuals or None)."""
    from t2v_metrics_tpu_torch.models import qwen2vl as q2

    arrays, lens = adapter._prepare_pairs(images, texts)
    ids, feats, vis_mask, vis_slot, pos, _ = arrays
    main, levels = adapter._split_feats_batched(feats)
    dev = [torch.from_numpy(a).to(adapter.device) for a in (ids, vis_mask, vis_slot)]
    embeds, deepstack = q2.splice_embeds(adapter.params, dev[0], main, *dev[1:], levels)
    return embeds, pos, np.asarray(lens), None, deepstack


def gemma_generation_prompt(adapter, images, texts, max_new, num_frames=10):
    """Gemma's batched generation prompt: (embeds, positions, prompt
    lengths, cache-aligned image-block ids, None)."""
    embeds, n_prompts, bidir_full = adapter._prompt_embeds(images, texts, num_frames,
                                                           max_new)
    b, s = embeds.shape[:2]
    return embeds, np.broadcast_to(np.arange(s), (b, s)).copy(), n_prompts, bidir_full, None


def report_generation(tag, tokens, on_card, on_cpu, tf, tol, step_tol) -> None:
    """Each step's log P(the forced next token) (B, K) from the card's
    cached steps, the CPU's and the card's teacher-forced pass, printed; card
    against CPU and cached against teacher-forced, each row's mean over the
    steps within ``tol`` nats and every single step within ``step_tol``."""
    target = torch.from_numpy(tokens.astype(np.int64))[..., None]

    def pick(lp):
        return torch.gather(lp.float().cpu(), -1, target)[..., 0].numpy()

    a, c, t = pick(on_card), pick(on_cpu), pick(tf)
    (step_gap, gap), (tf_step, tf_gap) = generation_gaps(a, c), generation_gaps(a, t)
    agree = float((on_card.argmax(-1).cpu().numpy() == tokens).mean())
    log(f"{tag} generation log P(next token) card {rounded(a)}")
    log(f"{tag} generation log P(next token) cpu  {rounded(c)}")
    log(f"{tag} generation |card - cpu|: a row's mean over the steps {gap:.4e} nats "
        f"(limit {tol}), one step {step_gap:.4e} (limit {step_tol}); cached steps against "
        f"the teacher-forced pass on the card: row mean {tf_gap:.4e}, one step "
        f"{tf_step:.4e} (same limits); card argmax = the CPU's token at {agree:.3f} of "
        f"the steps")
    check(np.isfinite(a).all() and np.isfinite(t).all(), f"{tag} generation not finite")
    for what, mean, step in (("card and CPU", gap, step_gap),
                             ("cached and teacher-forced", tf_gap, tf_step)):
        check(mean <= tol and step <= step_tol,
              f"{tag} generation: {what} differ by {mean} nats (row mean), {step} (one step)")


def generation_chain(tag, scorers, prompt_fn, tol, step_tol, embed_scale=None) -> None:
    """The cached decode of a decoder family at full width: the CPU's fp32
    greedy tokens forced through the prefill and GEN_STEPS steps on the card
    (bf16, kernels) and on the CPU; each step's log P(next token) card
    against CPU, and on the card the cached steps against the teacher-forced
    pass (``report_generation``)."""
    from t2v_metrics_tpu_torch.models.generation import CachedLM

    card, host = (s.model for s in scorers)
    cfg = card.config.text
    lm = CachedLM(cfg, embed_scale)
    with torch.inference_mode():
        hp = prompt_fn(host, GEN_STEPS + 1)
        tokens, _ = lm.greedy_batch(host.params.decoder, *hp[:3], GEN_STEPS + 1,
                                    bidir_full=hp[3], deepstack=hp[4])
        fed = tokens[:, :GEN_STEPS].astype(np.int64)
        card_prompt, host_prompt = prompt_fn(card, GEN_STEPS), prompt_fn(host, GEN_STEPS)
        t0 = time.perf_counter()
        on_card, valid = forced_rollout(lm, card.params.decoder, card_prompt, fed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_cpu, _ = forced_rollout(lm, host.params.decoder, host_prompt, fed)
        tf = teacher_forced_rollout(lm, card.params.decoder, card_prompt, fed, valid)
    b, s = card_prompt[0].shape[:2]
    log(f"{tag} generation: {b} prompts in bucket {s} (lengths "
        f"{[int(n) for n in card_prompt[2]]}), prefill "
        f"+ {GEN_STEPS} cached steps fed the CPU's fp32 greedy tokens: card bf16 "
        f"{(t1 - t0) * 1e3:.1f} ms")
    report_generation(tag, tokens, on_card, on_cpu, tf, tol, step_tol)


def qwen_trace_check(tag, scorer, images, texts) -> None:
    """On the card: ``forward_with_trace`` with a one-token rollout scored
    at the start against ``forward_with_trace_teacher_forcing`` (printed)."""
    roll, _ = scorer.model.forward_with_trace(images, texts, max_new_tokens=1,
                                              score_position="start")
    tf, _ = scorer.model.forward_with_trace_teacher_forcing(images, texts)
    gap = float(np.abs(np.log(roll) - np.log(tf)).max())
    log(f"{tag} forward_with_trace (1 token, start) against teacher forcing on the card: "
        f"max {gap:.4e} nats over {len(texts)} pairs")
    check(np.isfinite(roll).all() and np.isfinite(tf).all(), f"{tag} traces not finite")


def t5_generation_chain(engines, images, texts, tol) -> None:
    """clip-flant5's cached decode steps (the T5 scale folded into W_q, as
    the chain takes it): the CPU's fp32 greedy tokens forced through
    ``decode_step`` on the card and on the CPU, log P(next token) compared
    a step; on the card, the steps against the teacher-forced ``decode``
    (``report_generation``, ``tol`` the row-mean and the step bar)."""
    from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5
    from t2v_metrics_tpu_torch.models import t5 as tt5

    def hidden(engine):
        qs = [tcft5.format_question(t, engine.cfg.conversation) for t in texts]
        arrays = engine._build_text_arrays(qs, [""] * len(texts))[:4]
        dev = [torch.from_numpy(x).to(engine.device) for x in arrays]
        idx = torch.arange(len(texts), device=engine.device)
        return engine._encode_hidden(engine.encode_images(images), dev, idx, idx), dev[3]

    def forced(engine, tokens):
        cfg = engine.cfg.t5
        t5 = engine.params.t5
        enc, mask = hidden(engine)
        ckv = tt5.cross_kv(t5, cfg, enc)
        cache = tt5.init_dec_cache(t5, cfg, len(texts), GEN_STEPS + 1)
        ids = torch.from_numpy(tokens).to(engine.device)
        start = torch.full((len(texts), 1), cfg.decoder_start_token_id,
                           dtype=torch.long, device=engine.device)
        fed = torch.cat([start, ids[:, :GEN_STEPS]], 1)
        out = []
        for step in range(GEN_STEPS + 1):
            logits, cache = tt5.decode_step(t5, cfg, fed[:, step:step + 1], cache, step,
                                            ckv, mask)
            out.append(logits.log_softmax(-1))
        tf = tt5.decode(t5, cfg, fed, enc, mask).log_softmax(-1)
        return torch.stack(out, 1), tf

    card, host = engines
    with torch.inference_mode():
        enc, mask = hidden(host)
        # eos -1: the rollout runs its full length
        tokens = tt5.greedy_decode(host.params.t5, host.cfg.t5, enc, mask, GEN_STEPS + 1,
                                   eos_id=-1).numpy()
        on_card, tf = forced(card, tokens)
        on_cpu, _ = forced(host, tokens)
    log(f"[chain] xl generation: {len(texts)} prompts, {GEN_STEPS + 1} cached T5 steps fed "
        f"the CPU's fp32 greedy tokens")
    report_generation("[chain] xl", tokens, on_card, on_cpu, tf, tol, tol)


# ---------------------------------------------------------------------------
# Phase 4: the slice through the public entry point
# ---------------------------------------------------------------------------

def phase_slice(model: str = "clip-flant5-xl", device: str = "cuda",
                quant: str | None = None, profile: bool = False,
                bf16_rows=None, generate: int = 0,
                media_checks: bool = False) -> tuple[list, np.ndarray]:
    """``VQAScore(model, init="random", quant=quant)``: the first 4 x 8 call
    with its launch counts, ``batch_forward`` of 16 x (1 image, 4 texts)
    against the pairwise forward, then with the T5 scale folded (see
    fold_t5_attention_scale) its rows against per-sample calls, pairs/s,
    memory; with ``generate``, ``generate`` of the 4 images x that many
    tokens (phase_generation); with ``media_checks``, ``npy_check`` and
    ``apollo_check`` on the same scorer. Returns the launch counts of each
    path and the folded ``batch_forward`` rows; an int8 mode prints its gap
    from ``bf16_rows``, the bf16 mode's rows on the same weights."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    name = f"{model} {quant or 'bf16'}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model=model, init="random", seed=SEED, device=device,
                          quant=quant)
    sync()
    log(f"[slice] {name} random init on {device}: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters, load peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    images, texts = seeded_images(4, 21), seeded_texts(8, 22)

    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    sync()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    # one vision encode (4 images) and one T5 pass (32 pairs); the int8
    # kernels as int8_launches says (xl bf16: 95 / 47 / 122)
    cfg = scorer.model.config
    want = clip_t5_launches(cfg, 1)
    want.update(quant_matmul=int8_launches(cfg, quant),
                quantize_rows=int8_launches(cfg, quant))
    log(f"[slice] {name} first forward (4 images x 8 texts): {t_first:.3f} s; "
        f"launches {json.dumps(counts)}; from the code {json.dumps(want)}")
    check(scores.shape == (4, 8), f"slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          "slice: scores not finite in [0, 1]")
    check(counts == want, f"slice: launch counts {counts} != {want}")
    again = scorer(images=images, texts=texts)
    check(np.array_equal(scores, again), "slice: second call differs")
    log(f"[slice] log scores row 0: {np.log(scores[0]).round(4).tolist()}")
    if media_checks:
        npy_check(scorer, name, texts, 25)
        apollo_check(scorer, name, texts, 26)

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
    worst, tol = 0.0, ROWS_TOL_NATS[(model, quant)]
    for i, sample in enumerate(data):
        one = scorer(images=sample["images"], texts=sample["texts"])
        worst = max(worst, float(np.abs(np.log(rows[i, 0]) - np.log(one[0])).max()))
    log(f"[slice] {name} T5 scale folded into W_q: batch_forward rows vs per-sample "
        f"forward max {worst:.4e} nats (limit {tol}); spread "
        f"{float(np.ptp(np.log(rows))):.4e} nats")
    check(worst <= tol, f"batch_forward rows differ by {worst} nats")
    if bf16_rows is not None:
        gap = np.abs(np.log(rows) - np.log(bf16_rows))
        log(f"[slice] {name} against bf16 on the same rows and weights (folded): "
            f"max {float(gap.max()):.4e} nats, mean {float(gap.mean()):.4e} nats")

    sync()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=8)
    sync()
    pairs_s = 64 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    sync()
    fwd_s = 32 / (time.perf_counter() - t0)
    log(f"[slice] {name} pairs/s after warm-up: batch_forward (64 pairs, batch 8) "
        f"{pairs_s:.2f}; forward (4 x 8) {fwd_s:.2f}")
    log(f"[slice] {name} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated while scoring; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=8),
                      f"{name} batch_forward")
    paths = [counts]
    if generate:
        paths.append(phase_generation(scorer, f"[generate] {name}", images, texts[:4],
                                      generate, t5=True, profile=profile,
                                      events=quant is None))
    del scorer
    return paths, rows


# ---------------------------------------------------------------------------
# Generation on the slices (phase 4)
# ---------------------------------------------------------------------------

class DecodeProbe:
    """While active, wraps the cached decoder's ``forward`` (or, ``t5``, the
    T5 ``decode_step``) to record for each cached call a pair of CUDA events
    around it, the host time of its enqueue and the kernel launches it
    makes. Events and host counters only: nothing is read back from the
    card, so the decode loop keeps its one read at the end. With
    ``traced``, the ``traced``-th cached call runs under torch.profiler
    instead, to count the device events (kernels, copies, memsets) a step
    makes (``device_events``); it is left out of ``calls``, since the
    profiler's start and stop wait for the card."""

    def __init__(self, t5: bool = False, traced: int = 0):
        from t2v_metrics_tpu_torch.models import decoder as D
        from t2v_metrics_tpu_torch.models import t5 as T

        self.mod, self.name, self.t5 = (T, "decode_step", True) if t5 else (D, "forward", False)
        self.calls, self.cache_bytes = [], 0
        self.traced, self.seen, self.device_events = traced, 0, None

    def __enter__(self):
        from t2v_metrics_tpu_torch.ops import launch_counts

        orig = self.orig = getattr(self.mod, self.name)

        def wrapped(*args, **kw):
            if not self.t5 and kw.get("cache") is None:
                return orig(*args, **kw)
            if not self.calls:    # the cache (and T5's cross k / v) of the run
                tensors = [t for layer in (args[3] if self.t5 else kw["cache"])
                           for t in layer.values()]
                if self.t5:
                    tensors += [t for kv in args[5] for t in kv]
                self.cache_bytes = sum(t.numel() * t.element_size() for t in tensors)
            self.seen += 1
            if self.seen == self.traced:
                return self.trace(orig, *args, **kw)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before, t0 = launch_counts(), time.perf_counter()
            start.record()
            out = orig(*args, **kw)
            end.record()
            after = launch_counts()
            self.calls.append((start, end, time.perf_counter() - t0,
                               {k: after[k] - before[k] for k in after if after[k] > before[k]}))
            return out

        torch.cuda.synchronize()
        self.begin = torch.cuda.Event(enable_timing=True)
        self.begin.record()
        setattr(self.mod, self.name, wrapped)
        return self

    def trace(self, orig, *args, **kw):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = orig(*args, **kw)
            torch.cuda.synchronize()
        self.device_events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        return out

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
        torch.cuda.synchronize()


def phase_generation(scorer, tag: str, images, texts, max_new: int, t5: bool = False,
                     profile: bool = False, events: bool = False) -> dict:
    """``scorer.model.generate(images, texts, max_new_tokens=max_new)`` on
    the slice's model: the launch counts of the run (its path's own, for the
    kernel table), the prefill ms (on the card's timeline from the call to
    the end of the prefill: the vision tower and the prompt's prefill; for
    T5 up to its first step: the towers, the encoder and the cross k / v),
    the median ms a decode step (device span between the step's events) and
    the host's enqueue ms a step, the steps run, generated tokens/s, the peak
    memory with the cache's bytes beside it, and the launches a decode step
    by kernel; with ``events``, the device events of one decode step (a
    short second run with that step traced); with ``profile``, the device
    busy share of a second run and of its decode steps alone: the device time and wall of a profiled run
    less those of a one-token run (towers and prefill, and for T5 one
    step), over the steps that the longer run adds."""
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with DecodeProbe(t5) as probe:
        t0 = time.perf_counter()
        outs = scorer.model.generate(images, texts, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check(len(outs) == len(texts) and all(isinstance(o, str) for o in outs),
          f"{tag} generate returned {outs!r}")
    traced = None
    if events:     # its second cached call, a decode step, traced
        with DecodeProbe(t5, traced=2) as traced:
            scorer.model.generate(images, texts, max_new_tokens=3)
    calls = probe.calls
    prefill_end = calls[0][1] if not t5 else calls[0][0]
    steps = calls if t5 else calls[1:]
    check(steps, f"{tag} generate ran no decode step")
    prefill_ms = probe.begin.elapsed_time(prefill_end)
    step_ms = statistics.median(s.elapsed_time(e) for s, e, _, _ in steps)
    host_ms = statistics.median(h for _, _, h, _ in steps) * 1e3
    tokens = len(steps) + (0 if t5 else 1)
    log(f"{tag} generate {len(texts)} x {max_new} tokens: {wall:.3f} s; prefill "
        f"{prefill_ms:.2f} ms; {len(steps)} decode steps, median {step_ms:.3f} ms a step "
        f"on the card, {host_ms:.3f} ms of host enqueue a step; "
        f"{len(texts) * tokens / wall:.1f} generated tokens/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (KV cache "
        f"{probe.cache_bytes / 2**30:.4f} GiB); launches a decode step "
        f"{json.dumps(steps[-1][3])}; "
        + (f"device events a decode step {traced.device_events}; " if traced else "")
        + f"run launches {json.dumps(counts)}")
    log(f"{tag} generated (first 60 characters of each): {[o[:60] for o in outs]}")
    if profile:
        full = phase_profile(lambda: scorer.model.generate(
            images, texts, max_new_tokens=max_new), f"{tag} generate")
        one = phase_profile(lambda: scorer.model.generate(
            images, texts, max_new_tokens=1), f"{tag} generate, one token")
        log(f"[profile] {tag} decode steps: device busy "
            f"{100 * (full[0] - one[0]) / (full[1] - one[1]):.1f}% over the "
            f"{max_new - 1} steps the {max_new}-token run adds")
    return counts


def phase_video_slice(scorer, tag: str, want: dict, seed: int,
                      profile: bool = False) -> dict:
    """The video half of a family's slice, on its image slice's model (not
    a second copy): seeded clips of 5 s at 30 fps, 480x640, decoded in
    memory (no video reader needed); ``VQAScore`` samples
    them as it samples a file. 2 clips x 4 texts through the public call
    (launch counts of the first call against ``want``, the code's counts;
    scores in range and repeatable), ``batch_forward`` of 4 x (1 clip, 4
    texts) in one chunk against the pairwise forward of the same pairs,
    pairs/s of both, the peak memory while scoring and, with ``profile``,
    the device time of the batch_forward by kernel family. Returns the first
    call's launch counts."""
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    clips = [seeded_clip(seed + i) for i in range(4)]
    texts = seeded_texts(16, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    scores = scorer(images=clips[:2], texts=texts[:4])
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    log(f"{tag} first forward (2 clips of 150 480x640 frames at 30 fps x 4 texts): "
        f"{t_first:.3f} s; launches {json.dumps(counts)}; from the code {json.dumps(want)}")
    check(scores.shape == (2, 4), f"{tag} shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          f"{tag} scores not finite in [0, 1]")
    check(counts == want, f"{tag} launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=clips[:2], texts=texts[:4])),
          f"{tag} second call differs")
    log(f"{tag} log scores: {np.log(scores).round(4).tolist()}")

    data = [{"videos": [clips[i]], "texts": texts[4 * i:4 * i + 4]} for i in range(4)]
    rows = scorer.batch_forward(data, batch_size=4)
    media, texts_ = scorer._flatten_pairs(data, "videos", 8)
    check(rows.shape == (4, 1, 4) and np.isfinite(rows).all()
          and np.array_equal(rows.ravel(), scorer.model.forward(media, texts_)),
          f"{tag} batch_forward rows differ from the pairwise forward of the same pairs")
    log(f"{tag} batch_forward rows equal the pairwise forward of the same pairs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=4)
    torch.cuda.synchronize()
    pairs_s = 16 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=clips[:2], texts=texts[:4])
    torch.cuda.synchronize()
    fwd_s = 8 / (time.perf_counter() - t0)
    log(f"{tag} pairs/s after warm-up: batch_forward (16 pairs, 4 clips, batch 4) "
        f"{pairs_s:.2f}; forward (2 clips x 4 texts) {fwd_s:.2f}")
    log(f"{tag} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated while "
        f"scoring video; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=4),
                      f"{tag} batch_forward 4 x (1 clip, 4 texts)")
    return counts


def qwen_video_buckets(adapter) -> tuple:
    """(grid, patch bucket, sequence bucket) of a Qwen adapter's prompt for
    one 40-frame 480x640 clip (fps 8 of 5 s at 30 fps), from the adapter's
    own geometry and prompt."""
    from t2v_metrics_tpu_torch.models import qwen2vl_adapter as qa

    _, _, grid = adapter._visual_grid("vid", (40, 480, 640, 3))
    s = int(np.prod(grid))
    ids = adapter._build_ids('Does this figure show "a b c d e f g"? Please answer Yes or No.',
                             s // adapter.config.vision.merge_unit, True)
    return grid, qa._bucket(s, qa.PATCH_BUCKETS), qa._bucket(len(ids) + adapter.seq_extra,
                                                             qa.SEQ_BUCKETS)


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


def chain_media(video: bool, m: int, seed: int, num_frames: int = 8):
    """The chain's visuals and what the adapter's score_matrix takes with
    them: ``m`` seeded 300x380 images, or ``m`` seeded clips of
    ``num_frames`` 480x640 frames at 8 fps (fps 8 samples every frame)."""
    if not video:
        return seeded_images(m, seed), "300x380 images"
    return ([seeded_clip(seed + i, frames=num_frames, fps=8.0) for i in range(m)],
            f"clips of {num_frames} 480x640 frames")


def phase_qwen_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2,
                     video: bool = False) -> None:
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.qwen2vl import Qwen2VLModel, init_qwen2vl

    card = init_qwen2vl(cfg, SEED + 1, device, torch.bfloat16)
    host = Qwen2VLModel(cfg, "cpu", torch.float32)
    host.load_state_dict({k: t.float().cpu() for k, t in card.state_dict().items()})
    tok = t2v.SimpleT5Tokenizer(cfg.text.vocab_size)
    (images, what), texts = chain_media(video, m, 31), seeded_texts(n, 32)
    scorers = [t2v.VQAScore(QWEN, params=p, config=cfg, tokenizer=tok, device=d)
               for p, d in ((card, device), (host, "cpu"))]
    t0 = time.perf_counter()
    on_card = np.log(scorers[0](images=images, texts=texts))
    t1 = time.perf_counter()
    on_cpu = np.log(scorers[1](images=images, texts=texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    tag = "[qwen video chain]" if video else "[qwen chain]"
    log(f"{tag} 7B widths, {cfg.vision.depth} ViT layers (full at "
        f"{cfg.vision.fullatt_block_indexes}) + {cfg.text.layers} decoder layers, "
        f"M={m} N={n} {what}: card bf16 {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s")
    log(f"{tag} mean answer log-probs card {on_card.ravel().round(4).tolist()}")
    log(f"{tag} mean answer log-probs cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"{tag} max |card - cpu| {diff:.4e} nats (limit {QWEN_CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          f"{tag} card scores not finite or wrong shape")
    check(diff <= QWEN_CHAIN_TOL_NATS, f"{tag} card and CPU differ by {diff} nats")
    if not video:
        pairs = [images[i % m] for i in range(n)]
        generation_chain(tag, scorers, lambda a, k: qwen_generation_prompt(a, pairs, texts, k),
                         QWEN_CHAIN_TOL_NATS, QWEN_CHAIN_TOL_NATS)
        qwen_trace_check(tag, scorers[0], pairs, texts)


def qwen_slice_traces(scorer, model: str, images, texts) -> dict:
    """``forward_with_trace`` on the slice's model, 4 images x 4 texts at
    ``max_new_tokens`` 1 and 4, scored at the start and at the end: scores in
    (0, 1], trace dicts of every pair, time; the launch counts of the four
    calls."""
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    for max_new in (1, 4):
        for position in ("start", "end"):
            t0 = time.perf_counter()
            probs, traces = scorer.model.forward_with_trace(
                images, texts, max_new_tokens=max_new, score_position=position)
            dt = time.perf_counter() - t0
            check(probs.shape == (4,) and np.isfinite(probs).all()
                  and ((probs > 0) & (probs <= 1)).all() and len(traces) == 4,
                  f"[trace] {model}: {probs}")
            log(f"[trace] {model} forward_with_trace max_new_tokens {max_new}, "
                f"{position}: {dt:.3f} s for 4 pairs; probabilities "
                f"{probs.round(6).tolist()}; scored indices "
                f"{[t['scored_indices'] for t in traces]}")
    return launch_counts()


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

    torch.cuda.reset_peak_memory_stats()
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
    want = {"flash_attention_flat": vit + layers, "flash_attention": 0, "layer_norm": 0,
            "rms_norm": 2 * vit + 1 + 2 * layers + 1, "rope_pack": vit + layers,
            "grouped_gemm": 0, "quant_matmul": 0, "quantize_rows": 0}
    if device != "cuda":  # the plain versions launch nothing
        want = dict.fromkeys(want, 0)
    check(counts == want, f"qwen slice: launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          "qwen slice: second call differs")
    log(f"[qwen slice] log scores: {np.log(scores).round(4).tolist()}")
    npy_check(scorer, model, texts, 45)

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
        log(f"[qwen slice] {model} peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; "
            f"card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=4),
                      f"{model} batch_forward 300x380")
        phase_profile(lambda: scorer(images=images, texts=texts),
                      f"{model} forward 4 x 4 at {side}x{side}")
    # video: one tower call (2 clips of grid (20, 24, 32), tiled windows) and
    # one prefill, so the image call's counts
    grid, patch_b, seq_b = qwen_video_buckets(scorer.model)
    log(f"[qwen video slice] grid {grid}: ViT bucket {patch_b}, prompt bucket {seq_b}")
    check((patch_b, seq_b) == (16384, 4096), f"qwen video buckets {patch_b}, {seq_b}")
    video_counts = phase_video_slice(scorer, "[qwen video slice]", want, 101, profile)
    gen_counts = phase_generation(scorer, f"[generate] {model}", images, texts, 32,
                                  profile=profile, events=True)
    trace_counts = qwen_slice_traces(scorer, model, images, texts)
    del scorer
    return [counts, video_counts, gen_counts, trace_counts]


# ---------------------------------------------------------------------------
# Qwen3-VL-30B-A3B: chain (phase 3) and slice (phase 4)
# ---------------------------------------------------------------------------

QWEN3 = "qwen3-vl-30b-a3b"


def qwen3_chain_config(vit_layers: int = 2, dec_layers: int = 2):
    """Qwen3-VL-30B-A3B widths (128 experts, top-8) cut to ``vit_layers``
    ViT layers, both tapped by a deepstack merger, and ``dec_layers``
    decoder layers, which both take a deepstack residual."""
    from t2v_metrics_tpu_torch.models.qwen3vl import resolve_config

    cfg = resolve_config(QWEN3)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=vit_layers,
                                        deepstack_indexes=tuple(range(vit_layers))),
        text=dataclasses.replace(cfg.text, layers=dec_layers))


def phase_qwen3_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2,
                      video: bool = False) -> None:
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.qwen3vl import Qwen3VLModel, init_qwen3vl
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    card = init_qwen3vl(cfg, SEED + 1, device, torch.bfloat16)
    host = Qwen3VLModel(cfg, "cpu", torch.float32)
    with torch.no_grad():    # one tensor at a time: no second host copy
        dst = host.state_dict()
        for name, t in card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    tok = t2v.SimpleT5Tokenizer(cfg.text.vocab_size)
    (images, what), texts = chain_media(video, m, 51), seeded_texts(n, 52)
    scorers = [t2v.VQAScore(QWEN3, params=p, config=cfg, tokenizer=tok, device=d)
               for p, d in ((card, device), (host, "cpu"))]
    reset_launch_counts()
    t0 = time.perf_counter()
    on_card = np.log(scorers[0](images=images, texts=texts))
    t1 = time.perf_counter()
    counts = launch_counts()
    on_cpu = np.log(scorers[1](images=images, texts=texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    tag = "[qwen3 video chain]" if video else "[qwen3 chain]"
    log(f"{tag} 30b-a3b widths, {cfg.vision.depth} ViT layers (deepstack "
        f"at {cfg.vision.deepstack_indexes}) + {cfg.text.layers} decoder layers of "
        f"{cfg.text.num_experts} experts, M={m} N={n} {what}: card bf16 "
        f"{t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; card launches {json.dumps(counts)}")
    log(f"{tag} mean answer log-probs card {on_card.ravel().round(4).tolist()}")
    log(f"{tag} mean answer log-probs cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"{tag} max |card - cpu| {diff:.4e} nats (limit {QWEN3_CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          f"{tag} card scores not finite or wrong shape")
    check(counts["grouped_gemm"] == 2 * cfg.text.layers,
          f"{tag} {counts['grouped_gemm']} grouped GEMM launches")
    check(diff <= QWEN3_CHAIN_TOL_NATS, f"{tag} card and CPU differ by {diff} nats")
    if not video:
        pairs = [images[i % m] for i in range(n)]
        generation_chain(tag, scorers, lambda a, k: qwen_generation_prompt(a, pairs, texts, k),
                         QWEN3_CHAIN_TOL_NATS, QWEN3_STEP_TOL_NATS)
        qwen_trace_check(tag, scorers[0], pairs, texts)


def phase_qwen3_slice(model: str = QWEN3, device: str = "cuda", side: int = 1024,
                      profile: bool = False) -> dict:
    """``VQAScore("qwen3-vl-30b-a3b", init="random")``, ~31 B parameters:
    4 x 4 on 1024x1024 images (992x992 after smart_resize at factor 32,
    3844 patches in bucket 4096, 961 visual tokens), the same pairs through
    ``batch_forward``, pairs/s and the slice's peak memory."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    torch.cuda.synchronize()
    log(f"[qwen3 slice] {model} random init on {device}: "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters")
    images = seeded_images(4, 61, side, side)
    texts = seeded_texts(4, 62)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[qwen3 slice] first forward (4 images {side}x{side} x 4 texts): "
        f"{t_first:.3f} s; launches {json.dumps(counts)}")
    check(scores.shape == (4, 4), f"qwen3 slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          "qwen3 slice: scores not finite in [0, 1]")
    # one same-shape image group (one tower call) and one prefill: attention
    # and rope (with the qk-norm in the decoder) once a layer; RMSNorm twice
    # a layer and the final norm; LayerNorm twice a ViT layer, the merger and
    # the deepstack mergers; the grouped GEMM twice a decoder layer (gate_up,
    # down). 30b-a3b: 75 / 75 / 145 / 58 / 96 before the qk-norm went into
    # rope, RMSNorm now 97
    v, text = scorer.model.config.vision, scorer.model.config.text
    want = {"flash_attention_flat": v.depth + text.layers, "flash_attention": 0,
            "layer_norm": 2 * v.depth + 1 + len(v.deepstack_indexes),
            "rms_norm": 2 * text.layers + 1, "rope_pack": v.depth + text.layers,
            "grouped_gemm": 2 * text.layers, "quant_matmul": 0, "quantize_rows": 0}
    check(counts == want, f"qwen3 slice: launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          "qwen3 slice: second call differs")
    log(f"[qwen3 slice] log scores: {np.log(scores).round(4).tolist()}")

    data = [{"images": [images[i]], "texts": texts} for i in range(4)]
    rows = scorer.batch_forward(data, batch_size=4)
    media, texts_ = scorer._flatten_pairs(data, "images", 8)
    check(rows.shape == (4, 1, 4)
          and np.array_equal(rows.ravel(), scorer.model.forward(media, texts_)),
          "qwen3 batch_forward rows differ from the pairwise forward")
    log("[qwen3 slice] batch_forward rows equal the pairwise forward of the same pairs")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=4)
    torch.cuda.synchronize()
    pairs_s = 16 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    fwd_s = 16 / (time.perf_counter() - t0)
    log(f"[qwen3 slice] pairs/s after warm-up: batch_forward (16 pairs at "
        f"{side}x{side}, batch 4) {pairs_s:.2f}; forward (4 x 4) {fwd_s:.2f}")
    log(f"[qwen3 slice] {model} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB allocated; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer(images=images, texts=texts),
                      f"{model} forward 4 x 4 at {side}x{side}")
    # video: one tower call (2 clips of grid (20, 20, 28)) and one prefill,
    # so the image call's counts
    grid, patch_b, seq_b = qwen_video_buckets(scorer.model)
    log(f"[qwen3 video slice] grid {grid}: ViT bucket {patch_b}, prompt bucket {seq_b}")
    check((patch_b, seq_b) == (12288, 3072), f"qwen3 video buckets {patch_b}, {seq_b}")
    video_counts = phase_video_slice(scorer, "[qwen3 video slice]", want, 111, profile)
    gen_counts = phase_generation(scorer, f"[generate] {model}", images, texts, 32,
                                  profile=profile, events=True)
    del scorer
    return [counts, video_counts, gen_counts]


# ---------------------------------------------------------------------------
# Gemma-3-4B: chain (phase 3) and slice (phase 4); clip-flant5-xl with the T5
# bias in the per-head kernel (phase 3)
# ---------------------------------------------------------------------------

GEMMA = "gemma-3-4b-it"


def gemma_chain_config(vit_layers: int = 2, untied_head: bool = False):
    """Gemma-3-4B widths cut to ``vit_layers`` SigLIP layers at 896 px and
    two decoder layers, one sliding (window 1024, the local RoPE table) and
    one full (the scaled global table).

    ``untied_head``: a seeded lm head of its own. With the tied head at
    random init the residual stream of two layers is still the token
    embedding times sqrt(d_model), so the last prompt token predicts itself
    at a logit of ~23 (the rest ~N(0, 1)) and the bf16 rounding of that one
    logit moves every answer log-prob by 0.05-0.1 nats whatever the kernels
    do: on an H100, the video chain with the plain versions in bf16 on the
    card differed from the CPU's fp32 by 0.094 nats, and in fp32 on the card
    by 7.6e-6 (the tied head's bf16 gap on the CPU, with other weights,
    0.028; untied, 4.9e-3)."""
    from t2v_metrics_tpu_torch.models.gemma3 import GEMMA3_MODELS

    cfg = GEMMA3_MODELS[GEMMA]["config"]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=vit_layers),
        text=dataclasses.replace(cfg.text, layers=2, tie_embeddings=not untied_head,
                                 layer_types=("sliding_attention", "full_attention")))


def phase_gemma_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2,
                      video: bool = False) -> None:
    """The Gemma chain on 1024x1024 images, or (``video``) on clips of 8
    frames of which the adapter takes 4 (``num_frames=4``), each its own
    tower call: 4 x 256 soft tokens, a prompt past the 1024 window."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.gemma3 import Gemma3Model, init_gemma3
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    card = init_gemma3(cfg, SEED + 1, device, torch.bfloat16)
    host = Gemma3Model(cfg, "cpu", torch.float32)
    with torch.no_grad():
        dst = host.state_dict()
        for name, t in card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    tok = t2v.SimpleT5Tokenizer(cfg.text.vocab_size)
    if video:
        (images, what), kw = chain_media(True, m, 71), {"num_frames": 4}
        what += ", 4 taken"
    else:
        images, what, kw = seeded_images(m, 71, 1024, 1024), "1024x1024 images", {}
    texts = seeded_texts(n, 72)
    scorers = [t2v.VQAScore(GEMMA, params=p, config=cfg, tokenizer=tok, device=d)
               for p, d in ((card, device), (host, "cpu"))]
    reset_launch_counts()
    t0 = time.perf_counter()
    on_card = np.log(scorers[0].model.score_matrix(images, texts, **kw))
    t1 = time.perf_counter()
    counts = launch_counts()
    on_cpu = np.log(scorers[1].model.score_matrix(images, texts, **kw))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    tag = "[gemma video chain]" if video else "[gemma chain]"
    log(f"{tag} 4b widths, {cfg.vision.layers} SigLIP layers at "
        f"{cfg.vision.image_size} px + {cfg.text.layers} decoder layers "
        f"{cfg.text.layer_types}, M={m} N={n} {what}: card bf16 "
        f"{t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; card launches {json.dumps(counts)}")
    log(f"{tag} mean answer log-probs card {on_card.ravel().round(4).tolist()}")
    log(f"{tag} mean answer log-probs cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"{tag} max |card - cpu| {diff:.4e} nats (limit {GEMMA_CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          f"{tag} card scores not finite or wrong shape")
    # one tower call per distinct video (per same-shape image group)
    calls = m if video else 1
    check(counts["flash_attention"] == calls * cfg.vision.layers
          and counts["flash_attention_flat"] == cfg.text.layers,
          f"{tag} attention launches {counts}")
    check(diff <= GEMMA_CHAIN_TOL_NATS, f"{tag} card and CPU differ by {diff} nats")
    if video:
        # the untied head's chain (see gemma_chain_config); prompts of 4 frames
        # (4 x 256 soft tokens, bucket 2048) past the 1024 window
        pairs = [images[i % m] for i in range(n)]
        generation_chain(tag, scorers, lambda a, k: gemma_generation_prompt(
            a, pairs, texts, k, num_frames=4), GEMMA_CHAIN_TOL_NATS, GEMMA_CHAIN_TOL_NATS,
            embed_scale=cfg.text.d_model ** 0.5)


def phase_inkernel_chain(cfg, device: str = "cuda", m: int = 2, n: int = 4) -> None:
    """The clip-flant5-xl chain (2 ViT + 2+2 T5 layers, T5 scale folded) on
    the card with the dense T5 bias in the flat kernel, then under
    ``INKERNEL_REL_BIAS`` with the bias computed in the per-head kernel, on
    the same parameters."""
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.engine.scoring import CLIPT5Engine
    from t2v_metrics_tpu_torch.models import t5 as T5
    from t2v_metrics_tpu_torch.models.clip_flant5 import init_clip_t5
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    card = init_clip_t5(cfg, SEED + 3, device, torch.bfloat16)
    fold_t5_attention_scale(card, cfg)
    engine = CLIPT5Engine(card, cfg, SimpleT5Tokenizer(cfg.t5.vocab_size), device)
    images, texts = seeded_images(m, 15), seeded_texts(n, 16)
    dense = np.log(engine.score_matrix(images, texts))
    T5.INKERNEL_REL_BIAS = True
    try:
        reset_launch_counts()
        inkernel = np.log(engine.score_matrix(images, texts))
        counts = launch_counts()
    finally:
        T5.INKERNEL_REL_BIAS = False
    diff = float(np.abs(inkernel - dense).max())
    enc, dec, vit = cfg.t5.enc_layers, cfg.t5.dec_layers, cfg.vision.layers - 1
    log(f"[inkernel chain] xl widths, {vit + 1} ViT + {enc}+{dec} T5 layers, M={m} N={n}: "
        f"T5 bias in the per-head kernel against the dense bias, max {diff:.4e} nats "
        f"(limit {INKERNEL_TOL_NATS}); launches per-head {counts['flash_attention']}, "
        f"flat {counts['flash_attention_flat']}")
    check(np.isfinite(inkernel).all() and inkernel.shape == (m, n),
          "inkernel chain: scores not finite or wrong shape")
    check(counts["flash_attention"] == enc + dec
          and counts["flash_attention_flat"] == vit + dec,
          f"inkernel chain: launches {counts}")
    check(diff <= INKERNEL_TOL_NATS, f"inkernel chain: the two paths differ by {diff} nats")


def phase_gemma_slice(model: str = GEMMA, device: str = "cuda", side: int = 1024,
                      profile: bool = False) -> dict:
    """``VQAScore("gemma-3-4b-it", init="random")`` at full width and depth:
    4 x 4 on 1024x1024 images (resized to 896 on the card, 4096 patches, 256
    soft tokens; prompts of ~290 tokens in bucket 512), the same 16 pairs
    through ``batch_forward``, pairs/s and the slice's peak memory."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    torch.cuda.synchronize()
    log(f"[gemma slice] {model} random init on {device}: "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters")
    images = seeded_images(4, 81, side, side)
    texts = seeded_texts(4, 82)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[gemma slice] first forward (4 images {side}x{side} x 4 texts): "
        f"{t_first:.3f} s; launches {json.dumps(counts)}")
    check(scores.shape == (4, 4), f"gemma slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          "gemma slice: scores not finite in [0, 1]")
    # one same-shape image group (one tower call) and one prefill: the
    # per-head attention once a SigLIP layer (4096 patches > 2048), LayerNorm
    # twice a SigLIP layer and its post-norm; the projector's RMSNorm; per
    # decoder layer the flat attention, rope with the qk-norm, and RMSNorm
    # four times (ln1, ln1_post, ln_ff_pre, ln_ff_post), and the final norm
    # (4b: 27 / 34 / 55 / 138 / 34; RMSNorm 172 before the qk-norm went into
    # rope)
    v, text = scorer.model.config.vision, scorer.model.config.text
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=v.layers, flash_attention_flat=text.layers,
                layer_norm=2 * v.layers + 1, rms_norm=1 + 4 * text.layers + 1,
                rope_pack=text.layers)
    check(counts == want, f"gemma slice: launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          "gemma slice: second call differs")
    log(f"[gemma slice] log scores: {np.log(scores).round(4).tolist()}")

    data = [{"images": [images[i]], "texts": texts} for i in range(4)]
    rows = scorer.batch_forward(data, batch_size=4)
    media, texts_ = scorer._flatten_pairs(data, "images", 8)
    check(rows.shape == (4, 1, 4)
          and np.array_equal(rows.ravel(), scorer.model.forward(media, texts_)),
          "gemma batch_forward rows differ from the pairwise forward")
    log("[gemma slice] batch_forward rows equal the pairwise forward of the same pairs")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=4)
    torch.cuda.synchronize()
    pairs_s = 16 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    fwd_s = 16 / (time.perf_counter() - t0)
    log(f"[gemma slice] pairs/s after warm-up: batch_forward (16 pairs at "
        f"{side}x{side}, batch 4) {pairs_s:.2f}; forward (4 x 4) {fwd_s:.2f}")
    log(f"[gemma slice] {model} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB allocated; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer(images=images, texts=texts),
                      f"{model} forward 4 x 4 at {side}x{side}")
    # video: 10 frames a clip (the default), one tower call per distinct
    # clip, each frame's image block behind its "Frame at {t}s:" text; one
    # prefill in bucket 4096, where the window bites (2 clips: 54 / 34 /
    # 110 / 139 / 34; RMSNorm 173 before the qk-norm went into rope)
    from t2v_metrics_tpu_torch.models.gemma_adapters import _bucket

    stamps = [round(i / 30.0, 2) for i in np.linspace(0, 149, 10, dtype=int)]
    ids = scorer.model._assemble('Does this figure show "a b c d e f g"? Please answer '
                                 'Yes or No.', stamps)
    log(f"[gemma video slice] 10 frames at {[float(t) for t in stamps]} s: prompt of "
        f"{len(ids)} tokens, "
        f"bucket {_bucket(len(ids) + 1)}")
    check(_bucket(len(ids) + 1) == 4096, "gemma video prompt outside bucket 4096")
    video_want = dict(want, flash_attention=2 * v.layers, layer_norm=2 * (2 * v.layers + 1),
                      rms_norm=2 + 4 * text.layers + 1)
    video_counts = phase_video_slice(scorer, "[gemma video slice]", video_want, 121,
                                     profile)
    # batched generation over 2 clips (10 frames each, prompts in bucket 4096,
    # the window biting at every step) and the per-sequence path on one image
    clips = [seeded_clip(131 + i) for i in range(2)]
    gen_counts = phase_generation(scorer, f"[generate] {model} video, batched", clips,
                                  seeded_texts(2, 132), 32, profile=profile)
    seq_counts = phase_generation(scorer, f"[generate] {model} image, per sequence",
                                  images[:1], texts[:1], 32, events=True)
    del scorer, clips
    return [counts, video_counts, gen_counts, seq_counts]


# ---------------------------------------------------------------------------
# CLIPScore and ITMScore: kernel sites (phase 2), chains (phase 3) and
# slices (phase 4)
# ---------------------------------------------------------------------------

CLIP = "openai:ViT-B-32"
ITM = "blip2-itm"
# Chains: ViT-B/32 at 2 vision + 2 text layers, BLIP-2 at 2 EVA + 2 Q-Former
# layers, bf16 on the card against fp32 on the CPU: the same chains in bf16
# on the CPU (plain versions) differ from fp32 by 6.1e-4-1.0e-3 in cosine and
# 8.8e-4-1.3e-3 in P(match) over two seeds, so 1e-2 is ~8x that.
SCORER_CHAIN_TOL = 1e-2
# Slices: batch_forward rows against per-sample forward calls at full depth
# (12 + 12 CLIP layers; 39 EVA + 12 Q-Former), other GEMM shapes and so other
# bf16 roundings (~1e-3 per 2+2-layer chain, growing with depth): 2e-2.
SCORER_ROWS_TOL = 2e-2


def attention_site(record, label, fn, plain_fn, ops, nbytes, library,
                   kernel="flash_attention_flat", checked=None) -> None:
    """Check one attention site against its plain version and record it as
    a site of ``kernel``'s row: ``ops`` the operations its masks keep,
    ``nbytes`` its inputs and output once, ``library`` (name, fn) of SDPA on
    the same inputs; ``checked``: (out, ref, ok, detail) where the caller
    compared them already."""
    if checked is None:
        out, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        ok, detail = attention_agrees(out, ref)
    else:
        out, ref, ok, detail = checked
    ms = library_ms(library[1], library[0])
    record(kernel, label, out, ref, ok, detail, fn, plain_fn, False,
           flop=ops, lower=(ops, nbytes, "bf16"),
           library=None if ms is None else (library[0], ms), site=True)


def scorer_kernels(randn, record) -> None:
    """The flat kernel and LayerNorm at the CLIPScore and ITMScore shapes
    (16 images, 16 pairs of 32 queries + 9 text tokens, 64 texts): the EVA
    ViT-g attention at head dim 88 (with two wrong plain versions that must
    fail the tolerance: scale 1/8 for 1/sqrt(88), and the last key tile,
    key 256 alone in a tile of 128, dropped), the Q-Former's cross- and
    self-attention, the CLIP text tower's causal attention; LayerNorm at
    EVA's width and the Q-Former's add + LN at eps 1e-12."""
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import norms as N

    dev = torch.device("cuda")
    sdpa = F.scaled_dot_product_attention
    b, s, h, d = 16, 257, 16, 88
    qkv = randn(b, s, 3 * h * d)
    q, k, v, _ = A._split_packed(qkv, h, None)
    ref = A.attention_flat_reference(q, k, v, h)
    cut = (torch.arange(s, device=dev) < s - 1).expand(b, s)
    for wrong, kw in (("scale 1/8", dict(scale=0.125)),
                      ("the last key tile (key 256) dropped", dict(kv_mask=cut))):
        caught, why = attention_agrees(A.attention_flat_reference(q, k, v, h, **kw), ref)
        log(f"[kernel] flash_attention_flat EVA d=88 negative control, plain version with "
            f"{wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    del ref
    qh, kh, vh = A.packed_heads(qkv, h)
    attention_site(
        record, f"EVA ViT-g ({b}, {s}, 3x1408) d=88 packed, no mask",
        lambda: A.flash_attention_flat_packed(qkv, h),
        lambda: A.attention_flat_reference(q, k, v, h), 4 * b * h * s * s * d,
        2 * b * s * 4 * h * d, ("F.scaled_dot_product_attention (no mask)",
                                lambda: sdpa(qh, kh, vh)))
    # Q-Former cross-attention: 32 queries over the 257 image rows, k and v
    # column views of the packed k|v projection
    qc, kv = randn(b, 32, 768), randn(b, s, 2 * 768)
    kc, vc = kv[..., :768], kv[..., 768:]
    heads = [t.unflatten(-1, (12, 64)).transpose(1, 2) for t in (qc, kc, vc)]
    attention_site(
        record, f"Q-Former cross q ({b}, 32, 768) k|v ({b}, {s}, 2x768) d=64",
        lambda: A.flash_attention_flat(qc, kc, vc, 12),
        lambda: A.attention_flat_reference(qc, kc, vc, 12), 4 * b * 12 * 32 * s * 64,
        2 * (2 * b * 32 * 768 + b * s * 2 * 768),
        ("F.scaled_dot_product_attention (no mask)", lambda: sdpa(*heads)))
    # Q-Former self-attention: 32 queries + 9 text tokens, the text padded
    sq = 41
    qkv_s = randn(b, sq, 3 * 768)
    lens = torch.randint(36, sq + 1, (b,), device=dev)
    mask = torch.arange(sq, device=dev)[None] < lens[:, None]
    qs, ks, vs, _ = A._split_packed(qkv_s, 12, None)
    hs = A.packed_heads(qkv_s, 12)
    attention_site(
        record, f"Q-Former self ({b}, {sq}, 3x768) d=64, kv_mask",
        lambda: A.flash_attention_flat_packed(qkv_s, 12, kv_mask=mask),
        lambda: A.attention_flat_reference(qs, ks, vs, 12, kv_mask=mask),
        4 * 12 * 64 * sq * int(lens.sum()), 2 * b * sq * 4 * 768 + b * sq,
        ("F.scaled_dot_product_attention (bool mask)",
         lambda: sdpa(*hs, attn_mask=mask[:, None, None, :])))
    # CLIP ViT-B/32 text tower: 64 texts of 77 tokens, causal
    bt, st = 64, 77
    qkv_t = randn(bt, st, 3 * 512)
    qt, kt, vt, _ = A._split_packed(qkv_t, 8, None)
    ht = A.packed_heads(qkv_t, 8)
    attention_site(
        record, f"CLIP text ({bt}, {st}, 3x512) d=64, causal",
        lambda: A.flash_attention_flat_packed(qkv_t, 8, causal=True),
        lambda: A.attention_flat_reference(qt, kt, vt, 8, causal=True),
        4 * bt * 8 * 64 * (st * (st + 1) // 2), 2 * bt * st * 4 * 512,
        ("F.scaled_dot_product_attention (is_causal)", lambda: sdpa(*ht, is_causal=True)))
    del qkv, q, k, v, qh, kh, vh, kv, heads, qkv_s, hs, qkv_t, ht
    free_cuda()

    # LayerNorm: EVA's ln1 of block 0 and its add + LN (16 images x 257
    # rows, d 1408, eps 1e-6), the Q-Former's post-LN add + LN (16 pairs x
    # 41 rows, d 768, eps 1e-12)
    for rows, dd, eps, add in ((16 * 257, 1408, 1e-6, False), (16 * 257, 1408, 1e-6, True),
                               (16 * 41, 768, 1e-12, True)):
        x, r, w, bias = randn(rows, dd, std=3.0), randn(rows, dd, std=3.0), randn(dd), randn(dd)
        if add:
            (sm, out), ref = N.add_layer_norm_fused(x, r, w, bias, eps), \
                N.layer_norm_plain(x + r, w, bias, eps)
            same = bool(torch.equal(sm, x + r))
            fn = lambda: N.add_layer_norm_fused(x, r, w, bias, eps)  # noqa: E731
            plain_fn = lambda: N.add_layer_norm_plain(x, r, w, bias, eps)  # noqa: E731
            lib = ("x + r, then F.layer_norm (two calls)",
                   lambda: F.layer_norm(x + r, (dd,), w, bias, eps))
            lower = (9 * rows * dd, 8 * rows * dd + 4 * dd, "fp32")
        else:
            out, ref, same = N.layer_norm_fused(x, w, bias, eps), \
                N.layer_norm_plain(x, w, bias, eps), True
            fn = lambda: N.layer_norm_fused(x, w, bias, eps)  # noqa: E731
            plain_fn = lambda: N.layer_norm_plain(x, w, bias, eps)  # noqa: E731
            lib = ("F.layer_norm", lambda: F.layer_norm(x, (dd,), w, bias, eps))
            lower = (8 * rows * dd, 4 * rows * dd + 4 * dd, "fp32")
        bad = outside(out, ref, NORM_ATOL, LN_RTOL)
        record("layer_norm", f"{'add + LN' if add else 'LN'} ({rows}, {dd}) eps {eps:g}",
               out, ref, bad == 0 and same,
               f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max "
               f"{bf16_ulps(out, ref)} bf16 ulps; s bitwise x + r: {same}",
               fn, plain_fn, False, lower=lower, library=(lib[0], cuda_ms(lib[1])), site=True)
        del x, r, out, ref
    free_cuda()


def clip_chain_config(layers: int = 2):
    from t2v_metrics_tpu_torch.models.clip import CLIP_ARCHS

    v, t = CLIP_ARCHS["ViT-B-32"]
    return dataclasses.replace(v, layers=layers), dataclasses.replace(t, layers=layers)


def itm_chain_config(layers: int = 2):
    from t2v_metrics_tpu_torch.models.blip2_itm import BLIP2_ITM_MODELS

    cfg = BLIP2_ITM_MODELS[ITM]["config"]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=layers),
        qformer=dataclasses.replace(cfg.qformer, layers=layers))


def scorer_launches(kind: str, cfg, encodes: int = 1) -> dict:
    """Flat attention and LayerNorm launches of one ``score_matrix`` /
    pairwise call as the code gives them. CLIPScore: one image and one text
    tower pass, attention once a layer; LayerNorm ln_pre, twice a vision
    layer, ln_post, twice a text layer, ln_final. ITMScore: ``encodes``
    tower calls (one a same-shape image group), each attention once a layer
    and LayerNorm twice a layer and its post-LN; one Q-Former pass, attention
    once a layer and once a cross layer, LayerNorm ln_emb, three times a layer
    (self, query FFN, text FFN) and once a cross layer."""
    want = dict.fromkeys(KERNELS, 0)
    if kind == "clip":
        v, t = cfg
        want.update(flash_attention_flat=v.layers + t.layers,
                    layer_norm=2 * v.layers + 2 + 2 * t.layers + 1)
    else:
        v, qf = cfg.vision, cfg.qformer
        cross = -(-qf.layers // qf.cross_attention_frequency)
        want.update(flash_attention_flat=encodes * v.layers + qf.layers + cross,
                     layer_norm=encodes * (2 * v.layers + 1) + 1 + 3 * qf.layers + cross)
    return want


@torch.no_grad()
def phase_scorer_chains(device: str = "cuda", m: int = 2, n: int = 4) -> None:
    """CLIPScore at ViT-B/32 widths (2 vision + 2 text layers) and ITMScore at
    blip2-itm widths (2 EVA layers at 224 px, 2 Q-Former layers, layer 0 with
    cross-attention) on seeded 300x380 images: the card in bf16 with the
    kernels against the CPU in fp32 with the plain versions, on one set of
    random parameters each, with the card's launch counts."""
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.engine.scoring import CLIPEngine
    from t2v_metrics_tpu_torch.models import blip2_itm as tbitm
    from t2v_metrics_tpu_torch.models import clip as tclip
    from t2v_metrics_tpu_torch.models.itm_adapter import Blip2ITMAdapter
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    images, texts = seeded_images(m, 31), seeded_texts(n, 32)
    v, t = clip_chain_config()
    card = tclip.init_clip(v, t, SEED + 3, device, torch.bfloat16)
    host = tclip.CLIPModel(v, t, "cpu", torch.float32)
    host.load_state_dict({k: x.float().cpu() for k, x in card.state_dict().items()})
    cfg = itm_chain_config()
    icard = tbitm.init_blip2_itm(cfg, SEED + 4, device, torch.bfloat16)
    ihost = tbitm.Blip2ITMModel(cfg, "cpu", torch.float32)
    ihost.load_state_dict({k: x.float().cpu() for k, x in icard.state_dict().items()})
    runs = (
        ("clip", f"[clip chain] {CLIP} widths, 2 vision + 2 text layers", (v, t),
         lambda model, dev, tok: CLIPEngine(model, v, t, tok, dev).score_matrix(images, texts),
         (card, host), t.vocab_size),
        ("itm", f"[itm chain] {ITM} widths, 2 EVA + 2 Q-Former layers", cfg,
         lambda model, dev, tok: Blip2ITMAdapter(
             ITM, dev, params=model, config=cfg, tokenizer=tok).score_matrix(images, texts),
         (icard, ihost), cfg.qformer.vocab_size))
    for kind, label, kcfg, score, (on_dev, on_host), vocab in runs:
        tok = SimpleT5Tokenizer(vocab)
        reset_launch_counts()
        t0 = time.perf_counter()
        got = score(on_dev, device, tok)
        t1 = time.perf_counter()
        counts = launch_counts()
        want = score(on_host, "cpu", tok)
        t2 = time.perf_counter()
        diff = float(np.abs(got - want).max())
        log(f"{label}, M={m} N={n}: card bf16 {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; "
            f"card launches flat attention {counts['flash_attention_flat']}, LayerNorm "
            f"{counts['layer_norm']}")
        log(f"{label}: card {got.ravel().round(5).tolist()}")
        log(f"{label}: cpu  {want.ravel().round(5).tolist()}")
        log(f"{label}: max |card - cpu| {diff:.4e} (limit {SCORER_CHAIN_TOL}); spread "
            f"over pairs {float(np.ptp(want)):.4e}")
        check(np.isfinite(got).all() and got.shape == (m, n),
              f"{kind} chain: card scores not finite or wrong shape")
        check(counts == scorer_launches(kind, kcfg),
              f"{kind} chain: launches {counts} != {scorer_launches(kind, kcfg)}")
        check(diff <= SCORER_CHAIN_TOL, f"{kind} chain: card and CPU differ by {diff}")


def phase_scorer_slice(kind: str, device: str = "cuda", profile: bool = False) -> dict:
    """``CLIPScore("openai:ViT-B-32", init="random")`` (8 images x 32 texts,
    then ``batch_forward`` of 64 x (1 image, 4 texts) in chunks of 16
    samples) or ``ITMScore("blip2-itm", init="random")`` (39 EVA layers, 12
    Q-Former layers; 4 x 8, then 16 x (1, 4) in one chunk), on seeded
    300x380 images: launch counts of the first call against the code's,
    scores in range and repeatable, the batch_forward rows equal to the
    pairwise forward of the same chunk and near per-sample calls, pairs/s,
    peak memory. Returns the first call's launch counts."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    clip = kind == "clip"
    name, tag = (CLIP, "[clip slice]") if clip else (ITM, "[itm slice]")
    m, n, samples, chunk = (8, 32, 64, 16) if clip else (4, 8, 16, 16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = (t2v.CLIPScore if clip else t2v.ITMScore)(name, init="random", seed=SEED,
                                                       device=device)
    torch.cuda.synchronize()
    model = scorer.model.engine.params if clip else scorer.model.params
    params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {name} random init on {device}: {time.perf_counter() - t0:.2f} s; "
        f"{params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    images, texts = seeded_images(m, 41), seeded_texts(n, 42)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    cfg = (scorer.model.vcfg, scorer.model.tcfg) if clip else scorer.model.config
    want = scorer_launches(kind, cfg)
    log(f"{tag} first forward ({m} images x {n} texts): {t_first:.3f} s; launches "
        f"{json.dumps(counts)}; from the code {json.dumps(want)}")
    lo = -1.0 if clip else 0.0
    check(scores.shape == (m, n), f"{kind} slice: shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= lo) & (scores <= 1)).all(),
          f"{kind} slice: scores not finite in [{lo}, 1]")
    check(counts == want, f"{kind} slice: launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          f"{kind} slice: second call differs")
    log(f"{tag} scores row 0: {scores[0].round(5).tolist()}; spread "
        f"{float(np.ptp(scores)):.4e}")

    pool_images, pool_texts = seeded_images(samples, 43), seeded_texts(4 * samples, 44)
    data = [{"images": [pool_images[i]], "texts": pool_texts[4 * i:4 * i + 4]}
            for i in range(samples)]
    rows = scorer.batch_forward(data, batch_size=chunk)
    check(rows.shape == (samples, 1, 4), f"{kind} batch_forward shape {rows.shape}")
    media, texts_ = scorer._flatten_pairs(data[:chunk], "images", 8)
    check(np.array_equal(rows[:chunk].ravel(), scorer.model.forward(media, texts_)),
          f"{kind} batch_forward rows differ from the pairwise forward of the same chunk")
    worst = max(float(np.abs(rows[i, 0] - scorer(images=data[i]["images"],
                                                  texts=data[i]["texts"])[0]).max())
                for i in range(16))
    log(f"{tag} batch_forward rows equal the pairwise forward of the same chunk; rows vs "
        f"per-sample forward (16 samples) max {worst:.4e} (limit {SCORER_ROWS_TOL})")
    check(worst <= SCORER_ROWS_TOL, f"{kind} batch_forward rows differ by {worst}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=chunk)
    torch.cuda.synchronize()
    pairs_s = 4 * samples / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    fwd_s = m * n / (time.perf_counter() - t0)
    log(f"{tag} {name} pairs/s after warm-up: batch_forward ({4 * samples} pairs, "
        f"batch {chunk}) {pairs_s:.2f}; forward ({m} x {n}) {fwd_s:.2f}")
    log(f"{tag} {name} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=chunk),
                      f"{name} batch_forward")
    del scorer, model
    return counts


# ---------------------------------------------------------------------------
# PaliGemma, Gemma 4, LLaVA-1.5 and InstructBLIP: kernel sites (phase 2),
# chains (phase 3) and slices (phase 4)
# ---------------------------------------------------------------------------

PALIGEMMA = "paligemma-3b-mix-448"
GEMMA4 = "gemma-4-12b-it"
GEMMA4_31B = "gemma-4-31b-it"
LLAVA = "llava-v1.5-7b"
INSTRUCTBLIP = "instructblip-flant5-xl"


def prefix_ids(lens: torch.Tensor, s: int) -> torch.Tensor:
    """PaliGemma's overlay: group 0 on each row's valid prompt (image and
    text), -1 on its pad rows."""
    rows = torch.arange(s, device=lens.device)[None]
    return torch.where(rows < lens[:, None], 0, -1).int()


def checked_site(record, label, packed, heads, kw, wrongs, kernel_kw=None) -> None:
    """A packed flat attention site: the kernel against its plain version,
    each of ``wrongs`` ((name, kw override) pairs:
    wrong plain versions) refused by the tolerance, the bound from the
    pairs the masks keep and SDPA on the same views (causal sites), or the
    caller's ``kernel_kw`` yardsticks."""
    from t2v_metrics_tpu_torch.ops import attention as A

    q, k, v, _ = A._split_packed(packed, heads, kw.get("kv_heads"))
    # the GQA prefills one kv head at a time (their fp32 scores at once
    # would not fit); the others in one call
    plain = plain_by_kv_heads if kw.get("kv_heads") else A.attention_flat_reference
    ref = plain(q, k, v, heads, **kw)
    for wrong, over in wrongs:
        caught, why = attention_agrees(plain(q, k, v, heads, **{**kw, **over}), ref)
        log(f"[kernel] flash_attention_flat {label} negative control, plain version with "
            f"{wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    if kernel_kw is None:
        ops, lower, library = masked_attention_yardsticks(label, packed, heads, kw)
        kernel_kw = dict(flop=ops, lower=lower, library=library)
    out = A.flash_attention_flat_packed(packed, heads, **kw)
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    record("flash_attention_flat", label, out, ref, ok, detail,
           lambda: A.flash_attention_flat_packed(packed, heads, **kw),
           lambda: plain(q, k, v, heads, **kw), False, site=True, **kernel_kw)


def family_kernels(randn, record, lengths_mask) -> None:
    """The kernel sites of the PaliGemma, Gemma 4, LLaVA-1.5 and InstructBLIP
    paths that no earlier slice runs, each against its plain version with
    two wrong plain versions that must fail, its bound and SDPA's time:
    PaliGemma's prefill (MQA 8/1 at d 256, one bidirectional group over each
    whole prompt, pad rows causal and masked) at 448 px (16 pairs of ~1050
    rows in bucket 2048) and at 896 px (2 pairs of ~4130 rows in bucket
    4352, past 4096); Gemma 4-31b's prefill at d 128 (GQA 32/16, window 1024
    and ten image blocks, a 10-frame prompt in bucket 4096) and Gemma
    4-12b's (GQA 16/8 at d 256, 16 pairs in bucket 512); LLaVA-7b's prefill
    (MHA at d 128, 16 pairs of ~640 rows in bucket 704, causal, kv_mask);
    SigLIP-224 and -448 in the flat kernel at d 72; InstructBLIP's Q-Former
    self-attention (32 queries + the instruction, kv_mask) and its T5-xl
    encoder (32 query rows + the prompt, the dense bias, kv_mask); the
    decode steps of Gemma 4-12b (GQA 16/8), PaliGemma (MQA, a cache of one
    kv head) and LLaVA-7b; RMSNorm, alone and with the add, at d 2048 (Gemma offset), 3840, 4096 (eps
    1e-5) and 5376, and rope on the new packed layouts. The plain versions
    run one kv head at a time."""
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    sdpa = F.scaled_dot_product_attention
    # PaliGemma: the whole valid prompt is one group
    for label, b, s, lo, hi in (("PaliGemma-448", 16, 2048, 1040, 1060),
                                ("PaliGemma-896", 2, 4352, 4120, 4140)):
        mask = lengths_mask(b, s, lo, hi)
        lens = mask.sum(1)
        kw = dict(kv_heads=1, causal=True, kv_mask=mask, bidir_ids=prefix_ids(lens, s))
        checked_site(record, f"{label} prefill ({b}, {s}, 10x256) d=256, MQA 8/1, one bidir "
                     f"group over each prompt ({lo}-{hi} rows), kv_mask", randn(b, s, 2560), 8,
                     kw, (("no overlay", {"bidir_ids": None}),
                          ("the group 128 rows short (its last key tile unseen)",
                           {"bidir_ids": prefix_ids(lens - 128, s)})))
        free_cuda()
    # Gemma 4-31b: the band at d 128 over a 10-frame prompt; Gemma 4-12b at
    # the slice's shape (the window does not bite in bucket 512)
    ids, rows = video_blocks(2, 4096)
    kw = dict(kv_heads=16, causal=True, scale=168 ** -0.5, local_window=1024, bidir_ids=ids,
              kv_mask=lengths_mask(2, 4096, rows - 8, rows))
    checked_site(record, "Gemma 4-31b video prefill (2, 4096, 64x128) d=128, GQA 32/16, "
                 "window 1024 and ten 256-row image blocks, kv_mask", randn(2, 4096, 64 * 128),
                 32, kw, (("no window", {"local_window": None}),
                          ("no overlay", {"bidir_ids": None})))
    free_cuda()
    ids = torch.full((16, 512), -1, dtype=torch.int32, device="cuda")
    ids[:, 4:260] = 0
    kw = dict(kv_heads=8, causal=True, scale=256 ** -0.5, local_window=1024, bidir_ids=ids,
              kv_mask=lengths_mask(16, 512, 285, 295))
    checked_site(record, "Gemma 4-12b prefill (16, 512, 32x256) d=256, GQA 16/8, window "
                 "1024, one 256-row image block, kv_mask", randn(16, 512, 32 * 256), 16, kw,
                 (("no overlay", {"bidir_ids": None}), ("no kv_mask",
                                                         {"kv_mask": torch.ones_like(
                                                             kw["kv_mask"])})))
    free_cuda()
    mask = lengths_mask(16, 704, 630, 650)
    checked_site(record, "LLaVA-7b prefill (16, 704, 96x128) d=128, MHA, causal, kv_mask",
                 randn(16, 704, 96 * 128), 32, dict(kv_heads=32, causal=True, kv_mask=mask),
                 (("no causal mask", {"causal": False}),
                  ("no kv_mask", {"kv_mask": torch.ones_like(mask)})))
    free_cuda()
    # SigLIP-224 / 448: no mask; InstructBLIP's Q-Former and T5 encoder
    for size, s in ((224, 256), (448, 1024)):
        packed = randn(4, s, 3 * 1152)
        qh, kh, vh = A.packed_heads(packed, 16)
        cut = (torch.arange(s, device="cuda") < s - 64).expand(4, s)
        ms = library_ms(lambda: sdpa(qh, kh, vh), "F.scaled_dot_product_attention")  # noqa: B023
        ops = 4 * 4 * 16 * s * s * 72
        checked_site(record, f"SigLIP-{size} (4, {s}, 3x1152) d=72 packed, no mask", packed,
                     16, {}, (("scale 1/8", {"scale": 0.125}),
                              ("the last 64 keys dropped", {"kv_mask": cut})),
                     dict(flop=ops, lower=(ops, 2 * 4 * s * 4 * 1152, "bf16"),
                          library=None if ms is None else
                          ("F.scaled_dot_product_attention (no mask)", ms)))
        del packed, qh, kh, vh
    b, s = 16, 50
    mask = lengths_mask(b, s, 45, 50)
    packed = randn(b, s, 3 * 768)
    hs = A.packed_heads(packed, 12)
    ms = library_ms(lambda: sdpa(*hs, attn_mask=mask[:, None, None, :]),
                    "F.scaled_dot_product_attention (bool mask)")
    ops = 4 * 12 * 64 * s * int(mask.sum())
    checked_site(record, f"InstructBLIP Q-Former self ({b}, {s}, 3x768) d=64, 32 queries + "
                 "the instruction, kv_mask", packed, 12, dict(kv_mask=mask),
                 (("no kv_mask", {"kv_mask": None}), ("a causal mask", {"causal": True})),
                 dict(flop=ops, lower=(ops, 2 * b * s * 4 * 768 + b * s, "bf16"),
                      library=None if ms is None else
                      ("F.scaled_dot_product_attention (bool mask)", ms)))
    packed = randn(b, s, 3 * 2048)
    kw = dict(bias=randn(1, 32, s, s, dtype=torch.float32, std=3.0),
              kv_mask=lengths_mask(b, s, 45, 50), scale=1.0)
    checked_site(record, f"InstructBLIP T5-xl encoder ({b}, {s}, 3x2048) d=64, 32 query rows "
                 "+ the prompt, bias, kv_mask", packed, 32, kw,
                 (("no bias", {"bias": None}), ("no kv_mask", {"kv_mask": None})),
                 t5_attention_yardsticks((packed, 32), kw))
    del packed, hs, kw
    free_cuda()

    # decode steps (DECODE_STEP generated slots in): no window bites, so the
    # wrong versions drop the key mask or double the scale
    for label, b, s, h, kvh, d in (("Gemma 4-12b rollout", 16, 512, 16, 8, 256),
                                   ("PaliGemma generate", 1, 2048, 8, 1, 256),
                                   ("LLaVA-7b generate", 4, 704, 32, 32, 128)):
        cache_attention_site(
            record, randn, f"{label} decode, q ({b}, 1, {h}x{d}) over a ({b}, {s + 32}, "
            f"{kvh}x{d}) cache view of {s + DECODE_STEP + 1} slots, {h}/{kvh} heads, kv_mask",
            b, s, h, kvh, d, lengths_mask(b, s, s // 2, s - 8),
            wrongs=(("no kv_mask", {"kv_mask": None}), ("the scale doubled",
                                                        {"scale": 2 * d ** -0.5})))
        free_cuda()

    # RMSNorm at the new widths (a row a token: the slices' prefills), alone
    # and through the add entry, and rope on the new packed q|k|v layouts
    for label, rows, d, eps, offset in (("PaliGemma (Gemma offset)", 16 * 2048, 2048, 1e-6, 1.0),
                                        ("Gemma 4-12b", 16 * 512, 3840, 1e-6, 1.0),
                                        ("LLaVA-7b (eps 1e-5)", 16 * 704, 4096, 1e-5, 0.0),
                                        ("Gemma 4-31b", 2 * 4096, 5376, 1e-6, 1.0)):
        x, r, w = randn(rows, d, std=3.0), randn(rows, d, std=3.0), randn(d)
        kw = dict(eps=eps, offset=offset, cast=offset == 0.0)
        rms_site(record, f"{label} ({rows}, {d})", x, w, **kw)
        rms_site(record, f"{label} add + RMSNorm ({rows}, {d})", x, w, r=r, **kw)
        del x, r
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for label, b, s, heads, rot, d in (("PaliGemma", 16, 2048, 10, 9, 256),
                                       ("LLaVA-7b", 16, 704, 96, 64, 128),
                                       ("Gemma 4-31b", 2, 4096, 64, 48, 128)):
        pk = randn(b, s, heads * d)
        ang = (torch.randint(0, 4096, (b, s, 1), generator=gen, device="cuda").float()
               * randn(d, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        buf = pk.clone()
        out, ref = R.rope_pack(buf, cos, sin, rot, d), R.rope_pack_plain(pk, cos, sin, rot, d)
        bad = outside(out, ref, NORM_ATOL, ROPE_RTOL)
        v_same = bool(torch.equal(out[..., rot * d:], pk[..., rot * d:]))
        record("rope_pack", f"{label} ({b}, {s}, {heads * d}) {rot} heads of {d}", out, ref,
               bad == 0 and v_same, f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps; v lanes untouched {v_same}",
               lambda: R.rope_pack(buf, cos, sin, rot, d),  # noqa: B023
               lambda: R.rope_pack_plain(pk, cos, sin, rot, d), False,  # noqa: B023
               lower=(3 * b * s * rot * d, 4 * b * s * rot * d + 8 * b * s * d, "fp32"),
               site=True)
        del pk, buf, out, ref, cos, sin, ang
    free_cuda()


def family_chain_config(model: str):
    """``model``'s registry config at full width, cut to 2 tower layers and 2
    decoder layers (one sliding and one full for Gemma 4), or 2 EVA, 2
    Q-Former (one with cross-attention) and 2+2 T5 layers.

    PaliGemma and Gemma 4 get a seeded lm head of their own (see
    gemma_chain_config): with the tied head at random init the last prompt
    token predicts itself at a logit of ~40 (PaliGemma: the normalized
    embedding over its std 0.02, dotted with itself), and the bf16 rounding
    of that one logit (ulp 0.25) moves every log-prob by up to 0.125 nats
    whatever the kernels do. LLaVA's head is untied in the model itself."""
    from t2v_metrics_tpu_torch.models.gemma4 import GEMMA4_MODELS
    from t2v_metrics_tpu_torch.models.instructblip import INSTRUCTBLIP_MODELS
    from t2v_metrics_tpu_torch.models.llava import LLAVA_MODELS
    from t2v_metrics_tpu_torch.models.paligemma import PALIGEMMA_MODELS

    if model == INSTRUCTBLIP:
        cfg = INSTRUCTBLIP_MODELS[model]["config"]
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=2),
            qformer=dataclasses.replace(cfg.qformer, layers=2),
            t5=dataclasses.replace(cfg.t5, enc_layers=2, dec_layers=2))
    cfg = {**PALIGEMMA_MODELS, **GEMMA4_MODELS, **LLAVA_MODELS}[model]["config"]
    text = dict(layers=2, tie_embeddings=False)
    if cfg.text.layer_types is not None:
        text["layer_types"] = ("sliding_attention", "full_attention")
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                               text=dataclasses.replace(cfg.text, **text))


def phase_family_chain(model: str, device: str = "cuda", m: int = 2, n: int = 2) -> None:
    """One family's chain (``family_chain_config``) on seeded 1024x1024
    images, the card in bf16 with the kernels against the CPU in fp32 with
    the plain versions, on one set of random parameters: the log scores of
    score_matrix within the chain bar (PaliGemma's first-token log-prob and
    LLaVA's mean answer log-prob 5e-2 nats; InstructBLIP's, with the T5 scale
    folded into W_q, 2.5e-2), or for Gemma 4, whose score is a greedy rollout
    that bf16 may steer elsewhere, the CPU's fp32 greedy tokens forced
    through the prefill and GEN_STEPS cached steps on both sides
    (``generation_chain``: each row's mean and every step within 5e-2)."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models import gemma3, instructblip, llava, paligemma
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = family_chain_config(model)
    init, cls = {PALIGEMMA: (paligemma.init_paligemma, paligemma.PaliGemmaModel),
                 LLAVA: (llava.init_llava, llava.LlavaModel),
                 INSTRUCTBLIP: (instructblip.init_instructblip,
                                instructblip.InstructBlipModel)}.get(
        model, (gemma3.init_gemma3, gemma3.Gemma3Model))
    card = init(cfg, SEED + 6, device, torch.bfloat16)
    if model == INSTRUCTBLIP:
        fold_t5_attention_scale(card, cfg)
    host = cls(cfg, "cpu", torch.float32)
    with torch.no_grad():
        dst = host.state_dict()
        for name, t in card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    vocab = cfg.t5.vocab_size if model == INSTRUCTBLIP else cfg.text.vocab_size
    kw = dict(config=cfg, tokenizer=t2v.SimpleT5Tokenizer(vocab))
    if model == INSTRUCTBLIP:
        kw["qf_tokenizer"] = t2v.SimpleT5Tokenizer(cfg.qformer.vocab_size)
    scorers = [t2v.VQAScore(model, params=p, device=d, **kw)
               for p, d in ((card, device), (host, "cpu"))]
    images, texts = seeded_images(m, 141, 1024, 1024), seeded_texts(n, 142)
    tag = f"[{model} chain]"
    widths = (f"{cfg.vision.layers} EVA + {cfg.qformer.layers} Q-Former + "
              f"{cfg.t5.enc_layers}+{cfg.t5.dec_layers} T5 layers"
              if model == INSTRUCTBLIP else
              f"{cfg.vision.layers} tower + {cfg.text.layers} decoder layers")
    if model in (GEMMA4, GEMMA4_31B):
        pairs = [images[i % m] for i in range(n)]
        log(f"{tag} full widths, {widths}, untied head, {n} prompts of 1024x1024 images")
        generation_chain(tag, scorers, lambda a, k: gemma_generation_prompt(a, pairs, texts, k),
                         GEMMA_CHAIN_TOL_NATS, GEMMA_CHAIN_TOL_NATS,
                         embed_scale=cfg.text.d_model ** 0.5)
        del card, host, scorers
        return
    tol = CHAIN_TOL_NATS if model == INSTRUCTBLIP else GEMMA_CHAIN_TOL_NATS
    reset_launch_counts()
    t0 = time.perf_counter()
    on_card = np.log(scorers[0].model.score_matrix(images, texts))
    t1 = time.perf_counter()
    counts = launch_counts()
    on_cpu = np.log(scorers[1].model.score_matrix(images, texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    log(f"{tag} full widths, {widths}, M={m} N={n} 1024x1024 images: card bf16 "
        f"{t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; card launches {json.dumps(counts)}")
    log(f"{tag} log scores card {on_card.ravel().round(4).tolist()}")
    log(f"{tag} log scores cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"{tag} max |card - cpu| {diff:.4e} nats (limit {tol}); spread over pairs "
        f"{float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (m, n),
          f"{tag} card scores not finite or wrong shape")
    check(counts == family_launches(model, cfg), f"{tag} launches {counts} != "
          f"{family_launches(model, cfg)}")
    check(diff <= tol, f"{tag} card and CPU differ by {diff} nats")
    del card, host, scorers


def family_launches(model: str, cfg, rollout: int = 5) -> dict:
    """The launches one ``score_matrix`` call of one image group makes, from
    the code: PaliGemma's SigLIP in the flat kernel (up to 2048 patches; past
    that the per-head kernel) with two LayerNorms a layer and the post-norm,
    then one prefill with the flat attention, rope and two RMSNorms a layer
    and the final one; Gemma 4's SigLIP (at 896 px in the per-head kernel),
    the projector's RMSNorm and ``rollout`` decoder passes (the prefill and the
    steps) of four RMSNorms a layer (the qk-norm runs in rope) and the final
    one; LLaVA's CLIP tower
    to feature layer -2 (ln_pre and two LayerNorms a layer run), then the
    prefill; InstructBLIP's EVA tower (two LayerNorms a layer and the
    post-norm), the Q-Former (self-attention every layer, cross-attention
    every second; the embedding LayerNorm, one a layer for self-attention,
    for cross-attention and for each of the two FFNs) and one T5 pass with
    the dense bias in the flat kernel (RMSNorm twice an encoder and three
    times a decoder layer, and each stack's final norm)."""
    want = dict.fromkeys(KERNELS, 0)
    if model == INSTRUCTBLIP:
        qf, t5 = cfg.qformer, cfg.t5
        cross = -(-qf.layers // qf.cross_attention_frequency)
        want.update(flash_attention_flat=cfg.vision.layers + qf.layers + cross
                    + t5.enc_layers + 2 * t5.dec_layers,
                    layer_norm=2 * cfg.vision.layers + 1 + 1 + 3 * qf.layers + cross,
                    rms_norm=2 * t5.enc_layers + 1 + 3 * t5.dec_layers + 1)
        return want
    from t2v_metrics_tpu_torch.models.siglip import FLAT_MAX_KEYS

    v, text = cfg.vision, cfg.text
    if model == LLAVA:
        want.update(flash_attention_flat=v.layers - 1 + text.layers,
                    layer_norm=1 + 2 * (v.layers - 1), rms_norm=2 * text.layers + 1,
                    rope_pack=text.layers)
        return want
    passes = 1 if model == PALIGEMMA else rollout
    per_head = v.num_patches > FLAT_MAX_KEYS
    want.update(flash_attention=v.layers if per_head else 0,
                flash_attention_flat=(0 if per_head else v.layers) + passes * text.layers,
                layer_norm=2 * v.layers + 1, rope_pack=passes * text.layers,
                rms_norm=(2 * text.layers + 1 if model == PALIGEMMA
                          else 1 + passes * (4 * text.layers + 1)))
    return want


def phase_family_slice(model: str, device: str = "cuda", side: int = 1024,
                       profile: bool = False) -> list:
    """``VQAScore(model, init="random")`` at full width and depth: 4 x 4 on
    seeded side x side images with the launch counts of the first call
    against the code's, scores in [0, 1] and repeatable, ``batch_forward``
    of 8 x (1 seeded 300x380 image, 4 texts) in one chunk equal to the
    pairwise forward of the same pairs, pairs/s, peak memory at load and
    while scoring; then (not Gemma 4, whose score is its own rollout)
    ``generate`` of 8 tokens (PaliGemma one sequence, LLaVA and InstructBLIP
    the 4 images batched). Returns the launch counts of each path."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"[{model} slice]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    torch.cuda.synchronize()
    log(f"{tag} random init on {device}: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters, load peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    images, texts = seeded_images(4, 151, side, side), seeded_texts(4, 152)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = launch_counts()
    want = family_launches(model, scorer.model.config)
    log(f"{tag} first forward (4 images {side}x{side} x 4 texts): {t_first:.3f} s; "
        f"launches {json.dumps(counts)}; from the code {json.dumps(want)}")
    check(scores.shape == (4, 4), f"{tag} shape {scores.shape}")
    check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
          f"{tag} scores not finite in [0, 1]")
    check(counts == want, f"{tag} launch counts {counts} != {want}")
    check(np.array_equal(scores, scorer(images=images, texts=texts)),
          f"{tag} second call differs")
    log(f"{tag} log scores: {np.log(scores).round(4).tolist()}")

    pool, pool_texts = seeded_images(8, 153), seeded_texts(32, 154)
    data = [{"images": [pool[i]], "texts": pool_texts[4 * i:4 * i + 4]} for i in range(8)]
    rows = scorer.batch_forward(data, batch_size=8)
    media, texts_ = scorer._flatten_pairs(data, "images", 8)
    check(rows.shape == (8, 1, 4)
          and np.array_equal(rows.ravel(), scorer.model.forward(media, texts_)),
          f"{tag} batch_forward rows differ from the pairwise forward of the same pairs")
    log(f"{tag} batch_forward 8 x (1, 4) rows equal the pairwise forward; log rows "
        f"spread {float(np.ptp(np.log(rows))):.4e} nats")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=8)
    torch.cuda.synchronize()
    pairs_s = 32 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    scorer(images=images, texts=texts)
    torch.cuda.synchronize()
    fwd_s = 16 / (time.perf_counter() - t0)
    log(f"{tag} pairs/s after warm-up: batch_forward (32 pairs at 300x380, batch 8) "
        f"{pairs_s:.2f}; forward (4 x 4 at {side}x{side}) {fwd_s:.2f}")
    log(f"{tag} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated while "
        f"scoring; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=8),
                      f"{model} batch_forward")
    paths = [counts]
    if model == PALIGEMMA:
        paths.append(phase_generation(scorer, f"[generate] {model}, one sequence",
                                      images[:1], texts[:1], 8, profile=profile))
    elif model in (LLAVA, INSTRUCTBLIP):
        paths.append(phase_generation(scorer, f"[generate] {model}", images, texts, 8,
                                      t5=model == INSTRUCTBLIP, profile=profile))
    del scorer
    return paths


# ---------------------------------------------------------------------------
# InternVL 3 / 3.5 and Molmo2: kernel sites (phase 2), chains (phase 3) and
# slices (phase 4)
# ---------------------------------------------------------------------------

INTERNVL = "internvl3.5-8b"
INTERNVL_38B = "internvl3.5-38b"
INTERNVL_MOE = "internvl3.5-30b-a3b"
MOLMO2 = "molmo2-8b"
# the four chains' bar: card bf16 against CPU fp32, as the other decoder
# families' (Molmo2's forced-token rollout a step and a row's mean)
NEW_FAMILY_CHAIN_TOL_NATS = 5e-2


def separate_site(record, label, q, k, v, heads, wrongs) -> None:
    """A flat attention site over separate q, k, v (B, S, H*d) operands with
    no mask (InternViT-6B): the kernel against its plain version, each of
    ``wrongs`` ((name, kw override) pairs: wrong plain versions) refused by
    the tolerance, the bound (every pair of each image; q, k, v read and the
    output written once) and SDPA on (B, H, S, d) views of the same
    tensors."""
    from t2v_metrics_tpu_torch.ops import attention as A

    b, s, hd = q.shape
    d = hd // heads
    ref = A.attention_flat_reference(q, k, v, heads)
    for wrong, over in wrongs:
        caught, why = attention_agrees(A.attention_flat_reference(q, k, v, heads, **over), ref)
        log(f"[kernel] flash_attention_flat {label} negative control, plain version with "
            f"{wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
    ops = 4 * b * heads * s * s * d
    attention_site(record, label, lambda: A.flash_attention_flat(q, k, v, heads),
                   lambda: A.attention_flat_reference(q, k, v, heads), ops, 2 * 4 * b * s * hd,
                   ("F.scaled_dot_product_attention (no mask)",
                    lambda: F.scaled_dot_product_attention(qh, kh, vh)))


def new_family_kernels(randn, record, lengths_mask) -> None:
    """The kernel sites of the InternVL and Molmo2 paths that no earlier
    slice runs, each against its plain version with two wrong plain
    versions that must fail, its bound and SDPA's time: InternViT-300M's
    packed attention at d 64 over 1025 rows (the last 64-row q tile holds
    one row) for one 1024x1024 image (10 tiles) and for a 32-tile clip;
    InternViT-6B's separate q, k, v (10, 1025, 3200), 25 heads of 128;
    internvl3.5-8b's prefill (16 pairs of ~2650 rows, GQA 32/8, causal,
    kv_mask), its video prefill (2 x ~8330 rows, the longest causal
    prefill of the port) and one decode step over ~2700 slots; molmo2-4b's
    prefill and decode step at d 80 (causal GQA 32/8); RMSNorm at 3200 (the
    6B blocks and its flattened q / k norm), alone and with the add, and the
    qk-norm + rope of 32 + 8 heads of 128; LayerNorm at the projectors' 4096
    and 12800 and add + LN at the 300M blocks' 1024, eps 1e-6; rope on 32 +
    8 heads of 128 and of 80. The
    plain versions of the GQA sites run one kv head at a time."""
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    sdpa = F.scaled_dot_product_attention
    for b, what in ((10, "one 1024x1024 image's 10 tiles"), (32, "a clip's 32 tiles")):
        packed = randn(b, 1025, 3 * 1024)
        qh, kh, vh = A.packed_heads(packed, 16)
        cut = (torch.arange(1025, device="cuda") < 1025 - 64).expand(b, 1025)
        ms = library_ms(lambda: sdpa(qh, kh, vh), "F.scaled_dot_product_attention")  # noqa: B023
        ops = 4 * b * 16 * 1025 * 1025 * 64
        checked_site(record, f"InternViT-300M ({b}, 1025, 3x1024) d=64 packed, no mask, "
                     f"{what}", packed, 16, {},
                     (("the scale doubled", {"scale": 0.25}),
                      ("the last 64 keys dropped", {"kv_mask": cut})),
                     dict(flop=ops, lower=(ops, 2 * b * 1025 * 4 * 1024, "bf16"),
                          library=None if ms is None else
                          ("F.scaled_dot_product_attention (no mask)", ms)))
        del packed, qh, kh, vh
    free_cuda()
    w = randn(3200)
    q, k = (N.rms_norm_fused(randn(10, 1025, 3200), w) for _ in range(2))
    v = randn(10, 1025, 3200)
    cut = (torch.arange(1025, device="cuda") < 1025 - 64).expand(10, 1025)
    separate_site(record, "InternViT-6B q, k, v (10, 1025, 3200) d=128, 25 heads, q and k "
                  "RMS-normalized over 3200, no mask", q, k, v, 25,
                  (("scale 1/8", {"scale": 0.125}), ("the last 64 keys dropped",
                                                     {"kv_mask": cut})))
    del q, k, v
    free_cuda()

    # the decoders' prefills: internvl3.5-8b's 4 x 4 at 1024x1024 (10 tiles,
    # 2560 image rows + the conversation), its 32-tile video (8192 + the
    # conversation, 2 texts), molmo2-4b's 4 x 4 (144 image rows) at d 80
    for label, b, s, lo, hi, d in (
            ("internvl3.5-8b prefill", 16, 2688, 2630, 2680, 128),
            ("internvl3.5-8b video prefill, 32 tiles", 2, 8384, 8320, 8340, 128),
            ("molmo2-4b prefill", 16, 256, 160, 180, 80)):
        mask = lengths_mask(b, s, lo, hi)
        checked_site(record, f"{label} ({b}, {s}, 48x{d}) d={d}, GQA 32/8, causal, kv_mask "
                     f"({lo}-{hi} rows)", randn(b, s, 48 * d), 32,
                     dict(kv_heads=8, causal=True, kv_mask=mask),
                     (("no causal mask", {"causal": False}),
                      ("no kv_mask", {"kv_mask": torch.ones_like(mask)})))
        free_cuda()
    for label, b, s, d in (("internvl3.5-8b generate", 4, 2688, 128),
                           ("molmo2-4b generate", 4, 256, 80)):
        cache_attention_site(
            record, randn, f"{label} decode, q ({b}, 1, 32x{d}) over a ({b}, {s + 32}, "
            f"8x{d}) cache view of {s + DECODE_STEP + 1} slots, GQA 32/8, kv_mask",
            b, s, 32, 8, d, lengths_mask(b, s, s - 60, s - 8),
            wrongs=(("no kv_mask", {"kv_mask": None}),
                    ("the scale doubled", {"scale": 2 * d ** -0.5})))
        free_cuda()

    # norms: the 6B tower's RMSNorm at 3200 (blocks, flattened q / k), the
    # projectors' LayerNorm at 4096 (300M) and 12800 (6B), eps 1e-5, the 300M
    # blocks' add + LN at 1024, eps 1e-6
    x, r, w = randn(10 * 1025, 3200, std=3.0), randn(10 * 1025, 3200, std=3.0), randn(3200)
    rms_site(record, "InternViT-6B (10250, 3200)", x, w)
    rms_site(record, "InternViT-6B add + RMSNorm (10250, 3200)", x, w, r=r)
    del x, r
    for rows, d in ((10 * 256, 4096), (10 * 256, 12800)):
        x, w, bias = randn(rows, d, std=3.0), randn(d), randn(d)
        out, ref = N.layer_norm_fused(x, w, bias), N.layer_norm_plain(x, w, bias)
        bad = outside(out, ref, NORM_ATOL, LN_RTOL)
        record("layer_norm", f"InternVL projector ({rows}, {d})", out, ref, bad == 0,
               f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max {bf16_ulps(out, ref)} "
               "bf16 ulps", lambda: N.layer_norm_fused(x, w, bias),  # noqa: B023
               lambda: N.layer_norm_plain(x, w, bias), False,  # noqa: B023
               lower=(8 * rows * d, 4 * rows * d + 4 * d, "fp32"),
               library=("F.layer_norm", cuda_ms(
                   lambda: F.layer_norm(x, (d,), w, bias, 1e-5))),  # noqa: B023
               site=True)
    x, r, w, bias = randn(10 * 1025, 1024, std=3.0), randn(10 * 1025, 1024), randn(1024), \
        randn(1024)
    (s, out), s_ref = N.add_layer_norm_fused(x, r, w, bias, 1e-6), x + r
    ref = N.layer_norm_plain(s_ref, w, bias, 1e-6)
    bad, same = outside(out, ref, NORM_ATOL, LN_RTOL), bool(torch.equal(s, s_ref))
    record("layer_norm", "InternViT-300M add + LN (10250, 1024) eps 1e-6", out, ref,
           bad == 0 and same, f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max "
           f"{bf16_ulps(out, ref)} bf16 ulps; s bitwise x + r: {same}",
           lambda: N.add_layer_norm_fused(x, r, w, bias, 1e-6),
           lambda: N.add_layer_norm_plain(x, r, w, bias, 1e-6), False,
           lower=(9 * x.numel(), 8 * x.numel() + 4 * 1024, "fp32"),
           library=("x + r, then F.layer_norm (two calls)", cuda_ms(
               lambda: F.layer_norm(x + r, (1024,), w, bias, 1e-6))), site=True)
    del x, r, s, out, ref, s_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    pk, qs, ks = randn(16, 2688, 48 * 128, std=3.0), randn(128), randn(128)
    qk_rope_site(record, "qk-norm + rope internvl3.5-8b (16, 2688, 6144), 32+8 heads of 128 "
                 "in place", pk, qs, ks, *rope_angles(gen, 16, 2688, 128, 8192), 32, 8, 128)
    del pk
    for label, b, s, d in (("internvl3.5-8b", 16, 2688, 128), ("molmo2-4b", 16, 256, 80)):
        pk = randn(b, s, 48 * d)
        ang = (torch.randint(0, 8192, (b, s, 1), generator=gen, device="cuda").float()
               * randn(d, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        buf = pk.clone()
        out, ref = R.rope_pack(buf, cos, sin, 40, d), R.rope_pack_plain(pk, cos, sin, 40, d)
        bad = outside(out, ref, NORM_ATOL, ROPE_RTOL)
        v_same = bool(torch.equal(out[..., 40 * d:], pk[..., 40 * d:]))
        record("rope_pack", f"{label} ({b}, {s}, {48 * d}) 40 heads of {d}", out, ref,
               bad == 0 and v_same, f"{bad} outside atol {NORM_ATOL} + rtol {ROPE_RTOL}; "
               f"max {bf16_ulps(out, ref)} bf16 ulps; v lanes untouched {v_same}",
               lambda: R.rope_pack(buf, cos, sin, 40, d),  # noqa: B023
               lambda: R.rope_pack_plain(pk, cos, sin, 40, d), False,  # noqa: B023
               lower=(3 * b * s * 40 * d, 4 * b * s * 40 * d + 8 * b * s * d, "fp32"),
               site=True)
        del pk, buf, out, ref, cos, sin, ang
    free_cuda()


def new_family_chain_config(model: str):
    """``model``'s registry config at full width, cut to 2 tower layers (3
    for Molmo2's CLIP tower, of which feature layer -2 runs 2) and 2 decoder
    layers. InternVL's and Molmo2's heads are untied in the models
    themselves."""
    from t2v_metrics_tpu_torch.models.internvl import INTERNVL_MODELS
    from t2v_metrics_tpu_torch.models.molmo2 import MOLMO2_MODELS

    cfg = {**INTERNVL_MODELS, **MOLMO2_MODELS}[model]["config"]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=3 if model == MOLMO2 else 2),
        text=dataclasses.replace(cfg.text, layers=2))


def internvl_launches(cfg, tiles_calls: int, passes: int = 1) -> dict:
    """The launches of InternVL scoring, from the code: ``tiles_calls`` tower
    calls (one a distinct visual), each a flat attention a layer and, in the
    300M tower, an add + LayerNorm twice a layer (RMSNorm four times a layer
    in the 6B tower: the block norms and the flattened q / k norm), and the
    projector's LayerNorm; then ``passes`` decoder passes of a flat
    attention and rope (with the qk-norm) a layer, two RMSNorms a layer and
    the final one (and two grouped GEMMs a layer with the MoE dispatch)."""
    v, text = cfg.vision, cfg.text
    want = dict.fromkeys(KERNELS, 0)
    rms_layers = 4 * v.layers if v.norm_type == "rms" else 0
    want.update(flash_attention_flat=tiles_calls * v.layers + passes * text.layers,
                layer_norm=tiles_calls * ((2 * v.layers if v.norm_type == "layer" else 0) + 1),
                rms_norm=tiles_calls * rms_layers + passes * (2 * text.layers + 1),
                rope_pack=passes * text.layers,
                grouped_gemm=passes * 2 * text.layers if text.moe_dispatch else 0)
    return want


def molmo2_launches(cfg, tower_calls: int, passes: int = 1) -> dict:
    """The launches of Molmo2 scoring, from the code: ``tower_calls`` CLIP
    tower calls (one a group of same-shape images or a video) to feature
    layer -2 (ln_pre and two LayerNorms a block run, the last block not),
    then ``passes`` decoder passes (the prefill and each cached step) of a
    flat attention and rope (with the qk-norm) a layer, two RMSNorms a layer
    and the final one."""
    v, text = cfg.vision, cfg.text
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention_flat=tower_calls * (v.layers - 1) + passes * text.layers,
                layer_norm=tower_calls * (1 + 2 * (v.layers - 1)),
                rms_norm=passes * (2 * text.layers + 1), rope_pack=passes * text.layers)
    return want


def molmo2_generation_prompt(adapter, images, texts):
    """Molmo2's batched prompt: (embeds, positions, prompt lengths, None,
    None)."""
    embeds, lens = adapter._prompt_embeds(images, texts)
    b, s = embeds.shape[:2]
    return embeds, np.broadcast_to(np.arange(s), (b, s)).copy(), lens, None, None


def phase_new_family_chain(model: str, device: str = "cuda", n: int = 2) -> None:
    """One chain (``new_family_chain_config``), the card in bf16 with the
    kernels against the CPU in fp32 with the plain versions, on one set of
    random parameters: InternVL's log P(first answer token) of score_matrix
    within 5e-2 nats (internvl3.5-8b on a seeded 1024x1024 image, 10 tiles
    and 2560 image rows; the 6B tower of internvl3.5-38b and the MoE of
    internvl3.5-30b-a3b on a 448x448 one, one tile), with the launch counts
    of the card's call against the code's; Molmo2's greedy rollout through
    forced tokens (``generation_chain``: each row's mean and every step
    within 5e-2) on 2 seeded 1024x1024 images."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models import internvl, molmo2
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = new_family_chain_config(model)
    init, cls = ((molmo2.init_molmo2, molmo2.Molmo2Model) if model == MOLMO2
                 else (internvl.init_internvl, internvl.InternVLModel))
    card = init(cfg, SEED + 8, device, torch.bfloat16)
    host = cls(cfg, "cpu", torch.float32)
    with torch.no_grad():
        dst = host.state_dict()
        for name, t in card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    kw = dict(config=cfg, tokenizer=t2v.SimpleT5Tokenizer(cfg.text.vocab_size))
    scorers = [t2v.VQAScore(model, params=p, device=d, **kw)
               for p, d in ((card, device), (host, "cpu"))]
    tag = f"[{model} chain]"
    widths = f"{cfg.vision.layers} tower + {cfg.text.layers} decoder layers"
    texts = seeded_texts(n, 172)
    if model == MOLMO2:
        images = seeded_images(2, 171, 1024, 1024)
        pairs = [images[i % 2] for i in range(n)]
        log(f"{tag} full widths, {widths} (feature layer -2 runs {cfg.vision.layers - 1}), "
            f"{n} prompts of 1024x1024 images")
        generation_chain(tag, scorers, lambda a, k: molmo2_generation_prompt(a, pairs, texts),
                         NEW_FAMILY_CHAIN_TOL_NATS, NEW_FAMILY_CHAIN_TOL_NATS)
        del card, host, scorers
        return
    side = 1024 if model == INTERNVL else 448
    images = seeded_images(1, 171, side, side)
    reset_launch_counts()
    t0 = time.perf_counter()
    on_card = np.log(scorers[0].model.score_matrix(images, texts))
    t1 = time.perf_counter()
    counts = launch_counts()
    on_cpu = np.log(scorers[1].model.score_matrix(images, texts))
    t2 = time.perf_counter()
    diff = float(np.abs(on_card - on_cpu).max())
    want = internvl_launches(cfg, 1)
    log(f"{tag} full widths, {widths}, 1 x {n} on a {side}x{side} image "
        f"({scorers[0].model._tiles(images[0], 32).shape[0]} tiles): card bf16 "
        f"{t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; card launches {json.dumps(counts)}")
    log(f"{tag} log P(first answer token) card {on_card.ravel().round(4).tolist()}")
    log(f"{tag} log P(first answer token) cpu  {on_cpu.ravel().round(4).tolist()}")
    log(f"{tag} max |card - cpu| {diff:.4e} nats (limit {NEW_FAMILY_CHAIN_TOL_NATS}); "
        f"spread over pairs {float(np.ptp(on_cpu)):.4e} nats")
    check(np.isfinite(on_card).all() and on_card.shape == (1, n),
          f"{tag} card scores not finite or wrong shape")
    check(counts == want, f"{tag} launches {counts} != {want}")
    check(diff <= NEW_FAMILY_CHAIN_TOL_NATS, f"{tag} card and CPU differ by {diff} nats")
    del card, host, scorers


def phase_new_family_slice(model: str, device: str = "cuda", side: int = 1024,
                           profile: bool = False) -> list:
    """``VQAScore(model, init="random")`` at full width and depth
    (internvl3.5-8b, molmo2-8b): 4 x 4 on seeded side x side images with
    the launch counts of the first call against the code's, scores in [0,
    1] and repeatable; ``batch_forward`` of 8 x (1 seeded 300x380 image, 4
    texts) in one chunk equal to the pairwise forward of the same pairs
    (13 tiles an image for InternVL); one seeded 5 s 30 fps 480x640 clip as
    a ``DecodedVideo`` with 2 texts (32 tiles for InternVL, 8 frames for
    Molmo2), its launch counts against the code's; pairs/s of each, peak
    memory at load and while scoring; ``generate`` of 8 tokens over the 4
    images (one batched decode). Returns the launch counts of each path."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"[{model} slice]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    torch.cuda.synchronize()
    cfg = scorer.model.config
    log(f"{tag} random init on {device}: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters, load peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    def first_call(media, texts_, label, want):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = scorer(images=media, texts=texts_)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = launch_counts()
        log(f"{tag} first forward ({label}): {t_first:.3f} s; launches "
            f"{json.dumps(counts)}; from the code {json.dumps(want)}")
        check(scores.shape == (len(media), len(texts_)), f"{tag} shape {scores.shape}")
        check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
              f"{tag} scores not finite in [0, 1]")
        check(counts == want, f"{tag} launch counts {counts} != {want}")
        check(np.array_equal(scores, scorer(images=media, texts=texts_)),
              f"{tag} second call differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer(images=media, texts=texts_)
        torch.cuda.synchronize()
        log(f"{tag} log scores: {np.log(scores).round(4).tolist()}; pairs/s after warm-up "
            f"{scores.size / (time.perf_counter() - t0):.2f}")
        return counts

    images, texts = seeded_images(4, 181, side, side), seeded_texts(4, 182)
    if model == MOLMO2:
        want = molmo2_launches(cfg, 1)
    else:
        want = internvl_launches(cfg, 4)
    paths = [first_call(images, texts, f"4 images {side}x{side} x 4 texts", want)]

    pool, pool_texts = seeded_images(8, 183), seeded_texts(32, 184)
    data = [{"images": [pool[i]], "texts": pool_texts[4 * i:4 * i + 4]} for i in range(8)]
    rows = scorer.batch_forward(data, batch_size=8)
    media, texts_ = scorer._flatten_pairs(data, "images", 8)
    check(rows.shape == (8, 1, 4)
          and np.array_equal(rows.ravel(), scorer.model.forward(media, texts_)),
          f"{tag} batch_forward rows differ from the pairwise forward of the same pairs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.batch_forward(data, batch_size=8)
    torch.cuda.synchronize()
    log(f"{tag} batch_forward 8 x (1 300x380 image, 4 texts) rows equal the pairwise forward; "
        f"log rows spread {float(np.ptp(np.log(rows))):.4e} nats; pairs/s after warm-up "
        f"{32 / (time.perf_counter() - t0):.2f}")
    log(f"{tag} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated while "
        f"scoring images; card {card_line()}")
    if profile:
        phase_profile(lambda: scorer.batch_forward(data, batch_size=8),
                      f"{model} batch_forward")

    torch.cuda.reset_peak_memory_stats()
    clip = seeded_clip(185)
    want = molmo2_launches(cfg, 1) if model == MOLMO2 else internvl_launches(cfg, 1)
    paths.append(first_call([clip], seeded_texts(2, 186), "one 150-frame 480x640 clip at "
                            "30 fps x 2 texts: "
                            + ("8 frames" if model == MOLMO2 else "32 tiles"), want))
    log(f"{tag} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated while "
        f"scoring video; card {card_line()}")
    paths.append(phase_generation(scorer, f"[generate] {model}", images, texts, 8,
                                  profile=profile))
    del scorer
    return paths


# ---------------------------------------------------------------------------
# Qwen3-Omni (the thinker's scoring path): kernel sites and the exact
# resize (phase 2), the 2+2+2-layer chain (phase 3) and the slice (phase 4)
# ---------------------------------------------------------------------------

OMNI = "qwen3-omni-30b-a3b"
# Omni chain: 30b-a3b widths, 2 audio + 2 vision + 2 thinker layers of 128
# experts, bf16 on the card against fp32 on the CPU: the Qwen3 chain's
# roundings and the audio tower's; limit 5e-2 as for Qwen3, on the pairs
# whose scored row routes to the same experts on both sides
# (phase_omni_chain)
OMNI_CHAIN_TOL_NATS = 5e-2
# the device log-mel of a 300 s clip (float64 on the card and the CPU)
MEL_TOL = 5e-4


def write_seeded_wav(path: str, seconds: float, seed: int, sr: int = 16000) -> str:
    """A seeded 16-bit PCM mono .wav (stdlib ``wave``): two tones and noise."""
    import wave

    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0, f1 = rng.uniform(110.0, 880.0, 2)
    x = (0.2 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * f1 * t)
         + rng.normal(0.0, 0.02, t.size))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


def audio_segments(seconds_list, cfg) -> tuple[np.ndarray, np.ndarray]:
    """The audio tower's segment ids over the clips of one call, as
    ``qwen3omni_audio.encode_audios`` lays them out (each clip's chunks in
    turn, its windows under ids of their own, invalid slots under -1), and
    the same with every window boundary moved one row later (a wrong plain
    version). Clips of ``seconds`` at 16 kHz give 100 mel frames a second."""
    from t2v_metrics_tpu_torch.models.qwen3omni_audio import audio_geometry

    segs, shifted, win = [], [], 0
    for sec in seconds_list:
        _, valid, seg, _ = audio_geometry(int(round(sec * 100)), cfg)
        window = cfg.chunk_tokens * (cfg.n_window_infer // cfg.chunk_frames)
        rank = np.cumsum(valid.reshape(-1)) - 1
        segs.append(np.where(seg >= 0, seg + win, -1))
        shifted.append(np.where(seg >= 0, (rank + 1) // window + win, -1))
        win += int(seg.max()) + 2
    return np.concatenate(segs).astype(np.int32), np.concatenate(shifted).astype(np.int32)


def omni_kernels(randn, record) -> None:
    """The sites of the Qwen3-Omni audio tower (d_model 1280, 20 heads of 64),
    each against its plain version with its bound and library time: the
    flat kernel with segment ids over a 300 s clip (the JAX package's
    decode cap: 150 chunks of 25 rows, windows of 50 rows) and over four
    clips of 10, 7.3, 3.1 and 0.5 s in one call (partial last chunks: rows
    under -1), each with two wrong plain versions that must fail (segment
    ids ignored, every window moved one row); LayerNorm and add + LN at the
    300 s clip's rows, eps 1e-5. The thinker's RMSNorm, rope and grouped GEMM run at
    qwen3-vl-30b-a3b's sites above. Then the device log-mel of 300 s
    (float64) against the CPU's, with its time."""
    from t2v_metrics_tpu_torch.models.qwen3omni import resolve_config
    from t2v_metrics_tpu_torch.models.qwen3omni_audio import log_mel_device
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import norms as N

    cfg = resolve_config(OMNI).audio
    heads, d = cfg.heads, cfg.d_model // cfg.heads
    sdpa = F.scaled_dot_product_attention
    dev = randn(1).device
    for label, seconds in (("a 300 s clip", (300.0,)),
                           ("4 clips of 10, 7.3, 3.1 and 0.5 s in one call",
                            (10.0, 7.3, 3.1, 0.5))):
        seg_np, shifted_np = audio_segments(seconds, cfg)
        s = len(seg_np)
        seg = torch.from_numpy(seg_np).to(dev)[None]
        shifted = torch.from_numpy(shifted_np).to(dev)[None]
        packed = randn(1, s, 3 * cfg.d_model)
        q, k, v, _ = A._split_packed(packed, heads, None)
        ref = A.attention_flat_reference(q, k, v, heads, segment_ids=seg)
        for wrong, over in (("segment ids ignored", {"segment_ids": None}),
                            ("every window moved one row", {"segment_ids": shifted})):
            caught, why = attention_agrees(A.attention_flat_reference(q, k, v, heads, **over),
                                           ref)
            log(f"[kernel] flash_attention_flat audio tower, {label}, negative control, "
                f"plain version with {wrong}: {why}")
            check(not caught, f"the attention tolerance passes a plain version with {wrong}")
        same = seg[:, :, None] == seg[:, None, :]
        qh, kh, vh = A.packed_heads(packed, heads)
        attention_site(
            record, f"Qwen3-Omni audio tower, {label}: (1, {s}, 3x1280) d=64, segment ids "
            f"({int((seg_np < 0).sum())} rows under -1)",
            lambda: A.flash_attention_flat_packed(packed, heads, segment_ids=seg),  # noqa: B023
            lambda: A.attention_flat_reference(q, k, v, heads, segment_ids=seg),  # noqa: B023
            4 * d * heads * int(same.sum()), 2 * s * 4 * cfg.d_model + 4 * s,
            ("F.scaled_dot_product_attention (bool mask)",
             lambda: sdpa(qh, kh, vh, attn_mask=same[:, None])))  # noqa: B023
        del packed, q, k, v, ref, same, qh, kh, vh
        free_cuda()

    rows, dm = 3750, cfg.d_model
    x, r, w, b = randn(rows, dm, std=3.0), randn(rows, dm, std=3.0), randn(dm), randn(dm)
    out, ref = N.layer_norm_fused(x, w, b), N.layer_norm_plain(x, w, b)
    bad = outside(out, ref, NORM_ATOL, LN_RTOL)
    record("layer_norm", f"Qwen3-Omni audio tower ({rows}, {dm}) eps 1e-5", out, ref, bad == 0,
           f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max {bf16_ulps(out, ref)} "
           "bf16 ulps", lambda: N.layer_norm_fused(x, w, b),
           lambda: N.layer_norm_plain(x, w, b), False,
           lower=(8 * rows * dm, 4 * rows * dm + 4 * dm, "fp32"),
           library=("F.layer_norm", cuda_ms(lambda: F.layer_norm(x, (dm,), w, b, 1e-5))),
           site=True)
    (s_, out), s_ref = N.add_layer_norm_fused(x, r, w, b), x + r
    ref = N.layer_norm_plain(s_ref, w, b)
    bad, same = outside(out, ref, NORM_ATOL, LN_RTOL), bool(torch.equal(s_, s_ref))
    record("layer_norm", f"Qwen3-Omni audio tower add + LN ({rows}, {dm}) eps 1e-5", out, ref,
           bad == 0 and same, f"{bad} outside atol {NORM_ATOL} + rtol {LN_RTOL}; max "
           f"{bf16_ulps(out, ref)} bf16 ulps; s bitwise x + r: {same}",
           lambda: N.add_layer_norm_fused(x, r, w, b),
           lambda: N.add_layer_norm_plain(x, r, w, b), False,
           lower=(9 * rows * dm, 8 * rows * dm + 4 * dm, "fp32"),
           library=("x + r, then F.layer_norm (two calls)", cuda_ms(
               lambda: F.layer_norm(x + r, (dm,), w, b, 1e-5))), site=True)
    del x, r, s_, out, ref, s_ref

    audio = (np.random.default_rng(SEED + 9).standard_normal(16000 * 300) * 0.1
             ).astype(np.float32)
    nm = cfg.num_mel_bins
    mel = log_mel_device(audio, n_mels=nm, device=dev)
    t0 = time.perf_counter()
    want = log_mel_device(audio, n_mels=nm)
    cpu_s = time.perf_counter() - t0
    err = float((mel.cpu() - want).abs().max())
    ms = cuda_ms(lambda: log_mel_device(audio, n_mels=nm, device=dev))
    log(f"[kernel] log-mel (no TPU kernel: float64 matmuls) of 300 s: {tuple(mel.shape)}, "
        f"card against CPU max_abs_err {err:.3e} (limit {MEL_TOL}); card {ms:.4f} ms with "
        f"the host pad and copy, CPU {cpu_s * 1e3:.1f} ms")
    check(mel.shape == (nm, 30000) and err <= MEL_TOL,
          f"log-mel card vs CPU {err}")


# the Pillow-resize sites of the port: (label, batch, source, output, pad)
RESIZE_SITES = (("Qwen3-VL / Qwen3-Omni images (factor 32)", 4, (1024, 1024), (992, 992), False),
                ("Qwen2.5-VL images (factor 28)", 4, (1024, 1024), (980, 980), False),
                ("LLaVA / CLIP-FlanT5 over 384 px, padded", 4, (1024, 768), (336, 336), True),
                ("Gemma 3 / Gemma 4 (SigLIP 896)", 4, (1024, 1024), (896, 896), False),
                ("PaliGemma-448", 4, (1024, 1024), (448, 448), False),
                ("InstructBLIP (224)", 4, (1024, 1024), (224, 224), False),
                ("ITMScore blip2-itm (364)", 4, (1024, 1024), (364, 364), False),
                ("Qwen3-VL / Qwen3-Omni video, 40 frames of 480x640 (360x420 cap)", 40,
                 (480, 640), (320, 448), False))


def resize_sites(dev: str = "cuda") -> None:
    """The exact resize (Pillow's fixed-point uint8 bicubic, summed in
    float64) at each site's shape on the card: bitwise equal to the CPU's
    (which the CPU tests hold to Pillow's), and its CUDA-event time."""
    from t2v_metrics_tpu_torch.engine.scoring import _pillow_resize
    from t2v_metrics_tpu_torch.ops.image import resize_uint8_pillow_flat

    rng = np.random.default_rng(SEED + 11)
    for label, n, (h, w), (oh, ow), pad in RESIZE_SITES:
        host = torch.from_numpy(rng.integers(0, 256, (n, h, w * 3), dtype=np.uint8))
        if pad:
            def fn(x):
                return _pillow_resize(x, oh, pad_square=True)
        else:
            def fn(x):
                return resize_uint8_pillow_flat(x, oh, ow, 3)
        on_dev = host.to(dev)
        got, want = fn(on_dev), fn(host)
        same = bool(torch.equal(got.cpu(), want))
        ms = cuda_ms(lambda: fn(on_dev))  # noqa: B023
        log(f"[resize] {label}: {n} x {h}x{w} -> {oh}x{ow}{' (padded square first)' if pad else ''}"
            f": card {ms:.4f} ms ({ms / n:.4f} ms an image); bitwise the CPU's: {same}")
        check(same, f"resize {label}: the card's differs from the CPU's")
        del host, on_dev, got, want
    free_cuda()


def omni_chain_config(layers: int = 2):
    """qwen3-omni-30b-a3b widths cut to ``layers`` audio layers, ``layers``
    vision layers (both tapped by a deepstack merger) and ``layers`` thinker
    layers of 128 experts."""
    from t2v_metrics_tpu_torch.models.qwen3omni import resolve_config

    cfg = resolve_config(OMNI)
    return dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, layers=layers),
        vision=dataclasses.replace(cfg.vision, depth=layers,
                                   deepstack_indexes=tuple(range(layers))),
        text=dataclasses.replace(cfg.text, layers=layers))


def omni_launches(cfg, audio_calls: int, vision_calls: int) -> dict:
    """The launches of one scoring call from the code: the audio tower (one
    call for the call's distinct clips: attention once a layer, LayerNorm
    twice a layer and ln_post), the vision tower per same-shape group (as
    Qwen3-VL's) and one thinker prefill (attention and rope with the
    qk-norm once a layer, RMSNorm twice a layer and the final norm, the
    grouped GEMM twice a layer)."""
    a, v, text = cfg.audio, cfg.vision, cfg.text
    return {"flash_attention_flat": audio_calls * a.layers + vision_calls * v.depth
            + text.layers, "flash_attention": 0,
            "layer_norm": audio_calls * (2 * a.layers + 1)
            + vision_calls * (2 * v.depth + 1 + len(v.deepstack_indexes)),
            "rms_norm": 2 * text.layers + 1, "rope_pack": vision_calls * v.depth + text.layers,
            "grouped_gemm": 2 * text.layers, "quant_matmul": 0, "quantize_rows": 0}


def scored_routing(scorer, **kw) -> tuple[np.ndarray, list]:
    """Log scores of one call, and each pair's top-k expert sets, layer by
    layer, at the row whose logits score the first answer token (the router
    of each MoE layer recomputed on the layer's input rows)."""
    from t2v_metrics_tpu_torch.models import decoder as tdec
    from t2v_metrics_tpu_torch.ops import quant as Q

    seen = {"pos": None, "sets": []}
    forward, mlp = tdec.forward, tdec._mlp

    def spy_forward(params, cfg, embeds, *a, logit_positions=None, **k):
        seen["pos"] = logit_positions[:, 0].cpu()
        return forward(params, cfg, embeds, *a, logit_positions=logit_positions, **k)

    def spy_mlp(p, cfg, x):
        if p.moe is not None:
            logits = Q.mm(x.reshape(-1, x.shape[-1]), p.moe.router).float()
            top = torch.topk(torch.softmax(logits, -1), cfg.experts_per_tok, -1).indices
            seen["sets"].append(top.reshape(*x.shape[:2], -1).cpu())
        return mlp(p, cfg, x)

    tdec.forward, tdec._mlp = spy_forward, spy_mlp
    try:
        scores = np.log(scorer(**kw))
    finally:
        tdec.forward, tdec._mlp = forward, mlp
    rows = torch.arange(len(seen["pos"]))
    return scores, [[sorted(layer[b, seen["pos"][b]].tolist()) for layer in seen["sets"]]
                    for b in rows]


def phase_omni_chain(cfg, device: str = "cuda", m: int = 2, n: int = 2,
                     side: int = 1024) -> None:
    """The 2+2+2-layer Qwen3-Omni chain at full width: card bf16 against CPU
    fp32 on one set of parameters, for image + audio pairs (1024x1024
    images, 7.3 s and 3.1 s clips: partial last chunks), audio-only pairs
    and image-only pairs; the launch counts of each card call against the
    code's. A pair whose scored row routes to the same 8 experts in every
    layer on both sides is held to OMNI_CHAIN_TOL_NATS; where bf16 moves an
    expert in or out of the top 8 there (a near tie of the router's 8th and
    9th logits: one expert's share of that row's MoE output changes), the
    pair is one MoE step apart, held to QWEN3_STEP_TOL_NATS as the Qwen3
    decode steps are. Each call must hold at least one pair of the first
    kind."""
    import tempfile

    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.qwen3omni import Qwen3OmniModel, init_qwen3omni
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    card = init_qwen3omni(cfg, SEED + 1, device, torch.bfloat16)
    host = Qwen3OmniModel(cfg, "cpu", torch.float32)
    with torch.no_grad():    # one tensor at a time: no second host copy
        dst = host.state_dict()
        for name, t in card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    tok = t2v.SimpleT5Tokenizer(cfg.text.vocab_size)
    scorers = [t2v.VQAScore(OMNI, params=p, config=cfg, tokenizer=tok, device=d)
               for p, d in ((card, device), (host, "cpu"))]
    images, texts = seeded_images(m, 191, side, side), seeded_texts(n, 192)
    tag = "[omni chain]"
    with tempfile.TemporaryDirectory() as tmp:
        wavs = [write_seeded_wav(os.path.join(tmp, f"{i}.wav"), sec, 193 + i)
                for i, sec in enumerate((7.3, 3.1)[:m])]
        for what, kw, want in (
                ("image + audio", dict(images=images, audio_paths=wavs),
                 omni_launches(cfg, 1, 1)),
                ("audio only", dict(images=[None] * m, audio_paths=wavs),
                 omni_launches(cfg, 1, 0)),
                ("image only", dict(images=images), omni_launches(cfg, 0, 1))):
            reset_launch_counts()
            t0 = time.perf_counter()
            on_card = np.log(scorers[0](texts=texts, **kw))
            t1 = time.perf_counter()
            counts = launch_counts()
            on_cpu, cpu_sets = scored_routing(scorers[1], texts=texts, **kw)
            t2 = time.perf_counter()
            card_again, card_sets = scored_routing(scorers[0], texts=texts, **kw)
            check(np.array_equal(card_again, on_card), f"{tag} {what}: card scores differ "
                  "between two calls")
            gaps = np.abs(on_card - on_cpu).ravel()
            same = np.array([a == b for a, b in zip(card_sets, cpu_sets)])
            diff = float(gaps[same].max()) if same.any() else float("nan")
            log(f"{tag} 30b-a3b widths, {cfg.audio.layers} audio + {cfg.vision.depth} vision "
                f"+ {cfg.text.layers} thinker layers of {cfg.text.num_experts} experts, "
                f"{what}, M={m} N={n}: card bf16 {t1 - t0:.2f} s, cpu fp32 {t2 - t1:.2f} s; "
                f"card launches {json.dumps(counts)}")
            moved = [(j, sorted(set(a) ^ set(b)))
                     for j, (ca, cb) in enumerate(zip(card_sets, cpu_sets))
                     for a, b in zip(ca, cb) if a != b]
            log(f"{tag} {what}: mean answer log-probs card {on_card.ravel().round(4).tolist()}"
                f", cpu {on_cpu.ravel().round(4).tolist()}; |card - cpu| "
                f"{gaps.round(5).tolist()}; max over the {int(same.sum())} pairs routed alike "
                f"{diff:.4e} nats (limit {OMNI_CHAIN_TOL_NATS}); experts moved at the scored "
                f"row (pair, experts): {moved}; spread over pairs {float(np.ptp(on_cpu)):.4e}")
            check(np.isfinite(on_card).all() and on_card.shape == (m, n),
                  f"{tag} {what}: card scores not finite or wrong shape")
            check(counts == want, f"{tag} {what}: launch counts {counts} != {want}")
            check(same.any() and diff <= OMNI_CHAIN_TOL_NATS,
                  f"{tag} {what}: pairs routed alike differ by {diff} nats")
            check(float(gaps.max()) <= QWEN3_STEP_TOL_NATS,
                  f"{tag} {what}: a pair routed apart differs by {float(gaps.max())} nats")


def phase_omni_slice(model: str = OMNI, device: str = "cuda", side: int = 1024,
                     profile: bool = False) -> list:
    """``VQAScore("qwen3-omni-30b-a3b", init="random")``, the whole thinker
    (48 MoE layers, the 32-layer audio tower, the 27-layer vision tower) in
    bf16 from a seed: 4 x 4 on side x side images, each with a seeded 10 s
    .wav; 8 x (1, 4) audio-only with seeded 30 s clips (one audio tower call
    over 8 clips); one seeded 5 s 30 fps 480x640 clip as a ``DecodedVideo``
    x 2 texts. Each: the launch counts of the first call against the code's,
    scores in [0, 1] and repeatable, pairs/s after warm-up; peak memory at
    load and while scoring; with ``profile`` the device time of the image +
    audio and the audio-only calls by kernel family and the busy share.
    Returns the launch counts of each path."""
    import tempfile

    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"[{model} slice]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device)
    torch.cuda.synchronize()
    cfg = scorer.model.config
    log(f"{tag} random init on {device}: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters, load peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    def first_call(label, want, **kw):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = scorer(**kw)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = launch_counts()
        log(f"{tag} first forward ({label}): {t_first:.3f} s; launches "
            f"{json.dumps(counts)}; from the code {json.dumps(want)}")
        shape = (len(kw["images"]), len(kw["texts"]))
        check(scores.shape == shape, f"{tag} shape {scores.shape}")
        check(np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all(),
              f"{tag} scores not finite in [0, 1]")
        check(counts == want, f"{tag} launch counts {counts} != {want}")
        check(np.array_equal(scores, scorer(**kw)), f"{tag} second call differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer(**kw)
        torch.cuda.synchronize()
        log(f"{tag} log scores: {np.log(scores).round(4).tolist()}; pairs/s after warm-up "
            f"{scores.size / (time.perf_counter() - t0):.2f}")
        log(f"{tag} peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated "
            f"scoring {label}; card {card_line()}")
        torch.cuda.reset_peak_memory_stats()
        return counts

    paths = []
    with tempfile.TemporaryDirectory() as tmp:
        wavs10 = [write_seeded_wav(os.path.join(tmp, f"a{i}.wav"), 10.0, 201 + i)
                  for i in range(4)]
        wavs30 = [write_seeded_wav(os.path.join(tmp, f"b{i}.wav"), 30.0, 211 + i)
                  for i in range(8)]
        images, texts = seeded_images(4, 221, side, side), seeded_texts(4, 222)
        kw_ia = dict(images=images, texts=texts, audio_paths=wavs10)
        paths.append(first_call(f"4 images {side}x{side}, each with a 10 s clip, x 4 texts",
                                omni_launches(cfg, 1, 1), **kw_ia))
        kw_a = dict(images=[None] * 8, texts=seeded_texts(4, 223), audio_paths=wavs30)
        paths.append(first_call("8 x (one 30 s clip, 4 texts), audio only",
                                omni_launches(cfg, 1, 0), **kw_a))
        if profile:
            phase_profile(lambda: scorer(**kw_ia), f"{model} 4 x 4 image + audio")
            phase_profile(lambda: scorer(**kw_a), f"{model} 8 x 4 audio only")
    paths.append(first_call("one 150-frame 480x640 clip at 30 fps (40 frames at fps 8) "
                            "x 2 texts", omni_launches(cfg, 0, 1),
                            images=[seeded_clip(224)], texts=seeded_texts(2, 225)))
    del scorer
    return paths


# ---------------------------------------------------------------------------
# Qwen3-Omni's talker (speech output): kernel sites (phase 2), the chain
# (phase 3) and the slice through generate(return_audio=True) (phase 4)
# ---------------------------------------------------------------------------

# Talker chain, card bf16 against CPU fp32 through the CPU's greedy codec
# frames: a talker step is an MoE step (a router near tie moves an expert:
# the MoE step bar), a predictor step a dense one (the decoder chains' bar).
TALKER_STEP_TOL_NATS = QWEN3_STEP_TOL_NATS
PREDICTOR_STEP_TOL_NATS = 5e-2
# Code2Wav's waveform, card bf16 against CPU fp32 on one seeded code matrix:
# rms(card - cpu) <= WAV_TOL_RMS x rms(cpu). The transformer's bf16 roundings
# (~0.4% a value) pass through 2 + 12 residual convolutions and the
# SnakeBeta sines; predicted 1-2% of rms, bar 5%.
WAV_TOL_RMS = 5e-2
TALKER_FRAMES = 8          # frames of the chain's forced rollout
C2W_CHAIN_FRAMES = 50      # frames of the chain's Code2Wav comparison
# rows of the talker's prefill at the slice's pair: a 1024x1024 image (1024
# rows + 2 markers), a 10 s clip (130 + 2) and the chat text, then the 9
# assistant rows
TALKER_PROMPT = 1184


def chat_tokenizer(vocab_size: int):
    """The port's SimpleT5Tokenizer with <|im_start|> and <|im_end|> kept apart
    from the words beside them (the JAX suite's ``_ChatT5Tokenizer``), so that
    ``build_talker_inputs`` finds the chat turns; <|im_start|>, <|im_end|>,
    system, user and assistant take ids 3-7."""
    import re

    from t2v_metrics_tpu_torch.tokenization import SimpleT5Tokenizer

    class ChatT5Tokenizer(SimpleT5Tokenizer):
        MARKS = ("<|im_start|>", "<|im_end|>")

        def __init__(self, vocab: int):
            super().__init__(vocab)
            for word in (*self.MARKS, "system", "user", "assistant"):
                self._id(word)

        def __call__(self, text: str, add_special_tokens: bool = True):
            ids = []
            for part in re.split(r"(<\|im_start\|>|<\|im_end\|>)", text):
                ids += ([self._id(part)] if part in self.MARKS
                        else [self._id(w) for w in part.split()])
            if add_special_tokens:
                ids.append(self.eos_token_id)
            return self._Enc(ids)

    return ChatT5Tokenizer(vocab_size)


def talker_run_config(tok=None, text_layers=None, pred_layers=None, c2w_layers=None):
    """``resolve_talker_config()`` made self-consistent for a random run (these
    are values of this run, not of a checkpoint): 16 code groups for Code2Wav's
    16 quantizers; Code2Wav's upsample rates HF's (8, 5, 4, 3), 1920 samples a
    frame, 12.5 frames/s at 24 kHz; the codec special ids 4196-4205, past the
    3072-row codec table, each moved down by 2048 into the suppressed top band
    [2048, 3072); with ``tok`` the chat ids of that tokenizer; depth cut where
    given."""
    from t2v_metrics_tpu_torch.models.qwen3omni import resolve_talker_config

    cfg = resolve_talker_config()
    over = {k: getattr(cfg, k) - 2048 for k in (
        "codec_eos_token_id", "codec_nothink_id", "codec_think_bos_id",
        "codec_think_eos_id", "codec_pad_id", "codec_bos_id")}
    over["speaker_id"] = tuple((name, i - 2048) for name, i in cfg.speaker_id)
    if tok is not None:
        ids = {w: tok.encode(w, add_special_tokens=False)[0]
               for w in ("<|im_start|>", "system", "user", "assistant")}
        over.update(im_start_token_id=ids["<|im_start|>"], system_token_id=ids["system"],
                    user_token_id=ids["user"], assistant_token_id=ids["assistant"])
    c2w = dataclasses.replace(cfg.code2wav, upsample_rates=(8, 5, 4, 3),
                              num_hidden_layers=c2w_layers or cfg.code2wav.num_hidden_layers)
    return dataclasses.replace(
        cfg, num_code_groups=c2w.num_quantizers, code2wav=c2w,
        text=dataclasses.replace(cfg.text, layers=text_layers or cfg.text.layers),
        predictor=dataclasses.replace(cfg.predictor,
                                      layers=pred_layers or cfg.predictor.layers), **over)


def kernel_counts(**counts) -> dict:
    """A launch count over every kernel of the table (the others 0)."""
    return {name: counts.get(name, 0) for name in KERNELS}


def add_launches(*dicts) -> dict:
    return {name: sum(d.get(name, 0) for d in dicts) for name in KERNELS}


def decoder_launches(cfg, passes: int = 1) -> dict:
    """Launches of ``passes`` forwards (a prefill or a step) of a decoder:
    attention and rope (with the qk-norm where the config has one) once a
    layer, RMSNorm twice a layer (the residual adds folded in) and the final
    norm, the grouped GEMM twice a MoE layer on the dispatch."""
    n = cfg.layers
    gmm = 2 * n if cfg.num_experts and cfg.moe_dispatch else 0
    return kernel_counts(flash_attention_flat=n * passes, rope_pack=n * passes,
                         rms_norm=(2 * n + 1) * passes, grouped_gemm=gmm * passes)


def c2w_launches(cfg, chunks: int = 1) -> dict:
    """Launches of ``chunks`` Code2Wav decodes: the transformer's attention
    and rope once a layer, RMSNorm twice a layer and the final norm, and the
    ConvNeXt LayerNorm once an upsampling stage."""
    n = cfg.num_hidden_layers
    return kernel_counts(flash_attention_flat=n * chunks, rope_pack=n * chunks,
                    rms_norm=(2 * n + 1) * chunks,
                    layer_norm=len(cfg.upsampling_ratios) * chunks)


def focused_cache_site(record, randn, label, sk: int, heads: int, kvh: int, d: int) -> None:
    """The flat kernel at one decode step of one sequence: q (1, 1, H*d), the
    q lanes of a packed row, over k / v views of (1, sk, KvH*d) caches whose
    slots are all valid (the talker's and the code predictor's caches hold
    no pad slot). Slot 0's key is made the focus of the first q head of
    each kv head (3 x its q), so that the two wrong plain versions, slot 0
    masked and a window one slot short of the view, move those heads and
    must fail. Bound: the k / v rows, q and the output once; SDPA with
    enable_gqa beside it."""
    from t2v_metrics_tpu_torch.ops import attention as A

    rep = heads // kvh
    q = randn(1, 1, (heads + 2 * kvh) * d)[..., :heads * d]
    k, v = randn(1, sk, kvh * d), randn(1, sk, kvh * d)
    for g in range(kvh):
        k[:, 0, g * d:(g + 1) * d] = 3 * q[:, 0, g * rep * d:g * rep * d + d]
    mask = torch.ones((1, sk), dtype=torch.bool, device=q.device)
    kw = dict(kv_heads=kvh, causal=True, kv_mask=mask)
    fn = lambda: A.flash_attention_flat(q, k, v, heads, **kw)  # noqa: E731
    plain_fn = lambda: A.attention_flat_reference(q, k, v, heads, **kw)  # noqa: E731
    out, ref = fn(), plain_fn()
    torch.cuda.synchronize()
    ok, detail = attention_agrees(out, ref)
    first_off = mask.clone()
    first_off[:, 0] = False
    for wrong, over in (("slot 0 masked", {"kv_mask": first_off}),
                        (f"a window of {sk - 1}", {"local_window": sk - 1})):
        caught, why = attention_agrees(
            A.attention_flat_reference(q, k, v, heads, **{**kw, **over}), ref)
        log(f"[kernel] flash_attention_flat {label} negative control, plain version with "
            f"{wrong}: {why}")
        check(not caught, f"the attention tolerance passes a plain version with {wrong}")
    qh = q.view(1, 1, heads, d).transpose(1, 2)
    kh, vh = (t.view(1, sk, kvh, d).transpose(1, 2) for t in (k, v))
    attention_site(record, label, fn, plain_fn, 4 * d * heads * sk,
                   2 * (2 * sk * kvh * d + 2 * heads * d) + sk,
                   ("F.scaled_dot_product_attention (enable_gqa)",
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)),
                   checked=(out, ref, ok, detail))
    log_host("flash_attention_flat", label, fn)


def norm_site(record, name, label, out, ref, fn, plain_fn, lower, library=None, ulp=True):
    tol = LN_RTOL if name == "layer_norm" else (ROPE_RTOL if name == "rope_pack" else RMS_RTOL)
    bad = outside(out, ref, NORM_ATOL, tol)
    record(name, label, out, ref, bad == 0,
           f"{bad} outside atol {NORM_ATOL} + rtol {tol}; max {bf16_ulps(out, ref)} bf16 ulps",
           fn, plain_fn, False, lower=lower, library=library, site=True)


def talker_kernels(randn, record) -> None:
    """The kernel sites of Qwen3-Omni's speech path at HF's published talker
    widths (``talker_run_config``), each against its plain version with its
    bound and library time: the flat kernel at the talker's prefill
    (TALKER_PROMPT rows, 16 q heads / 2 kv heads of 64, causal; wrong plain
    versions: no causal mask, a window of 512), its decode step over the
    prompt and 16 generated slots, the code predictor's last step (16 q / 8
    kv heads of 128 over 16 slots; both steps with ``focused_cache_site``'s
    wrong versions) and the Code2Wav transformer over a 325-row chunk (300
    frames + 25 of context; 16 heads of 64, causal, window 72; wrong
    versions: window 71, no window); the grouped GEMM at the talker's gate_up
    (rows, 1024) x (128, 1024, 768) and down (rows, 384) x (128, 384, 1024)
    over a seeded top-8 routing of the prefill's rows and of one decode
    step's 8 routed rows; RMSNorm at 1024 (the talker's rows, one decode
    row, a Code2Wav chunk), alone and with the add, the qk-norm + rope at 16
    + 2 heads of 64 and 16 + 8 of 128, rope on the talker's 18 heads of 64,
    the predictor's 24 of 128 and
    Code2Wav's 32 of 64, and the ConvNeXt LayerNorm at C = 1024, eps 1e-6,
    over 650 and 1300 rows."""
    from t2v_metrics_tpu_torch.ops import moe as M
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    cfg = talker_run_config()
    t, pc, c2 = cfg.text, cfg.predictor, cfg.code2wav
    n = TALKER_PROMPT
    dev = randn(1).device
    lanes = (t.heads + 2 * t.kv_heads) * t.head_dim
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    checked_site(record, f"Qwen3-Omni talker prefill (1, {n}, {lanes}) d=64, GQA 16/2, causal",
                 randn(1, n, lanes), t.heads, dict(kv_heads=t.kv_heads, causal=True, kv_mask=mask),
                 (("no causal mask", {"causal": False}), ("a window of 512", {"local_window": 512})))
    focused_cache_site(record, randn, f"Qwen3-Omni talker decode, q (1, 1, 16x64) over "
                       f"{n + 16} cached slots, GQA 16/2", n + 16, t.heads, t.kv_heads,
                       t.head_dim)
    focused_cache_site(record, randn, f"Qwen3-Omni code predictor step, q (1, 1, 16x128) over "
                       f"{cfg.num_code_groups} cached slots, GQA 16/8", cfg.num_code_groups,
                       pc.heads, pc.kv_heads, pc.head_dim)
    rows = 300 + 25
    c_lanes = (c2.num_attention_heads + 2 * c2.num_key_value_heads) * c2.head_dim
    c_mask = torch.ones((1, rows), dtype=torch.bool, device=dev)
    checked_site(record, f"Qwen3-Omni Code2Wav transformer (1, {rows}, {c_lanes}) d=64, 16 "
                 f"heads, causal, window {c2.sliding_window}", randn(1, rows, c_lanes),
                 c2.num_attention_heads,
                 dict(causal=True, local_window=c2.sliding_window, kv_mask=c_mask),
                 ((f"a window of {c2.sliding_window - 1}",
                   {"local_window": c2.sliding_window - 1}),
                  ("no window", {"local_window": None})))
    free_cuda()

    # the grouped GEMM at the talker's expert shapes
    weights = {"gate_up": randn(128, t.d_model, 2 * t.moe_d_ff, std=t.d_model ** -0.5),
               "down": randn(128, t.moe_d_ff, t.d_model, std=t.moe_d_ff ** -0.5)}
    for what, tokens in (("prefill", n), ("decode step", 1)):
        ids = randn(tokens, 128, dtype=torch.float32).topk(8).indices.reshape(-1)
        _, _, be, p, used, _ = M._plan(ids, 128, M.BLOCK_M)
        be_host, used_host = be.cpu(), used.cpu()
        counts = torch.bincount(ids, minlength=128)
        offs = torch.cumsum((counts + 127) // 128 * 128, 0).int()
        experts, tk = int((counts > 0).sum()), ids.numel()
        for wname, w in weights.items():
            k, nn_ = w.shape[1], w.shape[2]
            xg = randn(p, k)
            out = M.grouped_matmul(xg, w, be, M.BLOCK_M, used)
            ref = M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M, used_host)
            torch.cuda.synchronize()
            bad = outside(out, ref, GMM_ATOL, GMM_RTOL)
            ms = library_ms(lambda: torch._grouped_mm(xg, w, offs=offs),  # noqa: B023
                            "torch._grouped_mm")
            label = (f"Qwen3-Omni talker {what} {wname}, {tk} routed rows ({p} buffer rows, "
                     f"{int(used_host)} blocks) x (128, {k}, {nn_}), {experts} experts used")
            record("grouped_gemm", label, out, ref,
                   bad == 0 and bool(torch.isfinite(out).all()),
                   f"{bad} outside atol {GMM_ATOL} + rtol 2^-7; max {bf16_ulps(out, ref)} "
                   "bf16 ulps",
                   lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, used),  # noqa: B023
                   lambda: M.grouped_matmul_reference(  # noqa: B023
                       xg, w, be_host, M.BLOCK_M, used_host), False,
                   flop=2 * int(used_host) * M.BLOCK_M * k * nn_,
                   lower=(2 * tk * k * nn_, 2 * (tk * k + experts * k * nn_ + tk * nn_), "bf16"),
                   library=None if ms is None else ("torch._grouped_mm", ms), site=True)
            if what == "decode step":
                log_host("grouped_gemm", label,
                         lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, used))  # noqa: B023
            del xg, out, ref
    del weights
    free_cuda()

    # RMSNorm at 1024 (eps 1e-6 in the decoders, 1e-5 in Code2Wav), alone and
    # through the add entry
    for label, r, eps in (("talker prefill", n, 1e-6), ("talker decode", 1, 1e-6),
                          ("Code2Wav chunk", rows, 1e-5)):
        x, res, w = randn(r, 1024, std=3.0), randn(r, 1024, std=3.0), randn(1024)
        rms_site(record, f"Qwen3-Omni {label} ({r}, 1024) eps {eps}", x, w, eps=eps)
        rms_site(record, f"Qwen3-Omni {label} add + RMSNorm ({r}, 1024) eps {eps}", x, w,
                 r=res, eps=eps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    # the qk-norm + rope in place: the talker's prefill rows, the predictor's
    # prefill
    for label, r, hq, hk, d in (("talker", n, t.heads, t.kv_heads, t.head_dim),
                                ("code predictor", 2, pc.heads, pc.kv_heads, pc.head_dim)):
        heads = hq + 2 * hk
        pk, qs, ks = randn(1, r, heads * d, std=3.0), randn(d), randn(d)
        qk_rope_site(record, f"Qwen3-Omni {label} qk-norm + rope (1, {r}, {heads * d}), "
                     f"{hq}+{hk} heads of {d} in place", pk, qs, ks,
                     *rope_angles(gen, 1, r, d, 2048), hq, hk, d)
        del pk
    # rope on the packed q|k lanes
    for label, r, hq, hk, hv, d in (("talker prefill", n, t.heads, t.kv_heads, t.kv_heads, 64),
                                    ("code predictor prefill", 2, pc.heads, pc.kv_heads,
                                     pc.kv_heads, 128),
                                    ("Code2Wav chunk", rows, 16, 16, 16, 64)):
        rot, width = hq + hk, (hq + hk + hv) * d
        pk = randn(1, r, width)
        ang = (torch.randint(0, 2048, (1, r, 1), generator=gen, device=dev).float()
               * randn(d, dtype=torch.float32).abs())
        cos, sin = torch.cos(ang), torch.sin(ang)
        buf = pk.clone()
        norm_site(record, "rope_pack", f"Qwen3-Omni {label} (1, {r}, {width}) {rot} heads of {d}",
                  R.rope_pack(buf, cos, sin, rot, d), R.rope_pack_plain(pk, cos, sin, rot, d),
                  lambda: R.rope_pack(buf, cos, sin, rot, d),  # noqa: B023
                  lambda: R.rope_pack_plain(pk, cos, sin, rot, d),  # noqa: B023
                  (3 * r * rot * d, 4 * r * rot * d + 8 * r * d, "fp32"))
        del pk, buf, cos, sin, ang
    # the ConvNeXt LayerNorm after each 2x upsampling of a 325-row chunk
    for r in (2 * rows, 4 * rows):
        x, w, b = randn(r, 1024, std=3.0), randn(1024), randn(1024)
        norm_site(record, "layer_norm", f"Qwen3-Omni Code2Wav ConvNeXt ({r}, 1024) eps 1e-6",
                  N.layer_norm_fused(x, w, b, 1e-6), N.layer_norm_plain(x, w, b, 1e-6),
                  lambda: N.layer_norm_fused(x, w, b, 1e-6),  # noqa: B023
                  lambda: N.layer_norm_plain(x, w, b, 1e-6),  # noqa: B023
                  (8 * r * 1024, 4 * r * 1024 + 4 * 1024, "fp32"),
                  ("F.layer_norm", cuda_ms(
                      lambda: F.layer_norm(x, (1024,), w, b, 1e-6))))  # noqa: B023
    free_cuda()


def talker_prompt(cfg, rows: int, seed: int):
    """A seeded talker prompt on the host: embeddings (1, rows, D), 3-D
    positions (3, 1, rows) with an 8 x 8 image block at rows 16-79 whose
    h / w streams differ (the interleaved M-RoPE's three streams), 12
    trailing text rows and the tts-pad row."""
    g = np.random.default_rng(seed)
    d = cfg.text.d_model
    pos = np.zeros((3, 1, rows), np.int64)
    pos[:, 0, :16] = np.arange(16)
    blk = np.arange(64)
    pos[0, 0, 16:80], pos[1, 0, 16:80], pos[2, 0, 16:80] = 16, 16 + blk // 8, 16 + blk % 8
    pos[:, 0, 80:] = 24 + np.arange(rows - 80)

    def t(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))

    return t(1, rows, d), pos, t(1, 12, d), t(1, 1, d)


def forced_talker(sess, embeds, pos, trailing, tts_pad, codes: np.ndarray):
    """The talker and its code predictor fed the frames ``codes`` (G, F) as
    ``TalkerSession.generate_codes`` feeds its own: log P (fp32 log-softmax
    of the raw logits) of each frame's first code from the talker, (F,), and
    of its residual codes from the predictor, (F, G - 1)."""
    from t2v_metrics_tpu_torch.models import decoder as D

    cfg, params = sess.cfg, sess.params
    table = params.decoder.embed
    dev, dtype = table.device, table.dtype
    g, frames = codes.shape
    e = embeds.to(dev, dtype)
    n = e.shape[1]
    last_pos = int(pos[:, 0, n - 1].max())
    lg, cache, hid, valid = sess.talker_prefill(e, torch.as_tensor(pos, device=dev), n + frames)
    t_lp, p_lp = [], []
    for t in range(frames):
        t_lp.append(lg.float().log_softmax(-1)[int(codes[0, t])])
        first = table[int(codes[0, t])][None, None]
        pcache = D.init_cache(cfg.predictor, 1, g, dtype=dtype, device=dev)
        pvalid = torch.zeros((1, g), dtype=torch.bool, device=dev)
        pvalid[0, :2] = True
        plg, pcache = sess.predictor_prefill(torch.cat([hid, first], 1), pvalid, pcache)
        row, emb = [plg.log_softmax(-1)[int(codes[1, t])]], first
        for gs in range(1, g):
            ge = params.predictor.group_embeds[gs - 1][int(codes[gs, t])][None, None]
            emb = emb + ge
            if gs < g - 1:
                plg, pcache = sess.predictor_step(ge, gs, pvalid, pcache)
                row.append(plg.log_softmax(-1)[int(codes[gs + 1, t])])
        p_lp.append(torch.stack(row))
        if t < frames - 1:
            emb = emb + (trailing[:, t:t + 1] if t < trailing.shape[1] else tts_pad).to(dev, dtype)
            lg, cache, hid = sess.talker_step(emb.to(dtype), n + t, last_pos + 1 + t, 3, valid,
                                              cache)
    return torch.stack(t_lp).float().cpu().numpy(), torch.stack(p_lp).float().cpu().numpy()


def host_copy(module_card, make):
    """An fp32 host copy of a card module, one tensor at a time."""
    host = make()
    with torch.no_grad():
        dst = host.state_dict()
        for name, t in module_card.state_dict().items():
            dst[name].copy_(t.float().cpu())
    return host


def phase_talker_chain(device: str = "cuda") -> None:
    """Qwen3-Omni's speech path at HF's published widths cut to 2 talker
    layers of 128 experts with the shared expert, 2 of the code predictor's
    5 layers and Code2Wav's whole conv stack behind 2 transformer layers:
    card bf16 against CPU fp32 on one set of seeded parameters (drawn on the
    card in HF's layout through the port's converters, copied to the host).
    The CPU's greedy codec frames (TALKER_FRAMES of them, from a seeded
    prompt) go through both sides: each talker step's log P of its frame's
    first code within TALKER_STEP_TOL_NATS, each predictor step's within
    PREDICTOR_STEP_TOL_NATS; Code2Wav on a seeded C2W_CHAIN_FRAMES-frame
    matrix within WAV_TOL_RMS of rms(CPU); the launch counts of both card
    runs against the code's."""
    from t2v_metrics_tpu_torch.models import qwen3omni_talker as tk
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = "[talker chain]"
    cfg = talker_run_config(text_layers=2, pred_layers=2, c2w_layers=2)
    card = tk.init_talker(cfg, SEED + 21, device, torch.bfloat16)
    proj_ff = card.text_projection.fc1.w.shape[1]
    host = host_copy(card, lambda: tk.TalkerModel(cfg, proj_ff, "cpu", torch.float32))
    sessions = tk.TalkerSession(cfg, card), tk.TalkerSession(cfg, host)
    embeds, pos, trailing, pad = talker_prompt(cfg, 300, SEED + 22)
    t0 = time.perf_counter()
    codes = sessions[1].generate_codes(embeds, pos, trailing, pad, max_new_tokens=TALKER_FRAMES,
                                       do_sample=False, predictor_do_sample=False)
    t1 = time.perf_counter()
    frames, g = codes.shape[1], cfg.num_code_groups
    check(frames >= 2, f"{tag} the CPU's greedy run gave {frames} frames")
    reset_launch_counts()
    with torch.inference_mode():
        t2 = time.perf_counter()
        on_card = forced_talker(sessions[0], embeds, pos, trailing, pad, codes)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = launch_counts()
        on_cpu = forced_talker(sessions[1], embeds, pos, trailing, pad, codes)
    want = add_launches(decoder_launches(cfg.text, frames),
                        decoder_launches(cfg.predictor, frames * (g - 1)))
    t_gap = np.abs(on_card[0] - on_cpu[0])
    p_gap = np.abs(on_card[1] - on_cpu[1])
    log(f"{tag} 2 talker layers of 128 experts + shared expert, 2 predictor layers, HF's "
        f"widths: the CPU's greedy {g} x {frames} frames ({(t1 - t0) * 1e3:.0f} ms fp32) forced "
        f"through both sides: card bf16 {(t3 - t2) * 1e3:.1f} ms; card launches "
        f"{json.dumps(counts)}; from the code {json.dumps(want)}")
    log(f"{tag} talker log P(first code) card {rounded(on_card[0])}, cpu {rounded(on_cpu[0])}; "
        f"|card - cpu| max {float(t_gap.max()):.4e} nats (limit {TALKER_STEP_TOL_NATS})")
    log(f"{tag} predictor log P(residual code): |card - cpu| max {float(p_gap.max()):.4e} nats "
        f"(limit {PREDICTOR_STEP_TOL_NATS}), mean {float(p_gap.mean()):.4e}; spread of the CPU's "
        f"{float(np.ptp(on_cpu[1])):.3f}")
    check(np.isfinite(on_card[0]).all() and np.isfinite(on_card[1]).all(),
          f"{tag} card log-probs not finite")
    check(counts == want, f"{tag} launch counts {counts} != {want}")
    check(float(t_gap.max()) <= TALKER_STEP_TOL_NATS, f"{tag} a talker step differs by "
          f"{float(t_gap.max())} nats")
    check(float(p_gap.max()) <= PREDICTOR_STEP_TOL_NATS, f"{tag} a predictor step differs by "
          f"{float(p_gap.max())} nats")
    del card, host, sessions
    free_cuda()

    c2 = cfg.code2wav
    card = tk.init_code2wav(c2, SEED + 23, device, torch.bfloat16)
    host = host_copy(card, lambda: tk.Code2WavModel(c2, "cpu", torch.float32))
    mat = np.random.default_rng(SEED + 24).integers(0, c2.codebook_size,
                                                    (1, c2.num_quantizers, C2W_CHAIN_FRAMES))
    reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        wav = tk.code2wav(card, c2, mat).float().cpu()
        t1 = time.perf_counter()
        counts = launch_counts()
        ref = tk.code2wav(host, c2, mat)
        t2 = time.perf_counter()
    rms = float(ref.square().mean().sqrt())
    rel = float((wav - ref).square().mean().sqrt()) / rms
    clipped = float((ref.abs() >= 1).float().mean())
    log(f"{tag} Code2Wav, 2 transformer layers + the whole conv stack, {C2W_CHAIN_FRAMES} "
        f"frames -> {wav.shape[-1]} samples: card bf16 {(t1 - t0) * 1e3:.1f} ms, cpu fp32 "
        f"{(t2 - t1) * 1e3:.0f} ms; rms(cpu) {rms:.4f} ({clipped:.4f} of it clamped); "
        f"rms(card - cpu) {rel:.4e} x rms(cpu) (limit {WAV_TOL_RMS}); launches "
        f"{json.dumps(counts)}")
    check(torch.isfinite(wav).all() and wav.shape == ref.shape, f"{tag} waveform {wav.shape}")
    check(counts == c2w_launches(c2), f"{tag} Code2Wav launches {counts}")
    check(0.01 < rms < 0.9 and rel <= WAV_TOL_RMS, f"{tag} waveform off by {rel} x rms(cpu)")


class ForwardProbe:
    """While active, wraps the decoder's ``forward`` to record each cached
    call with the name of the config it runs (``kinds``: name -> config), a
    pair of CUDA events around it, its host enqueue time and whether it is
    a prefill (cache slot 0). Events and host counters only."""

    def __init__(self, kinds: dict):
        from t2v_metrics_tpu_torch.models import decoder as D

        self.mod, self.kinds, self.calls = D, kinds, []

    def __enter__(self):
        orig = self.orig = self.mod.forward

        def wrapped(*args, **kw):
            if kw.get("cache") is None:
                return orig(*args, **kw)
            kind = next((k for k, c in self.kinds.items() if args[1] == c), "other")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = orig(*args, **kw)
            end.record()
            self.calls.append((kind, kw.get("cache_pos", 0) == 0, start, end,
                               time.perf_counter() - t0))
            return out

        self.mod.forward = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.forward = self.orig
        torch.cuda.synchronize()

    def spans(self, kind: str, prefill: bool) -> tuple[int, float, float]:
        """(calls, median card ms, median host enqueue ms) of one kind."""
        sel = [(s, e, h) for k, p, s, e, h in self.calls if k == kind and p == prefill]
        if not sel:
            return 0, float("nan"), float("nan")
        return (len(sel), statistics.median(s.elapsed_time(e) for s, e, _ in sel),
                statistics.median(h for _, _, h in sel) * 1e3)


def phase_talker_slice(model: str = OMNI, device: str = "cuda", side: int = 1024,
                       profile: bool = False) -> list:
    """``VQAScore("qwen3-omni-30b-a3b", init="random")``, the whole thinker,
    with a chat-preserving tokenizer (``chat_tokenizer``) and a random talker
    and Code2Wav at HF's published widths (``talker_run_config``: 20 MoE
    layers of 128 experts, a 5-layer predictor, 8 transformer layers),
    drawn on the card in HF's layout through the port's converters one layer
    at a time and passed as ``talker_config=``, ``talker_params=``,
    ``code2wav_params=``. Runs: ``generate`` of 4 pairs (batched) and of 1
    pair (per sequence), each a 1024x1024 image with a 10 s clip, 16 tokens;
    ``forward_with_trace`` of that pair at 4 tokens; ``generate(
    return_audio=True)`` of that pair, 16 tokens and 32 talker frames,
    greedy and sampled from the adapter's seed; one ``chunked_decode`` of a
    seeded 600-frame code matrix (a 300-row chunk, then 300 frames + 25 of
    context). Each: the launch counts against the code's; the thinker's ms a
    step, the talker's ms a frame (talker step, predictor prefill and steps:
    card span and host enqueue), frames/s against 12.5, Code2Wav's ms a
    chunk and the peak memory; with ``profile`` the device time of the
    greedy speech run by kernel family. Returns the launch counts."""
    import tempfile

    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models import qwen3omni_talker as tk
    from t2v_metrics_tpu_torch.models.qwen3omni import resolve_config
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"[{model} talker slice]"
    th_cfg = resolve_config(model)
    tok = chat_tokenizer(th_cfg.text.vocab_size)
    cfg = talker_run_config(tok)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    talker = tk.init_talker(cfg, SEED + 31, device, torch.bfloat16)
    c2w = tk.init_code2wav(cfg.code2wav, SEED + 32, device, torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    talker_gib = torch.cuda.memory_allocated() / 2**30
    scorer = t2v.VQAScore(model, init="random", seed=SEED, device=device, tokenizer=tok,
                          talker_config=cfg, talker_params=talker, code2wav_params=c2w)
    torch.cuda.synchronize()
    n_talker = sum(p.numel() for p in talker.parameters())
    n_c2w = sum(p.numel() for p in c2w.parameters())
    log(f"{tag} talker {n_talker / 1e9:.3f} B + Code2Wav {n_c2w / 1e9:.3f} B parameters drawn "
        f"in HF's layout and converted layer by layer: {t1 - t0:.2f} s, {talker_gib:.2f} GiB; "
        f"with the thinker {torch.cuda.memory_allocated() / 2**30:.2f} GiB, load peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({time.perf_counter() - t0:.2f} s)")
    del talker, c2w
    m = scorer.model
    kinds = {"thinker": th_cfg.text, "talker": cfg.text, "predictor": cfg.predictor}
    g = cfg.num_code_groups
    out = []

    def run(label, fn, expect):
        """One call under the probes: its launches against ``expect(probe,
        result)``, its card spans, peak memory and wall."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        chunks = []
        c2w_fn = tk.code2wav

        def timed_c2w(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = c2w_fn(*a, **k)
            end.record()
            chunks.append((start, end))
            return res

        tk.code2wav = timed_c2w
        try:
            with ForwardProbe(kinds) as probe:
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            tk.code2wav = c2w_fn
        counts = launch_counts()
        want = expect(probe, res)
        c2w_ms = [s.elapsed_time(e) for s, e in chunks]
        log(f"{tag} {label}: {wall:.3f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; launches {json.dumps(counts)}; from the code {json.dumps(want)}"
            + (f"; Code2Wav {[round(x, 3) for x in c2w_ms]} ms a chunk" if c2w_ms else ""))
        check(counts == want, f"{tag} {label}: launch counts {counts} != {want}")
        out.append(counts)
        return res, probe, wall

    def thinker_counts(probe, res=None):
        """One audio and one vision tower call, the thinker's prefill and
        the decode steps the probe saw."""
        steps = probe.spans("thinker", False)[0]
        return add_launches(omni_launches(th_cfg, 1, 1), decoder_launches(th_cfg.text, steps))

    def thinker_line(label, probe):
        n, ms, host = probe.spans("thinker", False)
        _, pre, _ = probe.spans("thinker", True)
        log(f"{tag} {label}: thinker prefill {pre:.2f} ms; {n} decode steps, median {ms:.3f} ms "
            f"a step on the card, {host:.3f} ms of host enqueue a step")

    with tempfile.TemporaryDirectory() as tmp:
        wavs = [write_seeded_wav(os.path.join(tmp, f"s{i}.wav"), 10.0, 301 + i)
                for i in range(4)]
        images, texts = seeded_images(4, 311, side, side), seeded_texts(4, 312)
        res, probe, wall = run("generate 4 pairs (image + 10 s clip) x 16 tokens, batched",
                               lambda: m.generate(images, texts, audio_paths=wavs,
                                                  max_new_tokens=16), thinker_counts)
        check(len(res) == 4 and all(isinstance(x, str) for x in res), f"{tag} generate {res!r}")
        thinker_line("batched generate", probe)
        res, probe, wall = run("generate 1 pair x 16 tokens, per sequence",
                               lambda: m.generate(images[:1], texts[:1], audio_paths=wavs[:1],
                                                  max_new_tokens=16), thinker_counts)
        thinker_line("per-sequence generate", probe)
        (probs, traces), probe, _ = run(
            "forward_with_trace 1 pair, 4 tokens, end",
            lambda: m.forward_with_trace(images[:1], texts[:1], audio_paths=wavs[:1],
                                         max_new_tokens=4), thinker_counts)
        check(probs.shape == (1,) and 0.0 <= float(probs[0]) <= 1.0 and len(traces) == 1,
              f"{tag} forward_with_trace {probs}")
        log(f"{tag} forward_with_trace: P {float(probs[0]):.4e}, generated length "
            f"{traces[0]['generated_length']}")

        def speech_counts(probe, res):
            frames = probe.spans("predictor", True)[0]
            check(probe.spans("talker", True)[0] == 1
                  and probe.spans("talker", False)[0] == frames
                  and probe.spans("predictor", False)[0] == frames * (g - 2),
                  f"{tag} talker / predictor calls do not make {frames} frames")
            chunks = -(-frames // 300) if frames else 0
            return add_launches(thinker_counts(probe), decoder_launches(cfg.text, 1 + frames),
                                decoder_launches(cfg.predictor, frames * (g - 1)),
                                c2w_launches(cfg.code2wav, chunks))

        for mode, sample in (("greedy", False), ("sampled", True)):
            path = os.path.join(tmp, f"{mode}.wav")
            (texts_out, wav_out), probe, wall = run(
                f"generate(return_audio=True) 1 pair, 16 tokens, 32 talker frames, {mode}",
                lambda: m.generate(images[:1], texts[:1], audio_paths=wavs[:1],  # noqa: B023
                                   max_new_tokens=16, return_audio=True,
                                   save_audio_path=path, talker_max_new_tokens=32,  # noqa: B023
                                   talker_do_sample=sample), speech_counts)  # noqa: B023
            frames = probe.spans("predictor", True)[0]
            w = wav_out[0]
            check(isinstance(texts_out[0], str) and w.ndim == 1 and np.isfinite(w).all()
                  and np.abs(w).max() <= 1.0 and (frames == 0 or w.size > 0),
                  f"{tag} {mode}: text {texts_out!r}, waveform {w.shape}")
            thinker_line(f"speech {mode}", probe)
            spans = {k: probe.spans(*k) for k in (("talker", False), ("predictor", True),
                                                   ("predictor", False))}
            card_frame = (spans[("talker", False)][1] + spans[("predictor", True)][1]
                          + (g - 2) * spans[("predictor", False)][1])
            host_frame = (spans[("talker", False)][2] + spans[("predictor", True)][2]
                          + (g - 2) * spans[("predictor", False)][2])
            first = next(i for i, c in enumerate(probe.calls) if c[0] == "talker")
            span_ms = probe.calls[first][2].elapsed_time(probe.calls[-1][3])
            log(f"{tag} speech {mode}: {frames} frames ({w.size} samples, {w.size / 24000:.2f} "
                f"s of 24 kHz audio); a frame: talker step {spans[('talker', False)][1]:.3f} ms "
                f"card / {spans[('talker', False)][2]:.3f} ms host, predictor prefill "
                f"{spans[('predictor', True)][1]:.3f} / {spans[('predictor', True)][2]:.3f}, "
                f"{g - 2} predictor steps {spans[('predictor', False)][1]:.3f} / "
                f"{spans[('predictor', False)][2]:.3f} each; {card_frame:.2f} ms card, "
                f"{host_frame:.2f} ms host a frame; the talker's card timeline from its "
                f"prefill to the last predictor step {span_ms:.1f} ms: "
                f"{frames / (span_ms / 1e3) if span_ms else 0:.2f} frames/s against 12.5 "
                f"(real time); wall {wall:.2f} s; text {texts_out[0][:60]!r}")
            with open(path, "rb") as f:
                check(len(f.read()) == 44 + 2 * w.size, f"{tag} {mode}: .wav size")
        if profile:
            phase_profile(lambda: m.generate(images[:1], texts[:1], audio_paths=wavs[:1],
                                             max_new_tokens=16, return_audio=True,
                                             talker_max_new_tokens=32,
                                             talker_do_sample=False),
                          f"{model} generate(return_audio=True) greedy")
    sess, tcfg, c2w = m._talker_session()
    mat = np.random.default_rng(SEED + 33).integers(
        0, tcfg.code2wav.codebook_size, (1, tcfg.code2wav.num_quantizers, 600))
    wav_c, _, _ = run("chunked_decode of 600 frames (chunks of 300 and 300 + 25 rows)",
                      lambda: tk.chunked_decode(c2w, tcfg.code2wav, mat),
                      lambda probe, res: c2w_launches(tcfg.code2wav, 2))
    check(wav_c.shape[-1] > 0 and np.isfinite(wav_c).all(), f"{tag} chunked_decode {wav_c.shape}")
    log(f"{tag} chunked_decode: {wav_c.shape[-1]} samples ({wav_c.shape[-1] / 24000:.2f} s); "
        f"card {card_line()}")
    del scorer, m, sess, c2w
    return out


# ---------------------------------------------------------------------------
# Optional phase (--profile): where the device time of batch_forward goes
# ---------------------------------------------------------------------------

# kernel families by substrings of the kernel's name; the rest is "other"
# (elementwise ops, gathers, copies, log-softmax)
# ---------------------------------------------------------------------------
# Parallel (parallel/): tensor, data, pipeline, sequence and expert
# parallelism as two ranks on the one card
# ---------------------------------------------------------------------------

# The card machine has one H100, and NCCL refuses two ranks on one GPU
# ("Duplicate GPU detected"). So phase_parallel runs two ranks on the one
# card over a gloo group (parallel/comm.py takes the collectives gloo has no
# CUDA route for through host memory, and counts the bytes). It shows that
# each rank's sharded program launches the kernels at its per-rank shapes
# and that the ranks together give the unsharded result. Its rates are
# those of two ranks sharing one card: not a multi-GPU rate.
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT_S = 600
# The pipeline's stages run the same kernels at the same shapes as one
# rank's encode of each microbatch, so the outputs are expected bitwise
# equal; should cuBLAS pick other algorithms in the two processes, the
# bar is 1e-3 of the output's rms.
PIPELINE_TOL_RMS = 1e-3


def parallel_kernels(randn, record, lengths_mask) -> None:
    """The kernels at the per-rank shapes phase_parallel's ranks give them:
    the int8 GEMM at clip-flant5-xxl's tp-2 shapes (column-parallel q|k|v,
    N halved; row-parallel o and wo, K halved, through the int32 sums and
    the second pass, bitwise the plain version, at the encoder's rows and at
    one decode step's, where the kernel splits K), the row quant's two
    steps (the absmax, then the quantize with the all-reduced scale), the
    grouped GEMM on 64 of qwen3-vl-30b-a3b's 128 experts (one rank of EP 2:
    the routed rows of its experts, the rest in a sink group never
    computed), and the flat attention of sequence parallelism (320 query
    rows of the xl encoder against all 640 keys, the bias rows offset to
    the rank's half)."""
    from t2v_metrics_tpu_torch.ops import attention as A
    from t2v_metrics_tpu_torch.ops import moe as M
    from t2v_metrics_tpu_torch.ops import quant as Q

    enc = 16 * 640                         # the 4 x 4 slice's encoder rows
    for label, m, k, n, row in (
            ("tp 2 column-parallel T5 encoder q|k|v", enc, 4096, 6144, False),
            ("tp 2 row-parallel T5 encoder o", enc, 2048, 4096, True),
            ("tp 2 row-parallel T5 encoder wo", enc, 5120, 4096, True),
            ("tp 2 row-parallel T5 decoder wo, one decode step of 16 pairs", 16, 5120, 4096,
             True)):
        x = randn(m, k, std=3.0)
        leaf = Q.Linear(randn(k, n, std=k ** -0.5)).quantize_()
        x_q, xs = Q.quantize_rows_plain(x)
        w_q, ws = leaf.w_q, leaf.scale
        if row:
            fn = lambda: Q.quant_matmul_dequant(Q.quant_matmul_sums(x_q, w_q),  # noqa: E731
                                                xs, ws)
        else:
            fn = lambda: Q.quant_matmul(x_q, w_q, xs, ws)  # noqa: E731
        plain_fn = lambda: Q.quant_matmul_plain(x_q, w_q, xs, ws)  # noqa: E731
        lib = library_ms(lambda: (torch._int_mm(x_q, w_q).float() * xs * ws  # noqa: B023
                                  ).to(torch.bfloat16), f"torch._int_mm ({m}, {k}) x ({k}, {n})")
        out, ref = fn(), plain_fn()
        ops = 2 * m * k * n
        # the row-parallel path also writes and reads the int32 sums its
        # all-reduce carries (the kernel's splits of K, if any, are its own)
        extra = 2 * 4 * m * n if row else 0
        splits = Q.G.split_k(m, n, k, Q.G.sm_count(x.device))
        record("quant_matmul", f"({m}, {k}) x ({k}, {n}) {label}"
               + (f" (partials in {splits} splits of K, summed, + second pass)" if row else ""),
               out, ref,
               bool(torch.equal(out, ref)), "bitwise equal required", fn, plain_fn, False,
               flop=ops, lower=(ops, m * k + k * n + 4 * (m + n) + 2 * m * n + extra, "int8"),
               library=None if lib is None else ("torch._int_mm + f32 epilogue", lib),
               site=True)
        del x, leaf, x_q, xs, out, ref
    x = randn(enc, 2048, std=3.0)
    out, ref = Q.row_absmax(x), Q.row_absmax_plain(x)
    record("quantize_rows", f"tp 2 row absmax ({enc}, 2048)", out, ref, bool(torch.equal(out, ref)),
           "bitwise equal required", lambda: Q.row_absmax(x), lambda: Q.row_absmax_plain(x),
           False, lower=(2 * enc * 2048, 2 * enc * 2048 + 4 * enc, "fp32"),
           library=("torch.amax of |x| (two calls)", cuda_ms(
               lambda: x.abs().amax(-1, keepdim=True))), site=True)
    xs = Q._absmax_scale(ref)
    out, ref = Q.quantize_rows_scaled(x, xs), Q.quantize_rows_scaled_plain(x, xs)
    record("quantize_rows", f"tp 2 quantize with the all-reduced scale ({enc}, 2048)", out, ref,
           bool(torch.equal(out, ref)), "bitwise equal required",
           lambda: Q.quantize_rows_scaled(x, xs), lambda: Q.quantize_rows_scaled_plain(x, xs),
           False, lower=(2 * enc * 2048, 3 * enc * 2048 + 4 * enc, "fp32"), site=True)
    del x, xs, out, ref
    free_cuda()

    # EP 2 of qwen3-vl-30b-a3b: 16 x 1024 tokens routed top-8 over 128
    # experts; rank 0 holds experts 0-63 and computes only their rows
    tokens = 16 * 1024
    topi = randn(tokens, 128, dtype=torch.float32).topk(8).indices
    mine = topi < 64
    ids = torch.where(mine, topi, 64).reshape(-1)
    _, _, be, p, used, _ = M._plan(ids, 65, M.BLOCK_M, 64)
    be_host, used_host = be.cpu(), used.cpu()
    tk = int(mine.sum())
    counts = torch.bincount(ids[ids < 64], minlength=64)
    offs = torch.cumsum((counts + 127) // 128 * 128, 0).int()
    for wname, w in (("gate_up", randn(64, 2048, 1536, std=2048 ** -0.5)),
                     ("down", randn(64, 768, 2048, std=768 ** -0.5))):
        k, n = w.shape[1], w.shape[2]
        xg = randn(p, k)
        out = M.grouped_matmul(xg, w, be, M.BLOCK_M, used)
        ref = M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M, used_host)
        bad = outside(out, ref, GMM_ATOL, GMM_RTOL)
        lib = library_ms(lambda: torch._grouped_mm(xg, w, offs=offs),  # noqa: B023
                         "torch._grouped_mm")
        record("grouped_gemm",
               f"EP 2 {wname} ({p}, {k}) x (64 local experts, {k}, {n}), {tk} of "
               f"{tokens * 8} assignments routed here, num_blocks {int(used_host)}",
               out, ref, bad == 0 and bool(torch.isfinite(out).all()),
               f"{bad} outside atol {GMM_ATOL} + rtol 2^-7; max {bf16_ulps(out, ref)} bf16 ulps",
               lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, used),  # noqa: B023
               lambda: M.grouped_matmul_reference(xg, w, be_host, M.BLOCK_M,  # noqa: B023
                                                  used_host), False,
               flop=2 * tk * k * n,
               lower=(2 * tk * k * n, 2 * (tk * k + 64 * k * n + tk * n), "bf16"),
               library=None if lib is None else ("torch._grouped_mm", lib), site=True)
        del w, xg, out, ref
    free_cuda()

    # SP 2 of the xl T5 encoder: 16 pairs, this rank's 320 query rows of 640
    # against every key (K|V all-gathered), bias rows 320-639, keys masked
    b, heads, d = 16, 32, 64
    q = randn(b, 320, heads * d)
    kv = randn(b, 640, 2 * heads * d)
    k_, v_ = kv[..., :heads * d], kv[..., heads * d:]
    bias = randn(1, heads, 640, 640, dtype=torch.float32)[:, :, 320:].contiguous()
    mask = lengths_mask(b, 640, 400, 640)
    kw = dict(bias=bias, kv_mask=mask, scale=1.0)
    out = A.attention_flat(q, k_, v_, heads, **kw)
    ref = A.attention_flat_reference(q, k_, v_, heads, **kw)
    ok, detail = attention_agrees(out, ref)
    qh, kh, vh = (A.split_heads(t, heads) for t in (q, k_, v_))
    amask = (bias + torch.where(mask, 0.0, float("-inf"))[:, None, None, :]).to(torch.bfloat16)
    name = "F.scaled_dot_product_attention (bf16 float mask, scale 1.0)"
    lib = library_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask,
                                                            scale=1.0), name)
    flop = 4 * b * heads * 320 * 640 * d
    record("flash_attention_flat", "SP 2 T5 encoder: 320 query rows of 640 against all "
           "640 keys, bias rows offset to 320, kv_mask", out, ref, ok, detail,
           lambda: A.attention_flat(q, k_, v_, heads, **kw),
           lambda: A.attention_flat_reference(q, k_, v_, heads, **kw), False, flop=flop,
           lower=(flop, 2 * b * 320 * heads * d * 2 + 2 * b * 640 * 2 * heads * d
                  + 4 * heads * 320 * 640 + b * 640, "bf16"),
           library=None if lib is None else (name, lib), site=True)
    del q, kv, bias, mask, out, ref, amask
    free_cuda()


def tp_int8_launches(cfg) -> int:
    """quant_matmul (and quantize_rows) launches of one T5 pass under
    ``int8`` at tp > 1: a column-parallel product launches the fused GEMM
    and the row quant once each; a row-parallel one (o, cross o, wo) the
    GEMM's int32 partials and its second pass, the row absmax and the
    quantize with the all-reduced scale: two each. A gated encoder layer
    has 2 + 2 of them, a decoder layer 5 + 3 (q|k|v, cross q, k, v,
    wi_0|wi_1; o, cross o, wo)."""
    return (2 + 2 * 2) * cfg.t5.enc_layers + (5 + 3 * 2) * cfg.t5.dec_layers


def _case_run(fn) -> dict:
    """``fn()`` with the launch counts, the bytes staged through the host,
    the seconds and the device peak of its run."""
    from t2v_metrics_tpu_torch.ops import launch_counts, reset_launch_counts
    from t2v_metrics_tpu_torch.parallel import comm

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    staged = comm.STAGED["bytes"]
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return {"value": value, "counts": launch_counts(), "s": time.perf_counter() - t0,
            "staged": comm.STAGED["bytes"] - staged,
            "peak": torch.cuda.max_memory_allocated()}


def _clip_t5_engine(cfg, seed: int, mesh, quant=None):
    from t2v_metrics_tpu_torch import SimpleT5Tokenizer
    from t2v_metrics_tpu_torch.engine.scoring import CLIPT5Engine
    from t2v_metrics_tpu_torch.models.clip_flant5 import init_clip_t5
    from t2v_metrics_tpu_torch.ops import quant as Q

    model = init_clip_t5(cfg, seed, "cuda", torch.bfloat16, mesh=mesh)
    fold_t5_attention_scale(model, cfg)
    if quant:
        Q.quantize_t5_(model.t5)
    return CLIPT5Engine(model, cfg, SimpleT5Tokenizer(cfg.t5.vocab_size), "cuda", mesh=mesh)


def par_tp_chain(par: bool, quant=None) -> dict:
    """clip-flant5-xxl widths, 2 ViT + 2+2 T5 layers, T5 scale folded, at tp
    2 (or on one rank): log scores of 2 images x 4 texts."""
    from t2v_metrics_tpu_torch.parallel.mesh import make_mesh

    cfg = chain_config(model="clip-flant5-xxl")
    eng = _clip_t5_engine(cfg, SEED + 40, make_mesh(dp=1, tp=2) if par else None, quant)
    return _case_run(lambda: np.log(eng.score_matrix(seeded_images(2, 41),
                                                     seeded_texts(4, 42))))


def par_tp_full(par: bool) -> dict:
    """clip-flant5-xxl whole (24 ViT + 24+24 T5 layers) at tp 2, T5 scale
    folded: 4 x 4 pairs, once to warm up and once timed; the device peak
    from the model's making on, and one rank's parameter bytes under the
    mesh (``abstract_sharded_params``)."""
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS, CLIPT5Model
    from t2v_metrics_tpu_torch.parallel.mesh import make_mesh, sharded_bytes

    cfg = CLIP_T5_CONFIGS["clip-flant5-xxl"]
    mesh = make_mesh(dp=1, tp=2)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    eng = _clip_t5_engine(cfg, SEED + 43, mesh)
    images, texts = seeded_images(4, 44), seeded_texts(4, 45)
    eng.score_matrix(images, texts)
    peak = torch.cuda.max_memory_allocated()
    run = _case_run(lambda: np.log(eng.score_matrix(images, texts)))
    run["peak"] = max(peak, run["peak"])
    run["estimate"] = sharded_bytes(CLIPT5Model(cfg, "meta", torch.bfloat16), mesh)
    return run


def par_dp(par: bool) -> dict:
    """clip-flant5-xl whole, 8 images x 4 texts through batch_forward: at dp
    2 one chunk of 32 pairs, split by image (each rank 4 images, 16 pairs);
    on one rank the same two chunks of 16 pairs."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.parallel.mesh import make_mesh

    images, texts = seeded_images(8, 46), seeded_texts(4, 47)
    data = [{"images": [im], "texts": texts} for im in images]
    s = t2v.VQAScore("clip-flant5-xl", init="random", seed=SEED + 48, device="cuda",
                     tokenizer=t2v.SimpleT5Tokenizer(32128),
                     mesh=make_mesh(dp=2, tp=1) if par else None)
    if par:
        return _case_run(lambda: s.batch_forward(data, batch_size=8))
    return _case_run(lambda: np.concatenate([s.batch_forward(data[:4], batch_size=4),
                                             s.batch_forward(data[4:], batch_size=4)]))


def par_pp(par: bool) -> dict:
    """The clip-flant5-xl T5 encoder (24 layers) on 16 x 640 rows: at pp 2
    stages of 12 + 12 layers with 4 microbatches of 4; on one rank encode
    of each microbatch. Returns the output's bf16 bits."""
    from t2v_metrics_tpu_torch.models import t5 as tt5
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS
    from t2v_metrics_tpu_torch.parallel import pipeline as P
    from t2v_metrics_tpu_torch.parallel.mesh import Mesh

    cfg = dataclasses.replace(CLIP_T5_CONFIGS["clip-flant5-xl"].t5, dec_layers=0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 49)
    model = tt5.init_t5(tt5.T5Model(cfg, "cuda", torch.bfloat16), gen)
    embeds = torch.randn((16, 640, cfg.d_model), generator=gen, device="cuda").bfloat16()
    lens = torch.randint(500, 641, (16,), generator=gen, device="cuda")
    mask = torch.arange(640, device="cuda")[None] < lens[:, None]
    if par:
        mesh = Mesh(np.arange(PARALLEL_WORLD), ("pp",))
        P.stage_encoder_(model, cfg, mesh)
        free_cuda()
        run = _case_run(lambda: P.pipeline_encode(model, cfg, embeds, mask, mesh, n_micro=4))
    else:
        run = _case_run(lambda: torch.cat([tt5.encode(model, cfg, embeds[i:i + 4],
                                                      mask[i:i + 4]) for i in range(0, 16, 4)]))
    run["value"] = run["value"].view(torch.int16).cpu().numpy()
    run["layers"] = len(model.encoder.blocks)
    return run


def par_sp(par: bool) -> dict:
    """The xl chain (2 ViT + 2+2 T5 layers, scale folded) at sp 2: each rank
    runs 320 of the encoder's 640 rows; 2 images x 4 texts."""
    from t2v_metrics_tpu_torch.parallel.mesh import make_mesh

    eng = _clip_t5_engine(chain_config(), SEED + 50,
                          make_mesh(dp=1, sp=2, tp=1) if par else None)
    return _case_run(lambda: np.log(eng.score_matrix(seeded_images(2, 51),
                                                     seeded_texts(4, 52))))


def par_ep(par: bool) -> dict:
    """qwen3-vl-30b-a3b widths, 2 ViT + 2 decoder layers of 128 experts, at
    ep 2 (each rank 64 experts): log scores of 2 images x 2 texts and each
    pair's top-8 sets at its scored row."""
    import t2v_metrics_tpu_torch as t2v
    from t2v_metrics_tpu_torch.models.qwen3vl import init_qwen3vl
    from t2v_metrics_tpu_torch.parallel.mesh import make_mesh

    cfg = qwen3_chain_config()
    model = init_qwen3vl(cfg, SEED + 53, "cuda", torch.bfloat16,
                         mesh=make_mesh(dp=1, ep=2, tp=1) if par else None)
    scorer = t2v.VQAScore(QWEN3, params=model, config=cfg, device="cuda",
                          tokenizer=t2v.SimpleT5Tokenizer(cfg.text.vocab_size))
    run = _case_run(lambda: scored_routing(scorer, images=seeded_images(2, 54),
                                           texts=seeded_texts(2, 55)))
    run["experts"] = model.decoder.blocks[0].moe.gate_up.shape[0]
    return run


PARALLEL_CASES = (("tp_chain", par_tp_chain),
                  ("tp_int8_chain", lambda par: par_tp_chain(par, "int8")),
                  ("tp_full", par_tp_full), ("dp", par_dp), ("pp", par_pp),
                  ("sp", par_sp), ("ep", par_ep))


def parallel_rank(rank: int) -> dict:
    """One rank of phase_parallel (a spawned process in the gloo group): every
    case on its mesh, then the bytes this rank staged through the host
    (over the whole phase: warm-up calls too)."""
    from t2v_metrics_tpu_torch.parallel import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.reset_staged()
    out = {}
    for name, fn in PARALLEL_CASES:
        out[name] = fn(True)
        log(f"[parallel] rank {rank}: {name} {out[name]['s']:.2f} s, staged "
            f"{out[name]['staged'] / 2**20:.1f} MiB, "
            f"launches {json.dumps({k: v for k, v in out[name]['counts'].items() if v})}")
    out["staged_bytes"] = comm.STAGED["bytes"]
    return out


def nccl_world1() -> None:
    """``initialize_distributed`` with NCCL on the card, world 1, and one
    all-reduce and one all-gather through parallel/comm.py: the NCCL route
    builds and runs (no host staging). Not a multi-GPU measurement."""
    import socket

    import torch.distributed as dist

    from t2v_metrics_tpu_torch.parallel import comm, mesh as pmesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pmesh.initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        group = dist.group.WORLD
        staged = comm.STAGED["bytes"]
        t = torch.arange(8, dtype=torch.float32, device="cuda")
        comm.all_reduce(t, group)
        gathered = comm.all_gather(t, group)
        torch.cuda.synchronize()
        ok = (torch.equal(t.cpu(), torch.arange(8.0)) and torch.equal(gathered.cpu(), t.cpu())
              and comm.STAGED["bytes"] == staged)
        log(f"[parallel] NCCL world 1 (torch {torch.__version__}, nccl "
            f"{torch.cuda.nccl.version()}): all_reduce and all_gather "
            f"through comm.py {'agree' if ok else 'DISAGREE'}, 0 bytes staged")
        check(ok, "NCCL world 1: the collectives disagree or staged through the host")
    finally:
        dist.destroy_process_group()


def phase_parallel() -> list[dict]:
    """parallel/ on the card: the single-rank references of each case first
    (this process), then the two ranks over gloo (spawned; a rank that fails
    or outlives PARALLEL_TIMEOUT_S fails the run), then NCCL at world 1.
    Returns each rank's launch counts of each case."""
    from t2v_metrics_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    refs = {}
    for name, fn in PARALLEL_CASES:
        if name != "tp_full":
            refs[name] = fn(False)
            free_cuda()
    t1 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PARALLEL_WORLD, backend="gloo",
                      timeout_s=PARALLEL_TIMEOUT_S)
    t2 = time.perf_counter()
    card = card_line()
    tag = f"[parallel] two ranks on one card over gloo ({card})"
    for r, res in enumerate(ranks):
        log(f"{tag}: rank {r} staged {res['staged_bytes'] / 2**20:.1f} MiB through the host")

    def same(name, key="value"):
        vals = [res[name][key] for res in ranks]
        ok = all(np.array_equal(v, vals[0]) for v in vals[1:])
        check(ok, f"parallel {name}: the ranks' results differ")
        return vals[0]

    for name, quant, limit in (("tp_chain", None, CHAIN_TOL_NATS),
                               ("tp_int8_chain", "int8", XXL_INT8_CHAIN_TOL_NATS)):
        got, want = same(name), refs[name]["value"]
        diff = float(np.abs(got - want).max())
        cfg = chain_config(model="clip-flant5-xxl")
        log(f"{tag}: tp 2 xxl {quant or 'bf16'} chain (2 ViT + 2+2 T5): log-probs "
            f"{got.ravel().round(4).tolist()}, one rank {want.ravel().round(4).tolist()}; "
            f"max gap {diff:.4e} nats (limit {limit})")
        check(np.isfinite(got).all() and diff <= limit,
              f"parallel {name}: {diff} nats from one rank")
        if quant:
            for r, res in enumerate(ranks):
                c = res[name]["counts"]
                want_n = tp_int8_launches(cfg)
                check(c["quant_matmul"] == want_n and c["quantize_rows"] == want_n,
                      f"parallel {name} rank {r}: launches {c}, want {want_n} of each int8 kernel")
    from t2v_metrics_tpu_torch.models.clip_flant5 import CLIP_T5_CONFIGS

    chain = clip_t5_launches(chain_config(model="clip-flant5-xxl"), 1)
    lps = CLIP_T5_CONFIGS["clip-flant5-xl"].t5.enc_layers // PARALLEL_WORLD
    stage = dict.fromkeys(KERNELS, 0)
    stage.update(flash_attention_flat=4 * lps, rms_norm=4 * 2 * lps + 1)  # + ln_final
    for name, want in (("tp_chain", chain), ("sp", clip_t5_launches(chain_config(), 1)),
                       ("pp", stage)):
        for r, res in enumerate(ranks):
            check(res[name]["counts"] == want, f"parallel {name} rank {r}: launches "
                  f"{res[name]['counts']}, the code's {want}")
    full = same("tp_full")
    check(np.isfinite(full).all() and (full <= 0).all() and full.shape == (4, 4),
          "parallel tp_full: scores not finite, above 1 or of the wrong shape")
    want = clip_t5_launches(CLIP_T5_CONFIGS["clip-flant5-xxl"], 1)
    for r, res in enumerate(ranks):
        run = res["tp_full"]
        check(run["counts"] == want, f"parallel tp_full rank {r}: launches {run['counts']}, "
              f"the code's {want}")
        log(f"{tag}: tp 2 xxl bf16 whole, 4 x 4 pairs: rank {r} {run['s']:.3f} s, "
            f"{16 / run['s']:.2f} pairs/s (two ranks sharing one card, not a multi-GPU "
            f"rate); device peak {run['peak'] / 2**30:.2f} GiB against its parameters "
            f"{run['estimate'] / 2**30:.2f} GiB (abstract_sharded_params); staged "
            f"{run['staged'] / 2**20:.1f} MiB; launches {json.dumps(run['counts'])}")
    log(f"{tag}: tp 2 xxl scores {np.exp(full).ravel().round(5).tolist()} (bitwise equal "
        "on both ranks)")

    got, want = same("dp"), refs["dp"]["value"]
    check(got.shape == (8, 1, 4) and np.array_equal(got, want),
          "parallel dp: the ranks' scores are not bitwise one rank's batch_forward")
    cfg_xl = CLIP_T5_CONFIGS["clip-flant5-xl"]
    for r, res in enumerate(ranks):
        check(res["dp"]["counts"] == clip_t5_launches(cfg_xl, 1),
              f"parallel dp rank {r}: launches {res['dp']['counts']}")
    log(f"{tag}: dp 2 xl, 32 pairs split by image (16 a rank): bitwise equal to one rank's "
        f"batch_forward of the same two chunks; rank 0 {ranks[0]['dp']['s']:.2f} s, one rank "
        f"{refs['dp']['s']:.2f} s for both chunks")

    got, want = same("pp"), refs["pp"]["value"]
    bitwise = bool(np.array_equal(got, want))
    as_f = [torch.from_numpy(v).view(torch.bfloat16).float() for v in (got, want)]
    rms = float(as_f[1].square().mean().sqrt())
    gap = float((as_f[0] - as_f[1]).abs().max())
    log(f"{tag}: pp 2 xl encoder (12 + 12 layers, 4 microbatches of 4 x 640): bitwise "
        f"equal to one rank's encode of each microbatch: {bitwise}; max gap {gap:.3e} "
        f"({gap / rms:.3e} of the rms {rms:.3e}); stages hold "
        f"{[res['pp']['layers'] for res in ranks]} layers; rank 0 {ranks[0]['pp']['s']:.2f} s")
    check(bitwise or gap <= PIPELINE_TOL_RMS * rms, f"parallel pp: gap {gap} against rms {rms}")

    got, want = same("sp"), refs["sp"]["value"]
    diff = float(np.abs(got - want).max())
    log(f"{tag}: sp 2 xl chain (320 of 640 encoder rows a rank): max gap {diff:.4e} nats "
        f"(limit {CHAIN_TOL_NATS})")
    check(np.isfinite(got).all() and diff <= CHAIN_TOL_NATS, f"parallel sp: {diff} nats")

    (got, sets), (want, want_sets) = ranks[0]["ep"]["value"], refs["ep"]["value"]
    check(all(np.array_equal(res["ep"]["value"][0], got) and res["ep"]["value"][1] == sets
              for res in ranks), "parallel ep: the ranks' results differ")
    check([res["ep"]["experts"] for res in ranks] == [64] * PARALLEL_WORLD,
          "parallel ep: a rank does not hold 64 experts")
    for r, res in enumerate(ranks):
        check(res["ep"]["counts"]["grouped_gemm"] == 2 * qwen3_chain_config().text.layers,
              f"parallel ep rank {r}: {res['ep']['counts']['grouped_gemm']} grouped GEMMs")
    for i, (g, w) in enumerate(zip(got.ravel(), want.ravel())):
        alike = sets[i] == want_sets[i]
        limit = QWEN3_CHAIN_TOL_NATS if alike else QWEN3_STEP_TOL_NATS
        log(f"{tag}: ep 2 qwen3-vl-30b-a3b (2 ViT + 2 decoder layers, 64 experts a rank) "
            f"pair {i}: {g:.4f} vs one rank {w:.4f} nats, routed "
            f"{'alike' if alike else 'apart'} (limit {limit})")
        check(np.isfinite(g) and abs(g - w) <= limit, f"parallel ep pair {i}: {abs(g - w)}")
    for r, res in enumerate(ranks):
        log(f"{tag}: rank {r} launches by case: " + json.dumps(
            {name: {k: v for k, v in res[name]["counts"].items() if v}
             for name, _ in PARALLEL_CASES}))
    nccl_world1()
    log(f"{tag}: references {t1 - t0:.1f} s, ranks {t2 - t1:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s")
    return [res[name]["counts"] for res in ranks for name, _ in PARALLEL_CASES]


# by a substring of the lowered kernel name: the row norms are
# row_norm::row_norm_kernel<row_norm::RmsNorm, ...> and <row_norm::LayerNorm, ...>
KERNEL_FAMILIES = (("quant_matmul", ("quant_matmul_kernel",)),
                   ("quantize_rows", ("quant_rows_kernel",)),
                   ("grouped_gemm", ("grouped_gemm_kernel",)),
                   ("attention", ("attention_kernel",)),
                   ("rope", ("rope_kernel",)),
                   ("rms_norm", ("rmsnorm",)),
                   ("layer_norm", ("layernorm",)),
                   ("gemm", ("gemm", "nvjet", "cutlass", "xmma")))


def kernel_family(name: str) -> str:
    name = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES
                 if any(k in name for k in keys)), "other")


def phase_profile(run, label: str) -> tuple[float, float]:
    """Device time of one call of ``run`` by kernel family (torch.profiler,
    device events only), and the device's busy share: the summed device time
    over the wall time of the same call run without the profiler. Returns
    (device ms, unprofiled wall ms)."""
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
    return total, wall_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batch_forward of each slice (and the "
                         "Qwen and Gemma forwards at 1024x1024) with torch.profiler and "
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
    with stage("build"):
        phase_build()
    if not args.kernels_only:
        import shutil

        # first, while the host holds nothing large: its RSS growth is the load's;
        # then GenAI-Bench through the CLI from the same checkpoint as a hub snapshot
        with stage("checkpoint"):
            checkpoint_counts, hub_cache = phase_checkpoint()
            free_cuda()
        with stage("genai_bench"):
            try:
                genai_counts = phase_genai_bench(hub_cache, profile=args.profile)
            finally:
                shutil.rmtree(hub_cache, ignore_errors=True)
            free_cuda()
    with stage("kernels"):
        results = phase_kernels()
    if args.kernels_only:
        return 0
    free_cuda()
    with stage("chains"):
        for chain in (lambda: phase_chain(chain_config()),
                      lambda: phase_inkernel_chain(chain_config()),
                      lambda: phase_qwen_chain(qwen_chain_config()),
                      lambda: phase_qwen_chain(qwen_chain_config(), video=True),
                      lambda: phase_qwen3_chain(qwen3_chain_config()),
                      lambda: phase_qwen3_chain(qwen3_chain_config(), video=True),
                      lambda: phase_gemma_chain(gemma_chain_config()),
                      lambda: phase_gemma_chain(gemma_chain_config(untied_head=True), m=1,
                                                video=True),
                      lambda: phase_xxl_chain(chain_config(model="clip-flant5-xxl")),
                      phase_scorer_chains,
                      *(lambda model=model: phase_family_chain(model)
                        for model in (PALIGEMMA, GEMMA4, GEMMA4_31B, LLAVA, INSTRUCTBLIP)),
                      *(lambda model=model: phase_new_family_chain(model)
                        for model in (INTERNVL, INTERNVL_38B, INTERNVL_MOE, MOLMO2)),
                      lambda: phase_omni_chain(omni_chain_config()),
                      phase_talker_chain):
            chain()
            free_cuda()
    # each slice's model is dropped on return and freed before the next
    with stage("slice xl"):
        slice_counts = [checkpoint_counts, *genai_counts,
                        *phase_slice(profile=args.profile, generate=32,
                                     media_checks=True)[0]]
        free_cuda()
    for run in (phase_qwen_slice, phase_qwen3_slice, phase_gemma_slice):
        with stage(run.__name__.removeprefix("phase_").replace("_", " ")):
            slice_counts.extend(run(profile=args.profile))   # the image and the video half
            free_cuda()
    bf16_rows = None
    with stage("slices xxl"):
        for quant in (None, "int8", "int8+vit"):
            counts, rows = phase_slice("clip-flant5-xxl", quant=quant, profile=args.profile,
                                       bf16_rows=bf16_rows,
                                       generate=8 if quant == "int8" else 0)
            slice_counts.extend(counts)
            bf16_rows = rows if quant is None else bf16_rows
            free_cuda()
    with stage("slices clip, itm"):
        for kind in ("clip", "itm"):
            slice_counts.append(phase_scorer_slice(kind, profile=args.profile))
            free_cuda()
    with stage("slices of the families"):
        for model in (PALIGEMMA, GEMMA4, LLAVA, INSTRUCTBLIP):
            slice_counts.extend(phase_family_slice(model, profile=args.profile))
            free_cuda()
        for model in (INTERNVL, MOLMO2):
            slice_counts.extend(phase_new_family_slice(model, profile=args.profile))
            free_cuda()
    with stage("slices omni, talker"):
        slice_counts.extend(phase_omni_slice(profile=args.profile))
        free_cuda()
        slice_counts.extend(phase_talker_slice(profile=args.profile))
        free_cuda()
    with stage("parallel"):
        slice_counts.extend(phase_parallel())
        free_cuda()
    log_stages()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{"name": name, "route": route, "source": src, "replaces": rep,
              "launches": sum(c[name] for c in slice_counts),
              **{k: results[name][k] for k in keys},
              **{k: results[name][k] for k in ("sites",) if k in results[name]}}
             for name, (route, src, rep) in KERNELS.items()]
    for row in table:
        check(row["launches"] > 0, f"{row['name']} was never launched on the main paths")
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
