#!/usr/bin/env python3
"""Time the PyTorch port's two attention kernels at their attention sites,
for an A/B comparison of two checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/torch_attention_ab.py --label L

Imports ``t2v_metrics_tpu_torch`` from the checkout on PYTHONPATH (else the
current directory), builds that checkout's flat (``csrc/flash_flat.cu``)
and per-head (``csrc/flash_attention.cu``) attention kernels from its own
sources, and prints one JSON line: the label, the package's path, the
card's name and power limit, the registers and spills ptxas reported for
each instantiation, a digest of each instantiation's machine code (its
instruction count, a hash of its opcode sequence, from ``cuobjdump -sass``,
and its counts of wgmma (HGMMA; IGMMA for int8), TMA load (UTMALDG) and
mma.sync (HMMA; IMMA for int8) instructions: two checkouts whose hashes match run the same
instructions), and for each site the median CUDA-event milliseconds of 20 runs after 3
warm-ups with the 20th and 80th percentiles beside it (the run's own
spread). Compare two checkouts in one call, in turns: parent, change,
change, parent. Needs one NVIDIA GPU, nvcc and torch.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch


def cuda_ms(fn, warmup=3, iters=20, digits=5) -> list[float]:
    """[median, 20th percentile, 80th percentile] of ``iters`` timed runs,
    rounded to ``digits`` decimals."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)     # the card stays busy while fn enqueues
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return [round(statistics.median(times), digits), round(times[iters // 5], digits),
            round(times[(4 * iters) // 5], digits)]


def sass_digest(lib: Path) -> dict:
    """{"attention_kernel<D,flags...>": [instructions, opcode hash, HGMMA,
    UTMALDG, HMMA, IMMA, IGMMA]} of every kernel in ``lib``, from
    ``cuobjdump -sass`` (next to nvcc). IGMMA is the int8 wgmma."""
    from t2v_metrics_tpu_torch.build import _nvcc

    tool = Path(_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return {"error": res.stderr.strip()[:300]}
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"([a-z_]+_kernel)I(.*?)EEv", mangled)
            args = re.findall(r"L[ib](\d+)E", (m.group(2) + "E") if m else "")
            plain = re.search(r"\d([a-z_]*_kernel[a-z_]*)E", mangled)   # not a template
            name = (f"{m.group(1)}<{','.join(args)}>" if m
                    else plain.group(1) if plain else mangled)
            funcs[name] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", line)
        if name is not None and ins:
            tokens = ins.group(1).split()
            funcs[name].append(tokens[1] if tokens[0].startswith("@") else tokens[0])
    digest = {}
    for k, ops in sorted(funcs.items()):
        base = Counter(op.split(".")[0] for op in ops)
        digest[k] = [len(ops), hashlib.sha1(" ".join(ops).encode()).hexdigest()[:12],
                     base["HGMMA"], base["UTMALDG"], base["HMMA"], base["IMMA"],
                     base["IGMMA"]]
    return digest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    import t2v_metrics_tpu_torch as pkg
    from t2v_metrics_tpu_torch import build
    from t2v_metrics_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def lengths(b, s, lo):
        lens = torch.randint(lo, s + 1, (b,), generator=gen, device=dev)
        return torch.arange(s, device=dev)[None] < lens[:, None]

    def image_block(b, s, start):
        ids = torch.full((b, s), -1, dtype=torch.int32, device=dev)
        ids[:, start:start + 256] = 0
        return ids

    ar = torch.arange(5120, device=dev)
    flat = {   # packed (B, S, lanes) projection, heads, keywords
        "T5 encoder (32, 640, 3*2048) d=64, bias, kv_mask":
            (randn(32, 640, 3 * 2048), 32,
             dict(bias=randn(1, 32, 640, 640).float(), kv_mask=lengths(32, 640, 590),
                  scale=1.0)),
        "Qwen ViT windowed (1, 5120, 3*1280) d=80, 64-row segments":
            (randn(1, 5120, 3 * 1280), 16, dict(segment_ids=(ar // 64)[None].int())),
        "Qwen ViT full (1, 5120, 3*1280) d=80, segment 0 / -1 pads":
            (randn(1, 5120, 3 * 1280), 16,
             dict(segment_ids=torch.where(ar < 4900, 0, -1)[None].int())),
        "Qwen3 ViT (4, 4096, 3*1152) d=72, segment 0 / -1 pads":
            (randn(4, 4096, 3 * 1152), 16,
             dict(segment_ids=torch.where(ar[:4096] < 3844, 0, -1).int().expand(4, 4096))),
        "Qwen decoder prefill (16, 1280, 36*128) d=128, GQA 28/4, causal, kv_mask":
            (randn(16, 1280, 36 * 128), 28,
             dict(kv_heads=4, causal=True, kv_mask=lengths(16, 1280, 1200))),
        "Gemma prefill (16, 512, 16*256) d=256, GQA 8/4, window 1024, bidir, kv_mask":
            (randn(16, 512, 16 * 256), 8,
             dict(kv_heads=4, causal=True, scale=256 ** -0.5, local_window=1024,
                  bidir_ids=image_block(16, 512, 4), kv_mask=lengths(16, 512, 285))),
        "Gemma prefill (2, 2048, 16*256) d=256, window 1024 bites, bidir at 1500":
            (randn(2, 2048, 16 * 256), 8,
             dict(kv_heads=4, causal=True, scale=256 ** -0.5, local_window=1024,
                  bidir_ids=image_block(2, 2048, 1500), kv_mask=lengths(2, 2048, 2000))),
        "T5 decoder self (32, 4, 3*2048) d=64, bias, causal":
            (randn(32, 4, 3 * 2048), 32,
             dict(bias=randn(1, 32, 4, 4).float(), causal=True, scale=1.0)),
    }
    ms = {}
    for label, (qkv, heads, kw) in flat.items():
        ms[label] = cuda_ms(lambda: A.flash_attention_flat_packed(qkv, heads, **kw))  # noqa: B023
    q, k, v = randn(32, 4, 2048), randn(32, 640, 2048), randn(32, 640, 2048)
    cross = dict(kv_mask=lengths(32, 640, 590), scale=1.0)
    ms["T5 cross q (32, 4, 2048) k/v (32, 640, 2048) d=64, kv_mask"] = cuda_ms(
        lambda: A.flash_attention_flat(q, k, v, 32, **cross))
    del flat, q, k, v
    torch.cuda.empty_cache()

    per_head = {}
    q, k, v = A.packed_heads(randn(16, 4096, 3 * 16 * 72), 16)
    per_head["SigLIP-896 per-head (16, 16, 4096, 72), views of the packed projection"] = (
        (q, k, v), {})
    rel = randn(32, 32, dtype=torch.float32) * 3
    for label, (b, s), bidi in (("T5 encoder (32, 32, 640, 64), T5 bias in the kernel, "
                                 "kv_mask", (32, 640), True),
                                ("T5 decoder (32, 32, 4, 64), T5 bias in the kernel, "
                                 "causal", (32, 4), False)):
        kw = dict(scale=1.0, rel_bias=rel, rel_cfg=(bidi, 32, 128, 0))
        kw.update(kv_mask=lengths(b, s, 590)) if bidi else kw.update(causal=True)
        per_head[label] = (A.packed_heads(randn(b, s, 3 * 32 * 64), 32), kw)
    for label, (qkv3, kw) in per_head.items():
        ms[label] = cuda_ms(lambda: A.flash_attention(*qkv3, **kw))  # noqa: B023

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    ptxas, sass = {}, {}
    for lib in ("flash_flat", "flash_attention"):
        ptxas[lib] = [line.strip() for line in build.build_log(lib).splitlines()
                      if "registers" in line or "spill stores" in line]
        libs = sorted(Path(pkg.__file__).parent.joinpath("_build").glob(f"lib{lib}_*.so"),
                      key=lambda f: f.stat().st_mtime)
        sass[lib] = sass_digest(libs[-1]) if libs else {"error": "no library built"}
    print(json.dumps({"label": args.label, "package": pkg.__file__, "card": card,
                      "ptxas": ptxas, "sass": sass, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
