#!/usr/bin/env python3
"""Time the PyTorch port's row norms and rotary embedding at their sites,
for an A/B comparison of two checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/torch_norm_ab.py --label L

Imports ``t2v_metrics_tpu_torch`` from the checkout on PYTHONPATH (else the
current directory) and runs that checkout's kernels, built from its own
sources. Prints one JSON line: the label, the package's path, the card's
name and power limit, for each site the median CUDA-event milliseconds of
20 runs after 3 warm-ups with the 20th and 80th percentiles beside it
(``scripts/torch_attention_ab.py``'s ``cuda_ms``), and the registers and
spill bytes ptxas reported for the row-norm instantiation each site
launches and for all of them together; at a decode step's sites also the
median host milliseconds to enqueue one call, the card idle before each.

Sites, bf16. LayerNorm, M = 4 images: the CLIP ViT-L ln_pre (M*577, 1024)
and ln1/ln2 (M*640, 1024), the Qwen3-VL ViT and SigLIP-896 blocks
(M*4096, 1152), the Qwen3-VL deepstack merger (M*1024, 4608) and the
InternViT-6B projector (10*256, 12800); at each shape the residual add with
the LayerNorm of its sum. RMSNorm: qwen2.5-vl-7b's prefill (20480, 3584)
and decode step (4, 3584), the T5-xl and -xxl encoders (20480, 2048 /
4096), InternViT-6B (10250, 3200); alone and with the residual add. A
checkout without a fused add entry runs its eager ``x + r`` followed by its
norm (the pair the fused entry replaces). The rotary embedding: rope alone
at qwen2.5-vl-7b's prefill (16, 1280, 32 of 36 x 128 heads) and decode
step (4, 1, the same heads), and the decoders' qk-norm with rope at
internvl3.5-8b's prefill (16, 2688, 32 + 8 of 48 x 128), a qwen3-vl-30b-a3b
decode step (4, 1, 32 + 4 of 40 x 128) and the Qwen3-Omni talker's
prefill (1, 1184, 16 + 2 of 20 x 64): ``rms_norm_rope_pack`` where the
checkout has it, else its in-place qk-norm followed by its rope. Beside
them, as yardsticks of what the card moves in one launch and as a control
of the runs' spread (the same PyTorch calls in every run): ``copy_`` of a
norm's bytes (one read and one write of the rows) and the eager ``x + r``.
Compare two checkouts in one call, in turns: parent, change, change,
parent. Needs one NVIDIA GPU, torch, and nvcc and triton as the checkout
needs.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_attention_ab import cuda_ms  # noqa: E402

SITES = ((4 * 577, 1024), (4 * 640, 1024), (4 * 4096, 1152), (4 * 1024, 4608),
         (10 * 256, 12800))
RMS_SITES = ((20480, 3584), (4, 3584), (20480, 2048), (20480, 4096), (10250, 3200))
# (label, batch, rows, heads in the packed row, q heads, k heads, d); k
# heads 0: rope alone over the q heads
ROPE_SITES = (("rope qwen2.5-vl-7b prefill", 16, 1280, 36, 32, 0, 128),
              ("rope qwen2.5-vl-7b decode", 4, 1, 36, 32, 0, 128),
              ("qk-norm + rope internvl3.5-8b prefill", 16, 2688, 48, 32, 8, 128),
              ("qk-norm + rope qwen3-vl-30b-a3b decode", 4, 1, 40, 32, 4, 128),
              ("qk-norm + rope Qwen3-Omni talker prefill", 1, 1184, 20, 16, 2, 64))
TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}


def instantiation(mangled: str) -> str:
    """``<norm>_kernel<bf16,V,NV,ADD>`` from a mangled kernel name: the row
    norms' shared template (row_norm_kernel<LayerNorm | RmsNorm, ...>) or
    the earlier layer_norm_kernel."""
    m = re.search(r"row_norm_kernelINS_\d+(LayerNorm|RmsNorm)E(\w+?)Li(\d+)ELi(\d+)ELb([01])E",
                  mangled)
    if m:
        kind = "layer_norm" if m.group(1) == "LayerNorm" else "rms_norm"
        return (f"{kind}_kernel<{TYPES.get(m.group(2), m.group(2))},{m.group(3)},"
                f"{m.group(4)},{m.group(5)}>")
    m = re.search(r"layer_norm_kernelI(\w+?)Li(\d+)ELi(\d+)ELb([01])E", mangled)
    return (f"layer_norm_kernel<{TYPES.get(m.group(1), m.group(1))},{m.group(2)},"
            f"{m.group(3)},{m.group(4)}>") if m else mangled


def host_ms(fn, n: int = 20) -> float:
    """Median host milliseconds to enqueue one call of ``fn``, the card idle
    before each (``chip_smoke.py:host_ms``): the wrappers' checks, plans and
    launches, what bounds a decode step."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return round(statistics.median(times) * 1e3, 5)


def plan_of(N, dev, rms, rows, d, add, has_bias):
    """The checkout's launch plan of one norm site, or None where it has
    none (a Triton norm)."""
    if not hasattr(N, "layer_norm_plan") or (rms and not hasattr(N, "add_rms_norm_fused")):
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(N, "_blocks_per_sm"):
        occ = functools.partial(N._blocks_per_sm, dev.index or 0, rms, 0, add, d, has_bias)
    else:
        occ = functools.partial(N._ln_blocks_per_sm, dev.index or 0, 0, add, d, has_bias)
    return N.layer_norm_plan(rows, d, 2, sms, occ)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_ab: no CUDA device", file=sys.stderr)
        return 1
    import t2v_metrics_tpu_torch as pkg
    from t2v_metrics_tpu_torch import build
    from t2v_metrics_tpu_torch.ops import norms as N
    from t2v_metrics_tpu_torch.ops import rope as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def time_ms(fn):
        return cuda_ms(fn, digits=7)

    ln_add = getattr(N, "add_layer_norm_fused", None)
    rms_add = getattr(N, "add_rms_norm_fused", None)
    ms, plans, host = {}, {}, {}
    for rows, d in SITES:
        x, r, w, b = randn(rows, d, std=3.0), randn(rows, d, std=3.0), randn(d), randn(d)
        ms[f"LN ({rows}, {d})"] = time_ms(lambda: N.layer_norm_fused(x, w, b))  # noqa: B023
        pair = (lambda: ln_add(x, r, w, b)) if ln_add else (  # noqa: B023
            lambda: N.layer_norm_fused(x + r, w, b))  # noqa: B023
        ms[f"add + LN ({rows}, {d}), " + ("fused" if ln_add else "eager add, then LN")] = \
            time_ms(pair)
        y = torch.empty_like(x)
        ms[f"yardstick copy_ ({rows}, {d})"] = time_ms(lambda: y.copy_(x))  # noqa: B023
        ms[f"yardstick x + r ({rows}, {d})"] = time_ms(lambda: x + r)  # noqa: B023
        for add in (False, True):
            plans[f"{'add + LN' if add else 'LN'} ({rows}, {d})"] = (
                "layer_norm", add, plan_of(N, dev, False, rows, d, add, True))
        del x, r, y
    for rows, d in RMS_SITES:
        x, r, w = randn(rows, d, std=3.0), randn(rows, d, std=3.0), randn(d)
        ms[f"RMSNorm ({rows}, {d})"] = time_ms(lambda: N.rms_norm_fused(x, w))  # noqa: B023
        pair = (lambda: rms_add(x, r, w)) if rms_add else (  # noqa: B023
            lambda: N.rms_norm_fused(x + r, w))  # noqa: B023
        label = f"add + RMSNorm ({rows}, {d}), " + ("fused" if rms_add else "eager add, then RMSNorm")
        ms[label] = time_ms(pair)
        if rows < 16:       # a decode step's rows: the host's enqueue too
            host[f"RMSNorm ({rows}, {d})"] = host_ms(lambda: N.rms_norm_fused(x, w))  # noqa: B023
            host[label] = host_ms(pair)
        y = torch.empty_like(x)
        ms[f"yardstick copy_ ({rows}, {d})"] = time_ms(lambda: y.copy_(x))  # noqa: B023
        for add in (False, True):
            plans[f"{'add + RMSNorm' if add else 'RMSNorm'} ({rows}, {d})"] = (
                "rms_norm", add, plan_of(N, dev, True, rows, d, add, False))
        del x, r, y
    fused = getattr(R, "rms_norm_rope_pack", None)
    for label, b, s, heads, hq, hk, d in ROPE_SITES:
        pk, qs, ks = randn(b, s, heads * d, std=3.0), randn(d), randn(d)
        ang = (torch.randint(0, 4096, (b, s, 1), generator=gen, device=dev).float()
               * torch.rand(d, generator=gen, device=dev))
        cos, sin = torch.cos(ang), torch.sin(ang)
        if not hk:
            key = f"{label} ({b}, {s}, {heads * d}) {hq} heads of {d}"
            fn = functools.partial(R.rope_pack, pk, cos, sin, hq, d)
        elif fused:
            key = f"{label} ({b}, {s}, {heads * d}) {hq}+{hk} heads of {d}, fused"
            fn = functools.partial(fused, pk, qs, ks, cos, sin, hq, hk, d)
        else:
            key = f"{label} ({b}, {s}, {heads * d}) {hq}+{hk} heads of {d}, qk-norm then rope"
            fn = functools.partial(lambda p, q, k: R.rope_pack(N.rms_norm_heads_fused(
                p, q, k, hq, hk, d), cos, sin, hq + hk, d), pk, qs, ks)  # noqa: B023
        ms[key] = time_ms(fn)
        if s == 1:
            host[key] = host_ms(fn)
        del pk, fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    usage = {}
    for lib in ("layer_norm", "rms_norm"):
        usage.update({instantiation(k): v for k, v in build.ptxas_usage(lib).items()})
    ptxas = {}
    for label, (kind, add, p) in plans.items():
        if p is None:
            continue
        name = f"{kind}_kernel<bf16,{p.vec},{p.nv_cap},{int(add)}>"
        ptxas[label] = {"kernel": name, "registers_spill_st_ld": usage.get(name),
                        "plan": [p.warps_per_row, p.vec, p.nv, p.rows_per_block, p.grid]}
    if usage:
        ptxas["all"] = {"kernels": len(usage),
                        "registers": [min(u[0] for u in usage.values()),
                                      max(u[0] for u in usage.values())],
                        "spill_bytes": sum(u[1] + u[2] for u in usage.values())}
    print(json.dumps({"label": args.label, "package": pkg.__file__, "card": card,
                      "ptxas": ptxas, "ms": ms, "host_ms": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
