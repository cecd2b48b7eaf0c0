#!/usr/bin/env python3
"""Time the PyTorch port's LayerNorm at its sites, for an A/B comparison of
two checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/torch_norm_ab.py --label L

Imports ``t2v_metrics_tpu_torch`` from the checkout on PYTHONPATH (else the
current directory) and runs that checkout's LayerNorm: its Triton kernel,
or ``csrc/layer_norm.cu`` built from its own sources where it has one.
Prints one JSON line: the label, the package's path, the card's name and
power limit, for each site the median CUDA-event milliseconds of 20 runs
after 3 warm-ups with the 20th and 80th percentiles beside it
(``scripts/torch_attention_ab.py``'s ``cuda_ms``), and, for a checkout with
``csrc/layer_norm.cu``, the registers and spill bytes ptxas reported for the
instantiation each site launches and for all of them together.

Sites, bf16, M = 4 images: the CLIP ViT-L ln_pre (M*577, 1024) and ln1/ln2
(M*640, 1024), the Qwen3-VL ViT and SigLIP-896 blocks (M*4096, 1152) and
the Qwen3-VL deepstack merger (M*1024, 4608); and at each shape the
residual add with the LayerNorm of its sum: ``add_layer_norm_fused`` where
the checkout has it, else its eager ``x + r`` followed by its
``layer_norm_fused`` (the pair the fused entry replaces). Beside them, as
yardsticks of what the card moves in one launch and as a control of the
runs' spread (the same PyTorch calls in every run): ``copy_`` of the
LayerNorm's bytes (one read and one write of the rows) and the eager
``x + r``. Compare two checkouts in one call, in turns: parent, change,
change, parent. Needs one
NVIDIA GPU, torch, and nvcc or triton as the checkout needs.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_attention_ab import cuda_ms  # noqa: E402

SITES = ((4 * 577, 1024), (4 * 640, 1024), (4 * 4096, 1152), (4 * 1024, 4608))
TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}


def instantiation(mangled: str) -> str:
    """``layer_norm_kernel<bf16,V,NV,ADD>`` from a mangled kernel name."""
    m = re.search(r"layer_norm_kernelI(\w+?)Li(\d+)ELi(\d+)ELb([01])E", mangled)
    return (f"layer_norm_kernel<{TYPES.get(m.group(1), m.group(1))},{m.group(2)},"
            f"{m.group(3)},{m.group(4)}>") if m else mangled


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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    fused = getattr(N, "add_layer_norm_fused", None)
    ms, plans = {}, {}
    for rows, d in SITES:
        x, r, w, b = randn(rows, d, std=3.0), randn(rows, d, std=3.0), randn(d), randn(d)
        ms[f"LN ({rows}, {d})"] = cuda_ms(lambda: N.layer_norm_fused(x, w, b), digits=7)  # noqa: B023
        pair = (lambda: fused(x, r, w, b)) if fused else (  # noqa: B023
            lambda: N.layer_norm_fused(x + r, w, b))  # noqa: B023
        ms[f"add + LN ({rows}, {d}), " + ("fused" if fused else "eager add, then LN")] = \
            cuda_ms(pair, digits=7)
        y = torch.empty_like(x)
        ms[f"yardstick copy_ ({rows}, {d})"] = cuda_ms(lambda: y.copy_(x), digits=7)  # noqa: B023
        ms[f"yardstick x + r ({rows}, {d})"] = cuda_ms(lambda: x + r, digits=7)  # noqa: B023
        if hasattr(N, "layer_norm_plan"):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plans[(rows, d)] = {add: N.layer_norm_plan(
                rows, d, 2, sms,
                functools.partial(N._ln_blocks_per_sm, dev.index or 0, 0, add, d, True))
                for add in (False, True)}
        del x, r, y

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    ptxas = {}
    if plans:
        usage = {instantiation(k): v for k, v in build.ptxas_usage("layer_norm").items()}
        for (rows, d), by_add in plans.items():
            for add, p in by_add.items():
                name = f"layer_norm_kernel<bf16,{p.vec},{p.nv_cap},{int(add)}>"
                ptxas[f"{'add + LN' if add else 'LN'} ({rows}, {d})"] = {
                    "kernel": name, "registers_spill_st_ld": usage.get(name),
                    "plan": [p.warps_per_row, p.vec, p.nv, p.rows_per_block, p.grid]}
        ptxas["all"] = {"kernels": len(usage),
                        "registers": [min(u[0] for u in usage.values()),
                                      max(u[0] for u in usage.values())],
                        "spill_bytes": sum(u[1] + u[2] for u in usage.values())}
    print(json.dumps({"label": args.label, "package": pkg.__file__, "card": card,
                      "ptxas": ptxas, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
