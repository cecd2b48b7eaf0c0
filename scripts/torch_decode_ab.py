#!/usr/bin/env python3
"""Time the PyTorch port's decode steps on whole models, for an A/B comparison
of two checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/torch_decode_ab.py --label L

Imports ``t2v_metrics_tpu_torch`` from the checkout on PYTHONPATH (else the
current directory) and builds that checkout's kernels from its own sources.
For each model (random bf16 weights from the registry's seed, whole depth:
clip-flant5-xl, qwen2.5-vl-7b, qwen3-vl-30b-a3b, gemma-3-4b-it) it runs
``generate`` of 4 seeded 1024x1024 images (Gemma: one image, its
per-sequence path) x ``--tokens`` tokens under ``chip_smoke.py:DecodeProbe``
(the cached decoder's ``forward``, T5's ``decode_step``, between a pair of
CUDA events and on the host's clock), and prints one JSON line: the
label, the package's path, the card's name and power limit, and for each
model the steps run, the median ms a decode step on the card (between its
events) and of host enqueue, with the 20th and 80th percentiles, and the
kernel launches a step by kernel. A second pass, after every timed one (so
that no profiler has run in the process while the steps were timed), runs
one decode step of each model under torch.profiler and counts its device
events (kernels, copies, memsets). Decode is host-bound: the step's span on
the card follows its host enqueue. Compare two checkouts in one call, in
turns: parent, change, change, parent. Needs one NVIDIA GPU with 80 GB
(qwen3-vl-30b-a3b is 57.94 GiB of bf16), torch, nvcc and triton.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MODELS = ("clip-flant5-xl", "qwen2.5-vl-7b", "qwen3-vl-30b-a3b", "gemma-3-4b-it")


def quantiles(xs) -> list[float]:
    """[median, 20th percentile, 80th percentile], rounded to 5 decimals."""
    xs = sorted(xs)
    return [round(statistics.median(xs), 5), round(xs[len(xs) // 5], 5),
            round(xs[(4 * len(xs)) // 5], 5)]


def decode_probe():
    """``chip_smoke.py:DecodeProbe``, loaded from this script's checkout by
    its path (the package it wraps is the one on PYTHONPATH), so that the A/B
    and the smoke time the same step."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DecodeProbe


def run(model: str, tokens: int, trace: int = 0, side: int = 1024) -> dict:
    import t2v_metrics_tpu_torch as t2v

    rng = np.random.default_rng(0)
    n = 1 if model.startswith("gemma") else 4
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(n)]
    texts = [f"a photo of thing {i}" for i in range(n)]
    scorer = t2v.VQAScore(model, init="random")
    t5 = model.startswith("clip-flant5")
    scorer.model.generate(images, texts, max_new_tokens=2)        # warm: builds, compiles
    torch.cuda.synchronize()
    with decode_probe()(t5, traced=trace) as probe:
        scorer.model.generate(images, texts, max_new_tokens=tokens)
    del scorer
    gc.collect()
    torch.cuda.empty_cache()
    if trace:
        return {"device_events": probe.device_events}
    steps = probe.calls if t5 else probe.calls[1:]          # the decoder's first call: the prefill
    return {"steps": len(steps),
            "card_ms": quantiles([s.elapsed_time(e) for s, e, _, _ in steps]),
            "host_ms": quantiles([h * 1e3 for _, _, h, _ in steps]),
            "launches": steps[-1][3]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--models", default=",".join(MODELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    import t2v_metrics_tpu_torch as pkg
    from t2v_metrics_tpu_torch import build

    build.build_all()
    models = args.models.split(",")
    out = {m: run(m, args.tokens) for m in models}
    for m in models:                     # the profiler only after every timed pass
        out[m].update(run(m, 4, trace=2))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "package": pkg.__file__, "card": card,
                      "models": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
