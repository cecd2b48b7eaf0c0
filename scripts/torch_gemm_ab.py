#!/usr/bin/env python3
"""Time the PyTorch port's two GEMM kernels (the MoE grouped GEMM and the
W8A8 int8 GEMM) at their sites, for an A/B comparison of two checkouts on
one card.

    PYTHONPATH=<checkout> python3 scripts/torch_gemm_ab.py --label L

Imports ``t2v_metrics_tpu_torch`` from the checkout on PYTHONPATH (else the
current directory), builds that checkout's ``csrc/grouped_gemm.cu`` and
``csrc/quant_matmul.cu`` from its own sources, and prints one JSON line: the
label, the package's path, the card's name and power limit, the registers
and spills ptxas reported for each kernel, a digest of each kernel's
machine code (instruction count, opcode hash, HGMMA / UTMALDG / HMMA /
IMMA / IGMMA counts; ``scripts/torch_attention_ab.py``'s ``sass_digest``),
and for each site the median CUDA-event milliseconds of 20 runs after 3 warm-ups with
the 20th and 80th percentiles beside it (that script's ``cuda_ms``).

Sites: the Qwen3-VL-30B-A3B grouped GEMM of a 4 x 4 call at 1024x1024
(16 x 1024 tokens, 128 experts), gate_up (P, 2048) x (128, 2048, 1536) and
down (P, 768) x (128, 768, 2048), under a seeded top-8 routing and a skew
where experts 5 and 77 take every assignment, each over every row block
("all blocks", the only call a checkout without ``num_blocks`` has) and,
where the checkout has it, with ``num_blocks`` as the dispatch calls it;
and the clip-flant5-xxl int8 products at 32 pairs: the four encoder shapes
(rows 32 x 640), three decoder shapes (rows 32 x 4, and 25 x 4) and the
three ViT-L shapes of ``int8+vit`` (rows 4 x 640). Compare two checkouts
in one call, in turns: parent, change, change, parent. Needs one NVIDIA
GPU, nvcc and torch.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_attention_ab import cuda_ms, sass_digest  # noqa: E402

INT8_SITES = (("T5 encoder q|k|v", 32 * 640, 4096, 12288),
              ("T5 encoder o", 32 * 640, 4096, 4096),
              ("T5 encoder wi_0|wi_1", 32 * 640, 4096, 20480),
              ("T5 encoder wo", 32 * 640, 10240, 4096),
              ("T5 decoder q|k|v", 32 * 4, 4096, 12288),
              ("T5 decoder wo", 32 * 4, 10240, 4096),
              ("T5 decoder o, 25 pairs", 25 * 4, 4096, 4096),
              ("ViT-L q|k|v", 4 * 640, 1024, 3072),
              ("ViT-L fc1", 4 * 640, 1024, 4096),
              ("ViT-L fc2", 4 * 640, 4096, 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    import t2v_metrics_tpu_torch as pkg
    from t2v_metrics_tpu_torch import build
    from t2v_metrics_tpu_torch.ops import moe as M
    from t2v_metrics_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    ms = {}
    has_num_blocks = "num_blocks" in inspect.signature(M.grouped_matmul).parameters
    tokens = 16 * 1024
    routings = {"top-8": torch.randn((tokens, 128), generator=gen, device=dev).topk(8)
                .indices.reshape(-1),
                "skewed": torch.tensor([5, 77], device=dev).repeat(tokens * 4)}
    weights = {"gate_up": randn(128, 2048, 1536, std=2048 ** -0.5),
               "down": randn(128, 768, 2048, std=768 ** -0.5)}
    for routing, ids in routings.items():
        _, _, be, p = M.plan_groups(ids, 128, M.BLOCK_M)
        counts = torch.bincount(ids, minlength=128)
        used = ((counts + 127) // 128).sum().int().reshape(1)
        for wname, w in weights.items():
            xg = randn(p, w.shape[1])
            k, n = w.shape[1:]
            site = f"grouped {wname} ({p}, {k}) x (128, {k}, {n}) {routing}"
            ms[f"{site}, all blocks"] = cuda_ms(lambda: M.grouped_matmul(xg, w, be))  # noqa: B023
            if has_num_blocks:
                ms[f"{site}, num_blocks {int(used)} of {p // 128}"] = cuda_ms(
                    lambda: M.grouped_matmul(xg, w, be, M.BLOCK_M, used))  # noqa: B023
            del xg
    del weights, routings
    torch.cuda.empty_cache()

    for label, m, k, n in INT8_SITES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w_qt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand((m, 1), generator=gen, device=dev) * 1e-2
        ws = torch.rand((n,), generator=gen, device=dev) * 1e-2
        ms[f"int8 ({m}, {k}) x ({k}, {n}) {label}"] = cuda_ms(
            lambda: Q.quant_matmul(x_q, w_qt.t(), xs, ws))  # noqa: B023
        del x_q, w_qt
        torch.cuda.empty_cache()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    ptxas, sass = {}, {}
    for lib in ("grouped_gemm", "quant_matmul"):
        ptxas[lib] = [line.strip() for line in build.build_log(lib).splitlines()
                      if "registers" in line or "spill stores" in line or "C75" in line]
        libs = sorted(Path(pkg.__file__).parent.joinpath("_build").glob(f"lib{lib}_*.so"),
                      key=lambda f: f.stat().st_mtime)
        sass[lib] = sass_digest(libs[-1]) if libs else {"error": "no library built"}
    print(json.dumps({"label": args.label, "package": pkg.__file__, "card": card,
                      "ptxas": ptxas, "sass": sass, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
