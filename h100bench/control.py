"""The readings that set a cell's limits: the port's gaps to the reference
and the control's over many seeds, in one process so that set-up is paid
once a seed; with ``--faults``, the gaps of the port broken by each fault of
``faults.py`` at the cell's own size.

    python3 -m h100bench.control --workload <name> --seeds 101-112 \
        [--reference fp8] [--faults answer,half] [--units 1]

For each seed: the port as the configuration states it; the reference
itself at the precision below (``--reference``); the port with each fault
planted. Each window runs ``--units`` whole units (rounds or calls) and no
more, so every run of a seed compares the same sample. One JSON line a
seed, with the spread of the reference's log scores over the sample (their
standard deviation and the distance between the first and third quartiles,
in nats), then for each number the largest sound reading (the lower one)
and the smallest of each control and fault. Runs on the card, as the cell
does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import faults, run


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def spread(values) -> dict:
    """The spread of the reference's log scores over a sample, in nats."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"std": statistics.pstdev(values), "iqr": q3 - q1,
            "min": min(values), "max": max(values)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,2000000001")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--reference", default=None, help="the reference's lower precision")
    ap.add_argument("--faults", default="", help="e.g. answer,half (faults.py)")
    args = ap.parse_args(argv)
    run.environment()
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    import torch

    if not torch.cuda.is_available():
        print("the control readings need a CUDA device", file=sys.stderr)
        return 2
    table = {}
    for seed in _seeds(args.seeds):
        cache = {}
        result, _ = run.run_cell(bench, args.workload, seed, 0.0, False, min_units=args.units,
                                 control=args.reference, ref_cache=cache)
        ref = [float(x) for x in next(iter(cache.values()))]
        line = {"seed": seed, "attempted": result["attempted"], "sound": result["gaps"],
                "reference_logp": spread(ref), "metrics": result["metrics"]}
        table.setdefault("sound", []).append(result["gaps"])
        if args.reference:
            ctl = {k[len("control."):]: v["value"] for k, v in result["checks"].items()
                   if k.startswith("control.")}
            line["reference_" + args.reference] = ctl
            table.setdefault("reference_" + args.reference, []).append(ctl)
        for how in filter(None, args.faults.split(",")):
            res, _ = run.run_cell(bench, args.workload, seed, 0.0, False,
                                  min_units=args.units, fault=faults.breaker(how),
                                  ref_cache=cache)
            line["fault_" + how] = dict(res["gaps"], correct=res["correct"])
            table.setdefault("fault_" + how, []).append(res["gaps"])
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(table["sound"]),
               "kind": torch.cuda.get_device_name(0)}
    for name in table["sound"][0]:
        summary[name] = {"lower": max(r[name] for r in table["sound"])}
        for ctl, rows in table.items():
            if ctl != "sound":
                summary[name][ctl] = min(r[name] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
