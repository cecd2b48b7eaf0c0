"""Run one cell of the benchmark once and print its result line.

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run makes the cell's inputs from the seed, builds the port's scorer with
the benchmark's weights on the card, warms up the cell's shapes, measures
for ``--seconds`` (with ``--trace 1``: a profiled window of whole units, for
the per-layer metrics), frees the port, recomputes a sample of the window's
scores with the plain float32 reference, and prints one JSON line as the
last line of standard output. Everything that belongs to one configuration,
mix or metric is found by name: ``BENCHMARK.json`` at the root,
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``limits/<cell>.json``, and the family's ``families/<family>.py`` and
``reference/<family>.py``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "t2v_metrics_tpu")
TRACE_SECONDS = 10.0


def environment() -> None:
    """Keep libraries from loading JAX, the progress bars quiet, and every
    kernel cache at a fixed path inside the checkout."""
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"
    os.environ.setdefault("TQDM_DISABLE", "1")
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / "_cache" / "torch_extensions")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def load_reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, key: str, workload: str) -> list[dict]:
    """The metrics of ``bench[key]`` this cell reports."""
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def gaps(got, ref) -> dict:
    """The numbers compared with the reference's log scores: the widest gap
    and the mean gap over the sample, in nats (NaN where a score is not
    finite)."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    if not np.all(np.isfinite(d)):
        return {"logp_gap_nats": float("nan"), "logp_mean_gap_nats": float("nan")}
    return {"logp_gap_nats": float(d.max()), "logp_mean_gap_nats": float(d.mean())}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, bench_dir: Path = BENCH,
             control: str | None = None, fault=None, min_units: int = 1,
             ref_cache: dict | None = None) -> tuple[dict, list[str]]:
    """One run of a cell: (the result object, the lines of compared numbers).

    For the readings that set a limit (``control.py``) and for tests:
    ``control`` also recomputes the sample with the reference at that
    precision and reports its gaps; ``min_units`` the least units a window
    runs; ``ref_cache`` keeps the reference's scores of a sample across runs
    of one seed; ``fault`` is given the built scorer, and may break it
    (``faults.py``)."""
    import numpy as np
    import torch

    from . import trace as tr
    from . import traffic

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    spec = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    family = importlib.import_module(f"h100bench.families.{cfg['family']}")
    is_cuda = torch.device(device).type == "cuda"

    inputs = traffic.make_inputs(spec, seed)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    scorer = family.build(cfg, seed, device)
    if fault is not None:
        fault(scorer)
    spans = tr.Spans() if trace else None
    if trace:
        # "prep" is a host-only stage, where the family has one; the drain
        # is the read-back of what the dispatch returns
        if family.HOST_STAGE:
            spans.wrap(scorer.model, family.HOST_STAGE, "prep")
        spans.wrap(scorer.model, family.DISPATCH, "dispatch", drain=True)
    driver = traffic.Driver(scorer, inputs, family.media_input, span=spans)
    driver.warmup()
    _sync(device)
    setup_s = time.perf_counter() - T_START

    reduced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if is_cuda else [])
        spans.reset()
        with profile(activities=activities) as prof:
            with record_function(tr.WINDOW):
                window = driver.window(min(seconds, TRACE_SECONDS), min_units=min_units)
                _sync(device)
        reduced = tr.reduce(prof)
        del prof
    else:
        window = driver.window(seconds, min_units=min_units)
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    kind = torch.cuda.get_device_name(0) if is_cuda else "cpu"

    batch = spec.get("batch_size") if spec["driver"] == "batch_forward" else None
    hw = (spec["media"]["height"], spec["media"]["width"])
    work = [item for mi, prompts in window.chunks(batch)
            for item in family.chunk_work(cfg, len(set(mi)),
                                          [inputs.prompts[p] for p in prompts], hw)]
    pairs = window.pairs
    del driver, scorer
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    # correctness: the window's sample against the plain reference
    sample = traffic.check_sample(inputs, window, seed)
    idx = [(m, p) for m, p, _ in sample]
    key = (seed, tuple(idx))
    if ref_cache is not None and key in ref_cache:
        ref = ref_cache[key]
    else:
        ref = family.log_scores(cfg, seed, inputs.media, inputs.prompts, idx, device)
        if ref_cache is not None:
            ref_cache[key] = ref
    with np.errstate(divide="ignore", invalid="ignore"):
        got = np.log(np.asarray([s for *_, s in sample], np.float64))
    failed = sum(1 for *_, s in pairs if not np.isfinite(s))
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    readings = gaps(got, ref)
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in readings.items() if name in limits}
    checks["failed_pairs"] = {"value": failed, "limit": 0}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if control is not None:
        ctl = family.log_scores(cfg, seed, inputs.media, inputs.prompts, idx, device, control)
        for name, value in gaps(ctl, ref).items():
            checks["control." + name] = {"value": value, "limit": limits.get(name)}

    ctx = types.SimpleNamespace(
        pairs=len(pairs), seconds=window.seconds, setup_s=setup_s,
        call_seconds=[u[3] for u in window.units], work=work,
        window_s=None, busy_s=None, family_s={}, spans_s={})
    if reduced is not None:
        ctx.window_s, ctx.busy_s, ctx.family_s = reduced.window_s, reduced.busy_s, reduced.family_s
        ctx.spans_s = dict(spans.seconds)
    metrics = {}
    for m in cell_metrics(bench, "per_layer" if trace else "end_to_end", workload):
        value = load_reader(bench_dir, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": kind,
           "count": cell.get("chips", 1), "memory_peak_bytes": int(peak)}
    if reduced is not None:
        dev["busy_s"], dev["window_s"] = reduced.busy_s, reduced.window_s
    result = {"correct": correct, "attempted": len(pairs), "failed": failed,
              "metrics": metrics, "device": dev}
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced.device_ops,
                               "idle_gaps": reduced.idle_gaps}
    result["gaps"] = readings
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
