"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped): the sound port is correct, each fault a scoring cell can have
is caught, the control fails the limit, and a config, a mix, a metric and a
limit added as files in another directory are found by name."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest

from h100bench import faults, run

SEED = 2**31 + 12345   # larger than 32 signed bits hold, as the driver's are


def _run(bench_dir, workload, fault=None, trace=False, control=None):
    bench, path = bench_dir
    return run.run_cell(bench, workload, SEED, 0.3, trace, device="cpu", root=Path("/"),
                        bench_dir=path, fault=fault, control=control)


@pytest.mark.parametrize("workload", ["tiny.image", "tiny.call", "qtiny.image"])
def test_sound_run_is_correct(tiny_bench, workload):
    result, lines = _run(tiny_bench, workload)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["logp_gap_nats"]["value"] < 1e-4
    assert result["checks"]["logp_mean_gap_nats"]["value"] < 1e-4
    assert list(result)[-1] == "checks"
    assert [line.split()[1] for line in lines] == ["logp_gap_nats", "logp_mean_gap_nats",
                                                   "failed_pairs"]
    e2e = {"tiny.image": "pairs_per_s", "tiny.call": "call_p95_ms",
           "qtiny.image": "pairs_per_s"}[workload]
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


@pytest.mark.parametrize("workload", ["tiny.image", "tiny.call", "qtiny.image"])
@pytest.mark.parametrize("how,number", [("answer", "logp_gap_nats"),
                                        ("half", "logp_mean_gap_nats")])
def test_fault_is_caught(tiny_bench, workload, how, number):
    """Each fault fails the number that catches it at the cells' size too:
    one altered answer the widest gap, half the batch left out the mean."""
    result, _ = _run(tiny_bench, workload, fault=faults.breaker(how))
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


@pytest.mark.parametrize("workload", ["tiny.image", "tiny.call", "qtiny.image"])
def test_controls_fail_the_limit(tiny_bench, workload):
    """The reference at fp8 is not correct by the limit the float32 port
    passes with room."""
    sound, lines = _run(tiny_bench, workload, control="fp8")
    for number in ("logp_gap_nats", "logp_mean_gap_nats"):
        value = sound["checks"]["control." + number]["value"]
        assert any(line.startswith("check control." + number) for line in lines)
        limit = sound["checks"][number]["limit"]
        assert sound["checks"][number]["value"] < limit / 3 < limit * 3 < value


@pytest.mark.parametrize("workload,metrics", [
    ("tiny.image", {"adapter_host_ms_per_pair", "mfu.pairs"}),
    ("qtiny.image", {"mfu.pairs"})])
def test_traced_run_reports_the_cells_per_layer_metrics(tiny_bench, workload, metrics):
    """Each cell reports its per-layer metrics and no other: Qwen's async
    call holds no host-only stage, so it has no host-stage span."""
    result, _ = _run(tiny_bench, workload, trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == metrics
    assert result["device"]["window_s"] > 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_files_added_are_found_by_name(tiny_bench):
    """A new config, mix, metric and limit are files only: no edit of the
    harness."""
    bench, path = tiny_bench
    cfg = json.loads((path / "configs" / "tiny.json").read_text())
    cfg["t5"] = dict(cfg["t5"])
    (path / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = json.loads((path / "traffic" / "tiny-call.json").read_text())
    mix["media_per_call"] = 2
    (path / "traffic" / "tiny-pair.json").write_text(json.dumps(mix))
    (path / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.call_seconds))\n")
    (path / "limits" / "tiny2.pair.json").write_text('{"logp_gap_nats": 1e-3}')
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [{"name": "tiny2",
                                            "file": str(path / "configs" / "tiny2.json")}]
    bench["workloads"] = bench["workloads"] + [
        {"name": "tiny2.pair", "config": "tiny2", "traffic": "tiny-pair", "chips": 1}]
    bench["end_to_end"] = bench["end_to_end"] + [
        {"name": "calls_seen", "unit": "calls", "workloads": ["tiny2.pair"]}]
    result, _ = _run((bench, path), "tiny2.pair")
    assert result["correct"] is True
    assert result["metrics"]["calls_seen"]["value"] * 2 == result["attempted"]
