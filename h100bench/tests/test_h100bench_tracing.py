"""The per-layer metrics read from the program's own tracing, on the tiny
clip cells traced on the CPU: each is reported and finite, the counts repeat
across two runs of one seed, and the host stage and copies they time fit
inside the benchmark's own spans around the host stage and the dispatch. A
program without the tracing module reports none of them and raises
nothing."""

from __future__ import annotations

import json
import math
import sys
import types
from pathlib import Path

import pytest

from h100bench import run

SEED = 2**31 + 4242
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NEW = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"][-8:]
CELLS = {"tiny.image": "clip-flant5-xxl.genai-image", "tiny.call": "clip-flant5-xxl.rerank8"}
# the benchmark's own spans around the host stage and the dispatch, in ms a pair
STAGES = ("def read(ctx):\n"
          "    s = ctx.spans_s\n"
          "    return (s.get('prep', 0.0) + s.get('dispatch', 0.0)) * 1e3 / ctx.pairs\n")


@pytest.fixture
def traced_bench(tiny_bench):
    """The tiny benchmark with the eight program-trace metrics on its clip
    cells (as in BENCHMARK.json, the genai-image ones on the batch cell and
    the rerank ones on the call cell) and a reader of the benchmark's own
    stage spans."""
    bench, path = tiny_bench
    (path / "metrics" / "stage_ms.py").write_text(STAGES)
    per_layer = list(bench["per_layer"]) + [
        {"name": m["name"], "unit": m["unit"],
         "workloads": [t for t, c in CELLS.items() if c in m["workloads"]]} for m in NEW]
    per_layer.append({"name": "stage_ms", "unit": "ms/pair", "workloads": ["tiny.image"]})
    return dict(bench, per_layer=per_layer), path


def _traced(bench_dir, workload):
    bench, path = bench_dir
    result, _ = run.run_cell(bench, workload, SEED, 0.3, True, device="cpu",
                             root=Path("/"), bench_dir=path)
    assert result["correct"] is True
    return {k: v["value"] for k, v in result["metrics"].items()}


def test_the_new_entries_keep_to_their_cells():
    assert [m["name"] for m in NEW] == [
        "host_only_ms.pairs", "host_only_ms.rerank", "h2d_ms.pairs", "h2d_ms.rerank",
        "syncs_per_pair.pairs", "syncs_per_pair.rerank", "prep_wait_ms.pairs",
        "enc_pad_share.pairs"]
    for m in NEW:
        assert m["source"] == "host_clock" and m["better"] == "lower"
        suffix = m["name"].rsplit(".", 1)[1]
        assert m["workloads"] == [CELLS["tiny.image" if suffix == "pairs" else "tiny.call"]]


@pytest.mark.parametrize("workload", ["tiny.image", "tiny.call"])
def test_traced_cells_report_the_program_metrics(traced_bench, workload):
    first, second = _traced(traced_bench, workload), _traced(traced_bench, workload)
    suffix = ".pairs" if workload == "tiny.image" else ".rerank"
    mine = {m["name"] for m in NEW if m["name"].endswith(suffix)}
    assert mine <= set(first)
    assert all(math.isfinite(first[k]) and first[k] >= 0 for k in mine)
    # 16 blocking copies a device stage of the 388x400 images, counted from
    # the code (tests/test_torch_tracing.py): 4 pairs a stage in both cells
    assert first["syncs_per_pair" + suffix] == second["syncs_per_pair" + suffix] == 4.0
    if workload == "tiny.image":
        assert 0.0 < first["enc_pad_share.pairs"] < 100.0
        for got in (first, second):
            assert got["host_only_ms.pairs"] + got["h2d_ms.pairs"] <= got["stage_ms"]
            assert got["prep_wait_ms.pairs"] <= got["stage_ms"]


def test_a_program_without_tracing_reports_nothing(monkeypatch):
    """The readers run over a parent checkout's program too: with no
    tracing module they return None."""
    import t2v_metrics_tpu_torch

    monkeypatch.delattr(t2v_metrics_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "t2v_metrics_tpu_torch.tracing", None)
    ctx = types.SimpleNamespace(pairs=16)
    for m in NEW:
        assert run.load_reader(BENCH, m["name"])(ctx) is None
