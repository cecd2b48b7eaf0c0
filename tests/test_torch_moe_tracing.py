"""The MoE routing counters (``ops/moe.py:_count_routing``) and the Qwen
adapters' spans, on the CPU: the counters of a hand-made routing against
what its expert groups imply, nothing counted without a profiler session,
the device totals (``tracing.count_device``) kept on the device until
``tracing.counts()`` reads them; and a profiled ``batch_forward`` of
``qwen3-vl-moe-test`` with the sorted dispatch, whose span tree, copies and
counters the benchmark's readers (``moe_pad_share``, ``moe_load_max``,
``host_only_ms``, ``syncs_per_pair``) read.
"""

import dataclasses
import math
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from h100bench import run  # noqa: E402
from t2v_metrics_tpu_torch import tracing  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.ops import moe as tmoe  # noqa: E402

BENCH = Path(run.__file__).resolve().parent
MOE = ("moe_rows", "moe_mean_rows", "moe_block_rows", "moe_max_rows")
E, K, D = 5, 2, 8


def _routed(tokens: int, seed: int = 0):
    """A MoE layer of E experts and x (3, tokens / 3, D) whose router sends
    token t to two chosen experts, skewed towards expert 0: (params, cfg,
    x, the (T, K) assignments)."""
    cfg = dataclasses.replace(
        tdec.DecoderConfig(vocab_size=64, d_model=D, layers=1, heads=2, kv_heads=1,
                           head_dim=4, d_ff=0, mrope_section=None, qkv_bias=False),
        num_experts=E, experts_per_tok=K, moe_d_ff=16, moe_dispatch=True)
    rng = np.random.default_rng(seed)
    chosen = np.stack([rng.choice(E, K, replace=False, p=[0.4, 0.25, 0.15, 0.12, 0.08])
                       for _ in range(tokens)])
    x = np.zeros((tokens, D), np.float32)
    x[np.arange(tokens), chosen[:, 0]] = 3.0          # the first choice, then the second
    x[np.arange(tokens), chosen[:, 1]] = 2.0
    p = tdec.MoE(cfg, "cpu", torch.float32)
    with torch.no_grad():
        p.router.w.zero_()
        p.router.w[:E, :E] = 4.0 * torch.eye(E)
        p.gate_up.copy_(torch.from_numpy(rng.standard_normal(p.gate_up.shape) * 0.1))
        p.down.copy_(torch.from_numpy(rng.standard_normal(p.down.shape) * 0.1))
    return p, cfg, torch.from_numpy(x).reshape(3, tokens // 3, D), chosen


def _session(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.counts()


@pytest.mark.parametrize("tokens", [300, 30])
def test_routing_counters_equal_the_plan(tokens):
    """One traced dispatch counts its T*k assignments, T*k / E in
    hundredths, the rows the grouped GEMM computes (each expert's group
    rounded up to 128 rows, as ``plan_groups`` lays them out) and the
    largest group."""
    p, cfg, x, chosen = _routed(tokens)
    groups = np.bincount(chosen.reshape(-1), minlength=E)
    out, got = _session(lambda: tmoe.moe_mlp_dispatch(p, cfg, x))
    assert torch.isfinite(out).all()
    want_blocks = sum(-(-int(c) // tmoe.BLOCK_M) for c in groups) * tmoe.BLOCK_M
    assert {k: got[k] for k in MOE} == {
        "moe_rows": tokens * K, "moe_mean_rows": round(100 * tokens * K / E),
        "moe_block_rows": want_blocks, "moe_max_rows": int(groups.max())}
    # the plan lays the groups out in exactly those rows, the pad blocks after
    _, dest, _, rows = tmoe.plan_groups(torch.from_numpy(chosen.reshape(-1)), E, tmoe.BLOCK_M)
    assert int(dest.max()) < want_blocks < rows


def test_routing_counters_are_absent_without_a_session():
    """No profiler, no count: the totals and the newest session's counts are
    as they were, and no device total is made."""
    p, cfg, x, _ = _routed(30)
    _session(lambda: None)
    before, totals = tracing.counts(), tracing.totals()
    tmoe.moe_mlp_dispatch(p, cfg, x)
    tracing.count_device("moe_max_rows", torch.tensor(7))
    assert tracing.counts() == before == {}
    assert {k: v for k, v in tracing.totals().items() if k.startswith("moe_")} == \
        {k: v for k, v in totals.items() if k.startswith("moe_")}


def test_device_totals_stay_tensors_until_read():
    """``count_device`` adds into one int64 tensor a name, inside and
    outside inference mode, and ``counts()`` turns the totals into ints."""
    def work():
        tracing.count_device("t", torch.tensor([3], dtype=torch.int32))
        with torch.inference_mode():
            tracing.count_device("t", torch.tensor(4))
        tracing.count_device("t", torch.tensor(5, dtype=torch.int64))
        return tracing._session.device["t"]

    total, got = _session(work)
    assert total.dtype == torch.int64 and total.shape == () and not total.is_inference()
    assert got["t"] == 12 and isinstance(got["t"], int)


@pytest.fixture(scope="module")
def moe_scorer():
    cfg = tq3.resolve_config("qwen3-vl-moe-test")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, moe_dispatch=True))
    return tt2v.VQAScore("qwen3-vl-moe-test", config=cfg, device="cpu"), cfg


def test_traced_qwen_batch_forward_spans_and_counters(moe_scorer):
    """A profiled ``batch_forward`` of two chunks through the async path:
    the engine spans the CLIP-FlanT5 engine uses, each chunk's one blocking
    copy (the read-back), and routing counters that fit the sequences the
    decoder ran: every MoE layer of every chunk counts its P x S rows."""
    scorer, cfg = moe_scorer
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (90, 76, 3), dtype=np.uint8) for _ in range(3)]
    texts = ["a cube", "two red dogs on a table", "a horse", "the sky"]
    data = [{"images": [images[i % 3]], "texts": [texts[i]]} for i in range(4)]
    scorer.batch_forward(data, batch_size=2)                    # warm
    (out, got) = _session(lambda: scorer.batch_forward(data, batch_size=2))
    spans = tracing.records()
    names = {s.name for s in spans}
    assert {"facade.batch", "engine.decode", "engine.tokenize", "engine.encode",
            "engine.score", "engine.h2d", "engine.d2h"} <= names
    assert got["host_syncs"] == 2                                # one read-back a chunk
    # the decoder ran P pairs x S (the sequence bucket) rows a chunk, k each
    ids = [scorer.model._prepare_pairs([images[i % 3] for i in (lo, lo + 1)],
                                       [texts[lo], texts[lo + 1]])[0][0]
           for lo in (0, 2)]
    t = cfg.text
    rows = sum(a.size for a in ids) * t.experts_per_tok * t.layers
    assert got["moe_rows"] == rows
    assert got["moe_mean_rows"] == 100 * rows // t.num_experts   # T*k / 4 is exact
    assert got["moe_rows"] <= got["moe_block_rows"] and got["moe_block_rows"] % 128 == 0
    assert got["moe_max_rows"] * t.num_experts >= rows
    ctx = types.SimpleNamespace(pairs=4)
    read = {m: run.load_reader(BENCH, m)(ctx) for m in (
        "moe_pad_share", "moe_load_max", "host_only_ms.pairs", "syncs_per_pair.pairs")}
    assert read["moe_pad_share"] == pytest.approx(
        100.0 * (1 - got["moe_rows"] / got["moe_block_rows"]))
    assert 1.0 <= read["moe_load_max"] <= t.num_experts
    assert math.isfinite(read["host_only_ms.pairs"]) and read["host_only_ms.pairs"] > 0
    assert read["syncs_per_pair.pairs"] == 0.5
    assert np.isfinite(out).all()


def test_moe_readers_report_nothing_without_counters():
    """A program without the MoE counters (a parent checkout's, or a dense
    model's session) gives the two readers nothing to read."""
    _session(lambda: tracing.count("host_syncs"))
    ctx = types.SimpleNamespace(pairs=4)
    for m in ("moe_pad_share", "moe_load_max"):
        assert run.load_reader(BENCH, m)(ctx) is None
