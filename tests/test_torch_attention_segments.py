"""The attention kernels' key-tile plan under segment ids
(``ops/attention.py:segment_tile_plan``, the rule of
``csrc/flash_common.cuh`` "Segment ids per key tile"), on the CPU: its
counts at the Qwen3-VL ViT's layout, the plan against a brute-force count of
what the masks keep over sorted and unsorted ids, and the ``attn_seg_*``
counters, which the wrappers add only inside a profiler session and the
benchmark's readers (``attn_seg_skip_share``, ``attn_seg_mask_share``) read.
"""

import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from h100bench import run  # noqa: E402
from t2v_metrics_tpu_torch import tracing  # noqa: E402
from t2v_metrics_tpu_torch.ops import attention as A  # noqa: E402

BENCH = Path(run.__file__).resolve().parent
SEG = ("attn_seg_tiles", "attn_seg_tiles_run", "attn_seg_tiles_mixed", "attn_seg_wg_tiles")


def _cell_ids(b=1):
    """The Qwen3-VL-30B-A3B ViT's ids at 992x992: 3,844 patches of segment 0
    in a 4,096-row bucket, the 252 pad rows under -1."""
    return torch.where(torch.arange(4096) < 3844, 0, -1).int().expand(b, 4096)


def _plan(ids, bq, bk):
    return {k: int(v) for k, v in A.segment_tile_plan(ids, bq, bk).items()}


def test_plan_of_the_qwen3_vit_layout():
    """q tiles 0-29 see key tiles 0-30, q tile 30 all 32, q tile 31 tiles 30
    and 31: 964 of 1,024 pairs an image and head. The compare runs on tile
    30 for the warpgroups of q tiles 0-29 (60), on every tile for q tile
    30's first warpgroup (rows 3840-3903 hold both ids: 32), on tile 30 for
    its second (1: tiles 0-29 are settled as -inf, tile 31 as whole) and on
    tile 30 for both warpgroups of q tile 31 (2): 95 of 1,928."""
    assert _plan(_cell_ids(3), 128, 128) == {
        "attn_seg_tiles": 3 * 1024, "attn_seg_tiles_run": 3 * 964,
        "attn_seg_tiles_mixed": 3 * 95, "attn_seg_wg_tiles": 3 * 1928}


def test_plan_of_windows_visits_the_diagonal_alone():
    """Qwen2.5-style 64-row windows over 1,280 rows: a block of 128 rows
    holds two windows and visits its own key tile only; each warpgroup's
    rows hold one id and the tile two, so every visited pair compares."""
    assert _plan((torch.arange(1280) // 64)[None], 128, 128) == {
        "attn_seg_tiles": 100, "attn_seg_tiles_run": 10, "attn_seg_tiles_mixed": 20,
        "attn_seg_wg_tiles": 20}


def _brute(ids: np.ndarray, bq: int, bk: int):
    """Pair by pair over (S,) ids: for each (block, key tile) whether any
    row shares an id with a key and whether the rule's id ranges meet; for
    each (warpgroup of 64 rows, key tile) what the segment mask keeps ("all",
    "none" or "mixed") and the rule's class ("whole", "none" or "mixed"),
    and whether its block visits the tile."""
    s = ids.shape[0]
    same = ids[:, None] == ids[None, :]
    blocks = [np.arange(q, min(q + bq, s)) for q in range(0, s, bq)]
    tiles = [np.arange(k, min(k + bk, s)) for k in range(0, s, bk)]
    wgs = [np.arange(w, min(w + 64, s)) for w in range(0, s, 64)]

    def meets(r, c):
        return ids[c].min() <= ids[r].max() and ids[c].max() >= ids[r].min()

    def rule_kind(r, c):
        if not meets(r, c):
            return "none"
        return "whole" if ids[r].min() == ids[r].max() == ids[c].min() == ids[c].max() \
            else "mixed"

    def kept(r, c):
        k = same[np.ix_(r, c)]
        return "all" if k.all() else "none" if not k.any() else "mixed"

    any_same = np.array([[same[np.ix_(r, c)].any() for c in tiles] for r in blocks])
    visit = np.array([[meets(r, c) for c in tiles] for r in blocks])
    truth = np.array([[kept(w, c) for c in tiles] for w in wgs])
    rule = np.array([[rule_kind(w, c) for c in tiles] for w in wgs])
    return any_same, visit, truth, rule, np.repeat(visit, bq // 64, axis=0)[:len(wgs)]


@pytest.mark.parametrize("bq,bk", [(128, 128), (128, 64), (64, 64)])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_against_a_brute_force_count(bq, bk, order, seed):
    """Over random ids (runs of 1-150 rows, ids -1..5 or each run its own,
    a ragged length, two batch items): the plan counts exactly the rule's
    pairs, visits every pair that shares an id, and settles a pair as a
    whole only where the mask is; on sorted ids (each id one run, as the
    port's sites lay them out) it is exact: it visits just the pairs that
    share an id and compares just the mixed ones."""
    rng = np.random.default_rng(seed)
    s = int(rng.integers(300, 700))
    vals = rng.integers(-1, 6, 40) if order == "unsorted" else np.arange(40) - 1
    ids = np.repeat(vals, rng.integers(1, 150, 40))[:s].astype(np.int32)
    batch = (ids, ids[::-1].copy() if order == "unsorted" else np.sort(ids[::-1]))
    plan = _plan(torch.from_numpy(np.stack(batch)), bq, bk)
    want = dict.fromkeys(SEG, 0)
    for x in batch:
        any_same, visit, truth, rule, wg_visit = _brute(x, bq, bk)
        want["attn_seg_tiles"] += visit.size
        want["attn_seg_tiles_run"] += int(visit.sum())
        want["attn_seg_tiles_mixed"] += int(((rule == "mixed") & wg_visit).sum())
        want["attn_seg_wg_tiles"] += int(wg_visit.sum())
        assert (visit | ~any_same).all()                 # a tile seen is visited
        assert (truth[rule == "none"] == "none").all()
        assert (truth[rule == "whole"] == "all").all()
        if order == "sorted":
            assert (visit == any_same).all()
            assert ((rule == "mixed") == (truth == "mixed")).all()
    assert plan == want


def _session(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.counts()


def _packed(b, s, h, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, 3 * h * d), generator=g)


def test_counters_inside_a_trace_equal_the_plan_over_heads():
    """A traced flat call with the cell's ids counts the plan of each of its
    heads; at head dim 256 with the kernel's tiles there (128-row blocks of
    64-key tiles); a causal call counts nothing; and the readers turn the
    counts into the two shares."""
    ids = _cell_ids(2)
    qkv = _packed(2, 4096, 2, 8)

    def call():       # inside a span: the readers take a session with spans only
        with tracing.span("facade.call"):
            return A.attention_flat_packed(qkv, 2, segment_ids=ids)

    out, got = _session(call)
    assert torch.isfinite(out).all()
    assert {k: got[k] for k in SEG} == {
        "attn_seg_tiles": 2 * 2 * 1024, "attn_seg_tiles_run": 2 * 2 * 964,
        "attn_seg_tiles_mixed": 2 * 2 * 95, "attn_seg_wg_tiles": 2 * 2 * 1928}
    ctx = types.SimpleNamespace(pairs=2)
    read = {m: run.load_reader(BENCH, m)(ctx) for m in
            ("attn_seg_skip_share", "attn_seg_mask_share")}
    assert read["attn_seg_skip_share"] == pytest.approx(100 * 60 / 1024)
    assert read["attn_seg_mask_share"] == pytest.approx(100 * 95 / 1928)

    seg = (torch.arange(200) // 50)[None]
    _, got = _session(lambda: A.attention_flat_packed(_packed(1, 200, 3, 256), 3,
                                                      segment_ids=seg))
    want = _plan(seg, 128, 64)
    assert {k: got[k] for k in SEG} == {k: 3 * v for k, v in want.items()}
    assert want["attn_seg_tiles"] == 8 and want["attn_seg_tiles_run"] == 6

    _, got = _session(lambda: A.attention_flat_packed(qkv[:, :256], 2, causal=True,
                                                      segment_ids=ids[:, :256]))
    assert not any(k in got for k in SEG)


def test_counters_are_absent_without_a_session():
    """No profiler, no count: the totals and the newest session's counts are
    as they were, and the readers of a session without the counters (a
    parent checkout's) report nothing."""
    _session(lambda: tracing.count("host_syncs"))
    before, totals = tracing.counts(), tracing.totals()
    A.attention_flat_packed(_packed(1, 256, 2, 8), 2, segment_ids=_cell_ids()[:, -256:])
    assert tracing.counts() == before
    assert {k: v for k, v in tracing.totals().items() if k.startswith("attn_seg")} == \
        {k: v for k, v in totals.items() if k.startswith("attn_seg")}
    ctx = types.SimpleNamespace(pairs=2)
    for m in ("attn_seg_skip_share", "attn_seg_mask_share"):
        assert run.load_reader(BENCH, m)(ctx) is None
