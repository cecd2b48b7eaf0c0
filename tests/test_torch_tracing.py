"""The port's tracing (``t2v_metrics_tpu_torch/tracing.py``) on the CPU at
``clip-flant5-test``: spans are off without a profiler (no
``record_function`` call, no record); under ``torch.profiler`` the span tree
of a staged ``batch_forward`` and of a ``forward`` call (names, parents, one
request id across the main and prep threads, every span among the
profiler's events), the copies (non-blocking up, blocking down) and the T5
encoder's rows against hand counts, ``to_device`` on a CPU target, sessions
that hold the newest profiled window alone, and the kernel launch counters
behind ``ops.launch_counts()``.
"""

import collections
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch._C._profiler import _ExperimentalConfig  # noqa: E402

import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu_torch import ops, tracing  # noqa: E402
from t2v_metrics_tpu_torch.engine.scoring import ENC_BUCKETS, TXT_BUCKETS, _bucket  # noqa: E402
from t2v_metrics_tpu_torch.ops import attention, norms  # noqa: E402
from t2v_metrics_tpu_torch.tokenization import splice_image_tokens_t5  # noqa: E402

MODEL = "clip-flant5-test"
BATCH = 4
TEXTS = ["a cube", "two red dogs on a table", "a photo of a horse riding an astronaut",
         "the sky", "one chair next to a lamp in a small room", "a boat"]
# the copies of a device stage of these 400x392 images, counted from the
# code. Up, each through tracing.to_device and counted as h2d_async: the
# pixels; the fill that pads them square and the two passes' weights of the
# Pillow-exact resize (ops/image.py); the CLIP mean and std; the patch
# permutation (models/clip.py); the six text arrays and the two pair-index
# arrays. Down, the one blocking copy, counted as host_syncs: the scores
H2D_A_STAGE = 1 + 1 + 2 + 2 + 1 + 6 + 2
SYNCS_A_STAGE = 1


@pytest.fixture(scope="module")
def scorer():
    return tt2v.VQAScore(MODEL, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)   # over 384 px: the Pillow-exact resize path
    return [rng.integers(0, 256, (400, 392, 3), dtype=np.uint8) for _ in TEXTS]


def _dataset(images):
    return [{"images": [im], "texts": [t]} for im, t in zip(images, TEXTS)]


def _run(kind, scorer, images):
    if kind == "batch_forward":
        return scorer.batch_forward(_dataset(images), batch_size=BATCH)
    return scorer(images=images[:3], texts=[TEXTS[1]])


def _profiled(fn):
    """``fn()`` under a CPU profiler that keeps every thread's ranges."""
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        out = fn()
    return out, prof


def _rows(engine, prompts, pairs_padded):
    """(rows the encoder computes, the real pairs' lengths) of one device
    stage: each prompt's spliced length (its image slot replaced by the
    image tokens), bucketed; pair rows as padded."""
    lens = []
    for p in prompts:
        q, _ = engine._prompts([p], None, None)
        lens.append(len(splice_image_tokens_t5(q[0], engine.tokenizer)) - 1
                    + engine.cfg.num_image_tokens)
    return pairs_padded * _bucket(max(lens), ENC_BUCKETS), sum(lens)


# spans a device stage opens, by kind; the staged pipeline adds its own
STAGE = {"engine.h2d": H2D_A_STAGE, "engine.decode": 2, "engine.encode": 1, "engine.score": 1,
         "engine.d2h": 1}
WANT = {
    "batch_forward": (2, collections.Counter(
        {**{k: 2 * v for k, v in STAGE.items()}, "engine.tokenize": 2, "facade.batch": 1,
         "facade.prep": 2, "facade.prep_wait": 2, "facade.dispatch": 2})),
    "call": (1, collections.Counter({**STAGE, "engine.tokenize": 2, "facade.call": 1})),
}


def test_off_without_a_profiler(scorer, images, monkeypatch):
    """No profiler: no ``record_function`` call and no record, for both
    entry points; the counters still count."""
    def boom(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(tracing._profiler, "record_function", boom)
    monkeypatch.setattr(tracing, "_session", None)
    monkeypatch.setattr(tracing, "_open", False)
    before = tracing.totals().get("host_syncs", 0)
    before_h2d = tracing.totals().get("h2d_async", 0)
    _run("batch_forward", scorer, images)
    _run("call", scorer, images)
    assert tracing.records() == [] and tracing.counts() == {}
    assert tracing.current() is None
    assert tracing.totals()["host_syncs"] - before == 3 * SYNCS_A_STAGE
    assert tracing.totals()["h2d_async"] - before_h2d == 3 * H2D_A_STAGE


@pytest.mark.parametrize("kind", ["batch_forward", "call"])
def test_span_tree_and_counts(scorer, images, kind):
    untraced = _run(kind, scorer, images)
    out, prof = _profiled(lambda: _run(kind, scorer, images))
    np.testing.assert_array_equal(out, untraced)      # tracing changes no score
    spans = tracing.records()
    stages, want = WANT[kind]
    assert collections.Counter(s.name for s in spans) == want
    # every span is in the profiler's trace as a "t2v." range
    events = collections.Counter(e.name[4:] for e in prof.events()
                                 if e.name.startswith("t2v."))
    assert events == want
    by_id = {s.id: s for s in spans}
    root = next(s for s in spans if s.parent == 0)
    assert root.name == ("facade.batch" if kind == "batch_forward" else "facade.call")
    assert {s.request for s in spans} == {root.request} and root.request > 0
    for s in spans:
        if s is root:
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        up = {"engine.encode": {"facade.dispatch", "facade.call"},
              "engine.score": {"facade.dispatch", "facade.call"},
              "engine.h2d": {"engine.score", "engine.encode", "facade.prep",
                             "facade.call"},
              "engine.decode": {"facade.prep", "facade.call"},
              "engine.tokenize": {"facade.prep", "facade.call"},
              "engine.d2h": {root.name}}.get(s.name, {root.name})
        assert parent.name in up, (s.name, parent.name)
    threads = {s.name: s.thread for s in spans}
    if kind == "batch_forward":
        # the host stage on the prep thread, under the main thread's root
        assert threads["facade.prep"] != root.thread
        assert threads["engine.tokenize"] == threads["facade.prep"]
        assert threads["facade.dispatch"] == root.thread
    else:
        assert {s.thread for s in spans} == {root.thread}
    # the counters, by hand: the copies of each device stage; the encoder's
    # rows of each stage's prompts, bucketed
    counts = tracing.counts()
    assert counts["host_syncs"] == stages * SYNCS_A_STAGE
    assert counts["h2d_async"] == stages * H2D_A_STAGE
    engine = scorer.model.engine
    if kind == "batch_forward":
        chunks = [TEXTS[i:i + BATCH] for i in range(0, len(TEXTS), BATCH)]
        parts = [_rows(engine, c, _bucket(len(c), TXT_BUCKETS)) for c in chunks]
    else:
        parts = [_rows(engine, [TEXTS[1]] * 3, 3)]
    assert counts["t5_enc_rows"] == sum(r for r, _ in parts)
    assert counts["t5_enc_rows_valid"] == sum(v for _, v in parts)
    assert 0 < counts["t5_enc_rows_valid"] < counts["t5_enc_rows"]
    # self time: a span's duration less its children's on its thread
    own = tracing.self_ns(spans)
    score = next(s for s in spans if s.name == "engine.score")
    kids = [s for s in spans if s.parent == score.id]
    assert own[score.id] == score.end_ns - score.start_ns - sum(
        k.end_ns - k.start_ns for k in kids)


def test_sessions_hold_the_newest_window(scorer, images):
    """Work before and after a profiled window stays out of its spans and
    counters; the next profiled window starts a session of its own."""
    _run("call", scorer, images)
    _profiled(lambda: _run("call", scorer, images))
    first, first_counts = tracing.records(), tracing.counts()
    _run("batch_forward", scorer, images)                # untraced
    assert tracing.records() == first and tracing.counts() == first_counts
    assert first_counts["host_syncs"] == SYNCS_A_STAGE
    assert first_counts["h2d_async"] == H2D_A_STAGE
    _profiled(lambda: _run("batch_forward", scorer, images))
    second = tracing.records()
    assert {s.name for s in second} >= {"facade.batch", "facade.prep"}
    assert not {s.id for s in second} & {s.id for s in first}
    assert tracing.counts()["host_syncs"] == 2 * SYNCS_A_STAGE
    assert tracing.counts()["h2d_async"] == 2 * H2D_A_STAGE


def test_to_device_on_a_cpu_target():
    """A CPU target takes the plain path: the values as they were, no copy
    where the dtype stays (the result shares the source's memory, a numpy
    array's or a ``host_empty`` tensor's, which is not page-locked there), a
    cast where it changes; each call counted as ``h2d_async`` and none as
    ``host_syncs``."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    buf = tracing.host_empty((2, 3), torch.uint8, "cpu")
    buf.numpy()[:] = 7
    before = tracing.totals()
    got = tracing.to_device(a, "cpu")
    from_buf = tracing.to_device(buf, torch.device("cpu"))
    cast = tracing.to_device(a, "cpu", torch.float32)
    after = tracing.totals()
    np.testing.assert_array_equal(got.numpy(), a)
    assert got.dtype == torch.int32 and np.shares_memory(got.numpy(), a)
    assert from_buf.data_ptr() == buf.data_ptr() and not buf.is_pinned()
    assert cast.dtype == torch.float32 and torch.equal(cast, torch.from_numpy(a).float())
    assert after.get("h2d_async", 0) - before.get("h2d_async", 0) == 3
    assert after.get("host_syncs", 0) == before.get("host_syncs", 0)


def test_sessions_are_cut_at_the_profilers_start_and_stop():
    """A session holds what its own profiler saw: a count after the
    profiler stopped, with no span between, stays out of it, and a profiler
    that starts and stops with no span opens a session of its own."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        with tracing.span("engine.score"):
            tracing.count("test.window")
    assert not tracing.enabled()
    tracing.count("test.window", 5)                      # after the stop
    assert [s.name for s in tracing.records()] == ["engine.score"]
    assert tracing.counts() == {"test.window": 1}
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("test.window", 2)
    assert tracing.records() == [] and tracing.counts() == {"test.window": 2}


def test_launch_counts_through_the_counters(scorer, images, monkeypatch):
    """``ops.launch_counts()`` counts the ``launch.<kernel>`` counters since
    the last reset: a forward with the CPU's plain versions counted as their
    kernels' launches gives the code's count for one clip-flant5 pass (the
    ViT layers run, the encoder, the decoder's self and cross attention;
    LayerNorm twice a ViT layer and ln_pre; RMSNorm twice an encoder and
    three times a decoder layer, and each stack's final norm)."""
    for mod, name, kernel in ((attention, "attention_flat_reference", "flash_attention_flat"),
                              (norms, "layer_norm_plain", "layer_norm"),
                              (norms, "rms_norm_plain", "rms_norm")):
        def counted(*a, _fn=getattr(mod, name), _kernel=kernel, **k):
            tracing.count("launch." + _kernel)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    cfg = scorer.model.engine.cfg
    vit, enc, dec = cfg.vision.layers - 1, cfg.t5.enc_layers, cfg.t5.dec_layers
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(flash_attention_flat=vit + enc + 2 * dec, layer_norm=1 + 2 * vit,
                rms_norm=2 * enc + 1 + 3 * dec + 1)
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    _run("call", scorer, images)
    assert ops.launch_counts() == want
    _run("call", scorer, images)
    assert ops.launch_counts() == {k: 2 * v for k, v in want.items()}
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_counters_lose_no_update_across_threads():
    """Twelve threads counting at once, switching as often as the
    interpreter allows, lose no increment."""
    n, threads = 20000, 12
    before = tracing.totals().get("test.stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.stress")
                                                    for _ in range(n)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.totals()["test.stress"] - before == n * threads
