"""Port parity: the CameraBench harness of ``t2v_metrics_tpu_torch.camerabench``
against the JAX package's.

  * Stage 1 (binary classification, VQA + retrieval, caption generation)
    with ``qwen2.5-vl-test`` on the JAX parameters (carried by ``bridge.py``;
    the scorers of ``tests/test_torch_trace.py``, whose tokenizer spells
    generated ids) over seeded FFV1 clips, which every reader decodes to the
    same frames: scores within 1e-5 and their logs within 1e-4 nats (fp32,
    two CPU BLAS libraries), caption strings equal;
  * Stage 2 (the binary and VQA / retrieval evaluations) and the caption
    metrics on canned files: equal to JAX's (the binary metrics are the
    port's numpy AP / ROC-AUC against sklearn's; 1e-12);
  * the port's narrowed catches: a missing or unreadable clip is recorded
    as an error with score 0.0, while a RuntimeError of the scorer stops the
    run (the JAX loops record any exception).
"""

import json
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from test_torch_trace import _write_clip, scorers  # noqa: E402
from t2v_metrics_tpu.camerabench import binary_classification_evaluation as j_bce  # noqa: E402
from t2v_metrics_tpu.camerabench import binary_classification_vlm_scores as j_bcs  # noqa: E402
from t2v_metrics_tpu.camerabench import caption_evaluation as j_ce  # noqa: E402
from t2v_metrics_tpu.camerabench import caption_generation as j_cg  # noqa: E402
from t2v_metrics_tpu.camerabench import vqa_and_retrieval_evaluation as j_vre  # noqa: E402
from t2v_metrics_tpu.camerabench import vqa_and_retrieval_vlm_scores as j_vrs  # noqa: E402
from t2v_metrics_tpu_torch.camerabench import (  # noqa: E402
    binary_classification_evaluation as t_bce, binary_classification_vlm_scores as t_bcs,
    caption_evaluation as t_ce, caption_generation as t_cg,
    vqa_and_retrieval_evaluation as t_vre, vqa_and_retrieval_vlm_scores as t_vrs)

MODEL = "qwen2.5-vl-test"
SCORE_TOL = 1e-5
LOG_TOL = 1e-4      # nats, the image tests' bar
STATS_TOL = 1e-12


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    _write_clip(d / "pan.avi", 48, 64, n=12, seed=0)
    _write_clip(d / "zoom.avi", 48, 64, n=10, seed=1)
    (d / "broken.avi").write_bytes(b"not a video at all")
    return str(d)


def _stage1_binary(module, scorer, video_dir):
    data = [{"image": "pan.avi", "question": "Does the camera pan left?", "label": "Yes"},
            {"image": "zoom.avi", "question": "Does it zoom in?", "label": "No"},
            {"image": "missing.avi", "question": "Does it zoom?", "label": "No"},
            {"image": "broken.avi", "question": "Does it tilt?", "label": "Yes"}]
    return module.generate_vqa_scores(data, MODEL, video_dir, scorer=scorer)


def test_binary_stage1_matches_jax(videos, tmp_path):
    j, t = scorers(MODEL)
    want, got = _stage1_binary(j_bcs, j, videos), _stage1_binary(t_bcs, t, videos)
    for g, w in zip(got, want):
        assert {k: g[k] for k in g if k not in ("score", "error")} == \
            {k: w[k] for k in w if k not in ("score", "error")}
        assert (g["error"] is None) == (w["error"] is None)
        np.testing.assert_allclose(g["score"], w["score"], atol=SCORE_TOL, rtol=0)
    assert got[0]["error"] is None and 0.0 < got[0]["score"] < 1.0
    assert got[2]["error"] == want[2]["error"] == \
        f"Video file not found: {videos}/missing.avi"
    assert got[3]["error"] is not None and got[3]["score"] == 0.0    # unreadable: recorded
    np.testing.assert_allclose(np.log([got[0]["score"], got[1]["score"]]),
                               np.log([want[0]["score"], want[1]["score"]]),
                               atol=LOG_TOL, rtol=0)
    assert abs(np.log(got[0]["score"] / got[1]["score"])) > 100 * LOG_TOL
    meta = {"model_name": MODEL, "split_name": "split"}
    for module, res, name in ((j_bcs, want, "j"), (t_bcs, got, "t")):
        module.save_scores(res, tmp_path / f"classification_scores_{name}.json", meta)
    ev = [m.evaluate_single_file(str(tmp_path / f"classification_scores_{n}.json"), quiet=True)
          for m, n in ((j_bce, "j"), (t_bce, "t"))]
    assert ev[1]["num_samples"] == ev[0]["num_samples"] == 2
    assert t_bcs.generate_output_filename("a/b", "c:d", "s") == \
        j_bcs.generate_output_filename("a/b", "c:d", "s")


def test_vqa_retrieval_stage1_matches_jax(videos):
    j, t = scorers(MODEL)
    samples = [{"pos_video": "pan.avi", "neg_video": "zoom.avi",
                "pos_question": "Does the camera pan?", "neg_question": "Does it zoom?"},
               {"pos_video": "zoom.avi", "neg_video": "missing.avi",
                "pos_text": "zooms", "neg_text": "pans"},
               {"pos_video": "broken.avi", "neg_video": "pan.avi",
                "pos_question": "a", "neg_question": "b"}]
    want = j_vrs.generate_vqa_retrieval_scores(samples, j, videos, "{} Yes or no?", "m")
    got = t_vrs.generate_vqa_retrieval_scores(samples, t, videos, "{} Yes or no?", "m")
    for g, w in zip(got, want):
        assert (g["error"] is None) == (w["error"] is None)
        for key in ("yes_scores", "no_scores"):
            assert list(g[key]) == list(w[key])
            np.testing.assert_allclose(list(g[key].values()), list(w[key].values()),
                                       atol=SCORE_TOL, rtol=0)
    assert got[1]["error"] == want[1]["error"]
    assert got[2]["error"] is not None and set(got[2]["yes_scores"].values()) == {0.0}
    assert t_vrs.generate_output_filename("m", None, "a b") == \
        j_vrs.generate_output_filename("m", None, "a b")


def test_vqa_retrieval_load_by_skill_matches_jax(tmp_path):
    for skill in ("camera_motion", "steady"):
        (tmp_path / skill).mkdir()
        for task in ("pan_left", "zoom"):
            with open(tmp_path / skill / f"{task}.jsonl", "w") as f:
                f.write(json.dumps({"pos_video": "a", "neg_video": "b"}) + "\n\n")
    for specific in (None, "camera motion", "absent"):
        want = j_vrs.load_data_by_skill(tmp_path, specific)
        got = t_vrs.load_data_by_skill(tmp_path, specific)
        assert {k: dict(v) for k, v in got.items()} == {k: dict(v) for k, v in want.items()}


# what a kernel or the device raises: a CUDA fault, a failed build, a kernel
# wrapper refusing its operands or the device, a kernel library that does not
# load (ctypes' OSError)
KERNEL_ERRORS = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc failed (1)"),
    ValueError("flash_attention_flat: q is not 16-byte aligned"),
    ValueError("layer_norm: no kernel for device cuda:0"),
    OSError("libflash_flat.so: cannot open shared object file"),
]


class _Raises:
    """A scorer whose every call, and its model's ``generate``, raises
    ``error``."""

    def __init__(self, error):
        self.error = error
        self.model = types.SimpleNamespace(generate=self)

    def __call__(self, *a, **k):
        raise self.error


@pytest.mark.parametrize("error", KERNEL_ERRORS, ids=lambda e: str(e).split(":")[0])
def test_torch_errors_propagate_media_errors_are_recorded(videos, monkeypatch, error):
    """The port's three Stage-1 loops let any error but a reader's
    ``MediaError`` through (the JAX loops record it as a 0.0 score); a
    missing clip is still recorded without a scorer call."""
    match = re.escape(str(error))
    with pytest.raises(type(error), match=match):
        _stage1_binary(t_bcs, _Raises(error), videos)
    recorded = _stage1_binary(j_bcs, _Raises(error), videos)   # the JAX loop records it
    assert recorded[0]["error"] == str(error) and recorded[0]["score"] == 0.0
    with pytest.raises(type(error), match=match):
        t_vrs.generate_vqa_retrieval_scores(
            [{"pos_video": "pan.avi", "neg_video": "zoom.avi", "pos_question": "a",
              "neg_question": "b"}], _Raises(error), videos)
    only_missing = t_bcs.generate_vqa_scores(
        [{"image": "missing.avi", "question": "q", "label": "No"}], MODEL, videos,
        scorer=_Raises(error))
    assert only_missing[0]["score"] == 0.0 and "not found" in only_missing[0]["error"]
    monkeypatch.setattr(t_cg, "t2v", types.SimpleNamespace(VQAScore=lambda **kw: _Raises(error)))
    with pytest.raises(type(error), match=match):
        t_cg.generate_captions([{"video": "pan.avi", "caption": "x"}], MODEL, videos)


def test_unreadable_media_raise_media_error(videos, tmp_path):
    """The readers raise ``MediaError`` for bad media, and the loops record
    it: an unopenable clip, a clip with no readable frame, an image Pillow
    cannot read."""
    from t2v_metrics_tpu_torch.engine.scoring import _load_uint8
    from t2v_metrics_tpu_torch.media.video import MediaError, extract_frames

    with pytest.raises(MediaError, match="cannot open video"):
        extract_frames(f"{videos}/broken.avi", 4)
    (tmp_path / "bad.png").write_bytes(b"not an image")
    with pytest.raises(MediaError, match="cannot read image"):
        _load_uint8(str(tmp_path / "bad.png"))
    assert issubclass(MediaError, OSError) and issubclass(MediaError, ValueError)

    class _Unreadable:
        def __call__(self, *a, **k):
            raise MediaError("no readable frame in video x")

    got = _stage1_binary(t_bcs, _Unreadable(), videos)
    assert [g["score"] for g in got] == [0.0] * 4
    assert got[0]["error"] == "no readable frame in video x"


def test_caption_generation_matches_jax(videos, monkeypatch):
    """Strings equal (greedy; the tokenizer spells ids); the chunk with an
    unreadable clip is retried one sample at a time on both sides."""
    j, t = scorers(MODEL)
    monkeypatch.setattr(j_cg, "t2v", types.SimpleNamespace(VQAScore=lambda **kw: j))
    monkeypatch.setattr(t_cg, "t2v", types.SimpleNamespace(VQAScore=lambda **kw: t))
    samples = [{"video": "pan.avi", "caption": "a pan"},
               {"image": "zoom.avi", "caption": ["a zoom", "zooming in"]},
               {"video": "missing.avi", "caption": "x"},
               {"video": "broken.avi", "caption": "y"}]
    for chunk_has_broken in (True, False):
        s = samples if chunk_has_broken else samples[:3]
        want = j_cg.generate_captions(s, MODEL, videos, max_new_tokens=4)
        got = t_cg.generate_captions(s, MODEL, videos, max_new_tokens=4)
        assert [g["generated_caption"] for g in got] == \
            [w["generated_caption"] for w in want]
        assert isinstance(got[0]["generated_caption"], str) and got[0]["generated_caption"]
        assert [g["error"] is None for g in got] == [w["error"] is None for w in want]
        assert got[2]["error"] == want[2]["error"]
    assert t_cg.parse_model_spec(" m : ckpt ") == j_cg.parse_model_spec(" m : ckpt ")
    assert t_cg.parse_model_spec("m") == ("m", None)


# ---------------------------------------------------------------------------
# Stage 2 on canned score files
# ---------------------------------------------------------------------------

def _binary_file(path, seed, split, single_class=False, non_finite=False):
    rng = np.random.default_rng(seed)
    scores = []
    for i in range(24):
        label = "Yes" if (single_class or rng.random() < 0.5) else "No"
        score = float(np.round(rng.random(), 1 if i % 3 == 0 else 6))
        if non_finite and i % 5 == 0:
            score = [float("nan"), float("inf"), float("-inf")][i % 3]
        scores.append({"video_path": f"{i}.mp4", "question": "q", "ground_truth_label": label,
                       "method": "m", "score": score,
                       "error": "decode failed" if i == 7 else None})
    data = {"metadata": {"model_name": f"m{seed % 2}", "split_name": split},
            "scores": scores}
    with open(path, "w") as f:
        json.dump(data, f)
    return path


@pytest.mark.parametrize("kind", ["random", "single_class", "non_finite"])
def test_binary_evaluation_matches_jax(tmp_path, kind):
    path = _binary_file(tmp_path / f"classification_scores_{kind}.json", 3, kind,
                        single_class=kind == "single_class", non_finite=kind == "non_finite")
    want = j_bce.evaluate_single_file(str(path), quiet=True)
    got = t_bce.evaluate_single_file(str(path), quiet=True)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], atol=STATS_TOL, rtol=0)
        else:
            assert got[k] == want[k]


def test_binary_evaluation_main_and_plots(tmp_path, monkeypatch):
    """main() over discovered files writes the JAX summary (to 1e-12); the
    plots draw the port's curves with matplotlib, imported only then."""
    import subprocess
    import sys

    scores_dir = tmp_path / "scores"
    scores_dir.mkdir()
    for seed in range(4):
        _binary_file(scores_dir / f"classification_scores_{seed}.json", seed, f"s{seed}")
    summaries = {}
    for label, module in (("j", j_bce), ("t", t_bce)):
        out = tmp_path / label
        monkeypatch.setattr(sys, "argv", ["x", "--scores_dir", str(scores_dir),
                                          "--output_dir", str(out)])
        module.main()
        summaries[label] = json.load(open(out / "binary_classification_summary.json"))
    assert t_bce.discover_score_files(scores_dir) == j_bce.discover_score_files(scores_dir)
    for g, w in zip(summaries["t"], summaries["j"]):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], atol=STATS_TOL, rtol=0)
            else:
                assert g[k] == w[k]
    assert list(t_bce.hierarchical_report(summaries["t"])) == ["m0", "m1"]
    pytest.importorskip("matplotlib")
    code = ("import sys\n"
            "from t2v_metrics_tpu_torch.camerabench import binary_classification_evaluation as b\n"
            "assert 'matplotlib' not in sys.modules\n"
            f"r = b.evaluate_single_file({str(scores_dir / 'classification_scores_0.json')!r},"
            f" True, {str(tmp_path)!r}, quiet=True)\n"
            "assert 'matplotlib' in sys.modules and 'sklearn' not in sys.modules\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp_path / "plots" / "m0_s0_curves.png").exists()


def test_vqa_retrieval_evaluation_matches_jax(tmp_path):
    keys = ("pos_text_pos_image", "pos_text_neg_image", "neg_text_pos_image",
            "neg_text_neg_image")
    rng = np.random.default_rng(4)
    entries = [{"pos_video": "p", "neg_video": "n", "pos_question": "q+",
                "neg_question": "q-", "method": "m",
                "yes_scores": dict(zip(keys, rng.random(4).round(1).tolist())),
                "no_scores": dict(zip(keys, rng.random(4).round(1).tolist())),
                "error": "x" if i == 3 else None} for i in range(12)]
    path = tmp_path / "vqa_retrieval_scores_m_motion.json"
    json.dump({"metadata": {"model_name": "m", "skill_name": "motion"}, "scores": entries},
              open(path, "w"))
    for mode in ("vqa", "retrieval", "both"):
        got = t_vre.evaluate_single_file(str(path), mode=mode, quiet=True)
        assert got == j_vre.evaluate_single_file(str(path), mode=mode, quiet=True)
    assert t_vre.evaluate_vqa_metrics([], []) == j_vre.evaluate_vqa_metrics([], [])
    assert t_vre.evaluate_retrieval_metrics([]) == j_vre.evaluate_retrieval_metrics([])


CAPTIONS = [("the camera pans left across the room", ["the camera pans left across the room"]),
            ("a dog eats breakfast", ["the camera zooms out quickly"]),
            ("camera slowly tilts up, then pans right", ["The camera tilts up and pans right.",
                                                         "tilt up; pan to the right"]),
            ("", ["x"]), ("zoom zoom zoom in", ["zoom in", "a zoom in then out"])]


@pytest.mark.parametrize("metric", ["bleu_2", "rouge_l", "meteor", "spice_like"])
def test_caption_metrics_match_jax(metric):
    for cand, refs in CAPTIONS:
        assert getattr(t_ce, metric)(cand, refs) == getattr(j_ce, metric)(cand, refs)


def test_cider_and_evaluate_captions_match_jax():
    cands, refs = [c for c, _ in CAPTIONS], [r for _, r in CAPTIONS]
    assert t_ce.cider(cands, refs) == j_ce.cider(cands, refs)
    entries = [{"generated_caption": c, "reference_caption": r if i % 2 else r[0],
                "error": None} for i, (c, r) in enumerate(CAPTIONS)]
    entries.append({"generated_caption": None, "reference_caption": "x", "error": "failed"})
    assert t_ce.evaluate_captions(entries) == j_ce.evaluate_captions(entries)
    assert t_ce.evaluate_captions([]) == {"num_samples": 0}


def test_judge_matches_jax():
    class Client:
        def __init__(self, replies):
            self.replies = list(replies)
            self.chat = types.SimpleNamespace(completions=self)

        def create(self, **kw):
            r = self.replies.pop(0)
            if isinstance(r, Exception):
                raise r
            return types.SimpleNamespace(choices=[types.SimpleNamespace(
                message=types.SimpleNamespace(content=r))])

    for replies in (["85"], ["none", "120 points"], [RuntimeError("x")] * 3):
        assert t_ce.gpt4o_judge("a", "b", client=Client(replies)) == \
            j_ce.gpt4o_judge("a", "b", client=Client(replies))
    entries = [{"generated_caption": "pan", "reference_caption": "pan", "error": None}]
    assert t_ce.evaluate_captions(entries, use_judge=True, judge_client=Client(["40"])) == \
        j_ce.evaluate_captions(entries, use_judge=True, judge_client=Client(["40"]))
