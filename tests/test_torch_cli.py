"""Port parity: the command-line harnesses of ``t2v_metrics_tpu_torch.cli``
against the JAX package's, on a staged GenAI-Bench fixture (that of
``tests/test_cli.py``) and the tiny CLIP-FlanT5 model.

  * ``genai_image_eval.main`` end to end on the CPU (``--device cpu``),
    twice, the second time from the npz cache;
  * with the JAX parameters carried by ``bridge.py`` into the port's scorer
    (``get_score_model`` patched on both sides to return scorers on the same
    parameters and tokenizer), the cached scores of each CLI within 1e-5 of
    the JAX CLI's (fp32; the two CPU BLAS libraries sum in different
    orders), and the evaluation over equal scores (the JAX npz in the port's
    result dir) exactly the JAX one;
  * ``--device`` defaults to the GPU and ``tpu`` raises; every CLI's flags
    parse to the JAX CLI's values but the device.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.benchmarks import datasets as jds  # noqa: E402
from t2v_metrics_tpu.cli import genai_bench_evaluate as j_bench_eval  # noqa: E402
from t2v_metrics_tpu.cli import genai_image_eval as j_image  # noqa: E402
from t2v_metrics_tpu.cli import genai_image_ranking as j_rank  # noqa: E402
from t2v_metrics_tpu.cli import genai_video_eval as j_video  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.cli import eval as t_eval  # noqa: E402
from t2v_metrics_tpu_torch.cli import genai_bench_evaluate as t_bench_eval  # noqa: E402
from t2v_metrics_tpu_torch.cli import genai_bench_generate as t_generate  # noqa: E402
from t2v_metrics_tpu_torch.cli import genai_image_eval as t_image  # noqa: E402
from t2v_metrics_tpu_torch.cli import genai_image_ranking as t_rank  # noqa: E402
from t2v_metrics_tpu_torch.cli import genai_video_eval as t_video  # noqa: E402
from t2v_metrics_tpu_torch.cli import gpt4_eval as t_gpt4  # noqa: E402

MODEL = "clip-flant5-test"
SCORE_TOL = 1e-5
TAGS = {"basic": [0, 1], "advanced": [2], "attribute": [0], "scene": [1],
        "spatial relation": [2], "action relation": [0], "part relation": [1],
        "counting": [2], "comparison": [0], "differentiation": [1], "negation": [2],
        "universal": [0]}


@pytest.fixture()
def genai_root(tmp_path):
    d = tmp_path / "GenAI-Image-1600"
    rng = np.random.default_rng(0)
    prompts = {f"{i:05d}": {"prompt": f"prompt {i}",
                            "models": {m: [3 + (i % 3), 4] for m in jds.GenAIBench_Image.MODELS}}
               for i in range(3)}
    for m in jds.GenAIBench_Image.MODELS:
        (d / m).mkdir(parents=True)
        for p in prompts:
            Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
                            ).save(d / m / f"{p}.jpeg")
    json.dump(prompts, open(d / "genai_image.json", "w"))
    json.dump(TAGS, open(d / "genai_skills.json", "w"))
    return tmp_path


@pytest.fixture(scope="module")
def shared_scorers():
    """get_score_model stand-ins: the JAX and the port scorer of
    clip-flant5-test on the same parameters (matrices x4, to spread the
    scores) and one tokenizer instance."""
    cfg = J_MODELS[MODEL]["config"]
    leaves, treedef = jax.tree.flatten(jcft5.init_clip_t5(jax.random.PRNGKey(0), cfg))
    jp = jax.tree.unflatten(treedef, [np.asarray(x) * np.float32(4.0) if np.ndim(x) == 2
                                      else np.asarray(x) for x in leaves])
    tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
    j = jt2v.VQAScore(MODEL, params=jp, tokenizer=tok)
    t = tt2v.VQAScore(MODEL, params=jp, tokenizer=tok, device="cpu")
    return j, t


def _patch(monkeypatch, j, t):
    monkeypatch.setattr(jt2v, "get_score_model", lambda **kw: j)
    monkeypatch.setattr(tt2v, "get_score_model", lambda **kw: t)


def _run(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def test_genai_image_eval_cli_runs_and_caches(genai_root, tmp_path, monkeypatch, capsys):
    result_dir = tmp_path / "results"
    argv = ["--root_dir", str(genai_root), "--model", MODEL, "--num_prompts", "1600",
            "--batch_size", "4", "--result_dir", str(result_dir), "--device", "cpu"]
    _run(monkeypatch, t_image, argv)
    out = capsys.readouterr().out
    assert "Tag Group: overall" in out and "Overall Alignment Performance" in out
    npz = result_dir / f"{MODEL}_1600_prompts.npz"
    assert npz.exists() and (result_dir / f"{MODEL}_1600_per_skill.json").exists()
    scores = np.load(npz)["scores"]
    assert scores.shape == (18, 1, 1) and np.isfinite(scores).all()

    def no_scorer(**kw):
        raise AssertionError("the cached run built a scorer")

    monkeypatch.setattr(tt2v, "get_score_model", no_scorer)
    _run(monkeypatch, t_image, argv)
    assert "already exists. Skipping." in capsys.readouterr().out


def test_genai_image_eval_scores_and_skills_match_jax(genai_root, tmp_path, monkeypatch,
                                                     shared_scorers):
    j, t = shared_scorers
    _patch(monkeypatch, j, t)
    jdir, tdir, tdir2 = tmp_path / "j", tmp_path / "t", tmp_path / "t_from_jax"
    common = ["--root_dir", str(genai_root), "--model", MODEL, "--batch_size", "4"]
    _run(monkeypatch, j_image, [*common, "--result_dir", str(jdir)])
    _run(monkeypatch, t_image, [*common, "--result_dir", str(tdir), "--device", "cpu"])
    name = f"{MODEL}_1600_prompts.npz"
    want, got = np.load(jdir / name)["scores"], np.load(tdir / name)["scores"]
    assert got.shape == want.shape == (18, 1, 1)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    assert np.ptp(want) > 100 * SCORE_TOL

    # the evaluation of equal scores: the JAX npz in the port's result dir
    tdir2.mkdir()
    shutil.copy(jdir / name, tdir2 / name)
    _run(monkeypatch, t_image, [*common, "--result_dir", str(tdir2), "--device", "cpu"])
    skills = f"{MODEL}_1600_per_skill.json"
    assert (tdir2 / skills).read_text() == (jdir / skills).read_text()


def test_show_performance_per_skill_matches_jax(genai_root):
    j = jds.GenAIBench_Image(root_dir=str(genai_root))
    from t2v_metrics_tpu_torch.benchmarks.datasets import GenAIBench_Image

    t = GenAIBench_Image(root_dir=str(genai_root))
    scores = np.random.default_rng(1).random(len(j))
    want = j_image.show_performance_per_skill(scores, j, print_std=True)
    got = t_image.show_performance_per_skill(scores, t, print_std=True)
    assert json.dumps(got, default=float) == json.dumps(want, default=float)
    assert t_image.tag_groups == j_image.tag_groups


def test_genai_video_eval_matches_jax(tmp_path, monkeypatch, shared_scorers):
    """avg_frames over 36 frames a clip (padded from 6); frames decoded by
    cv2 into JPEGs once (the JAX run), read by both."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "GenAI-Video-527"
    prompts = {f"{i:05d}": {"prompt": f"video {i}", "models": {"Gen2": [2 + i, 4]}}
               for i in range(3)}
    (root / "Gen2").mkdir(parents=True)
    rng = np.random.default_rng(2)
    for p in prompts:
        vw = cv2.VideoWriter(str(root / "Gen2" / f"{p}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (24, 24))
        for _ in range(6):
            vw.write(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8))
        vw.release()
    json.dump(prompts, open(root / "genai_video.json", "w"))
    json.dump(TAGS, open(root / "genai_skills.json", "w"))
    j, t = shared_scorers
    _patch(monkeypatch, j, t)
    common = ["--root_dir", str(tmp_path), "--model", MODEL, "--batch_size", "4"]
    _run(monkeypatch, j_video, [*common, "--result_dir", str(tmp_path / "j")])
    _run(monkeypatch, t_video, [*common, "--result_dir", str(tmp_path / "t"),
                                "--device", "cpu"])
    name = f"{MODEL}_527_avg_frames.npz"
    want, got = (np.load(tmp_path / d / name)["scores"] for d in ("j", "t"))
    assert got.shape == want.shape == (3, 36, 1)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


def test_genai_image_ranking_matches_jax(tmp_path, monkeypatch, shared_scorers, capsys):
    d = tmp_path / "GenAI-Image-Ranking-800"
    (d / "DALLE_3").mkdir(parents=True)
    rng = np.random.default_rng(3)
    prompts = {}
    for i in range(2):
        pid = f"{i:05d}"
        prompts[pid] = {"id": pid, "prompt": f"p {i}",
                        "models": {"DALLE_3": {str(k): [float((k + i) % 5 + 1)]
                                               for k in range(1, 10)}}}
        for k in range(1, 10):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)).save(
                d / "DALLE_3" / f"{i:05d}_{k:02d}.jpeg")
    json.dump(prompts, open(d / "human_rating.json", "w"))
    json.dump({"basic": [0], "advanced": [1], "all": [0, 1]}, open(d / "genai_skills.json", "w"))
    j, t = shared_scorers
    _patch(monkeypatch, j, t)
    common = ["--root_dir", str(tmp_path), "--model", MODEL, "--batch_size", "4"]
    _run(monkeypatch, j_rank, [*common, "--result_dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    _run(monkeypatch, t_rank, [*common, "--result_dir", str(tmp_path / "t"), "--device", "cpu"])
    tout = capsys.readouterr().out
    name = f"{MODEL}_DALLE_3.npz"
    want, got = (np.load(tmp_path / r / name)["scores"] for r in ("j", "t"))
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    assert "Top-1 ranking accuracy per skill" in tout
    # the same report, once the port reads the JAX scores
    shutil.copy(tmp_path / "j" / name, tmp_path / "t" / name)
    _run(monkeypatch, t_rank, [*common, "--result_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert capsys.readouterr().out == jout


def test_genai_bench_evaluate_matches_jax(genai_root, tmp_path, monkeypatch, shared_scorers,
                                         capsys):
    j, t = shared_scorers
    _patch(monkeypatch, j, t)
    image_dir = genai_root / "GenAI-Image-1600" / "DALLE_3"
    common = ["--image_dir", str(image_dir), "--model", MODEL,
              "--prompts", str(genai_root / "GenAI-Image-1600" / "genai_image.json"),
              "--skills", str(genai_root / "GenAI-Image-1600" / "genai_skills.json")]
    _run(monkeypatch, j_bench_eval, [*common, "--result_dir", str(tmp_path / "j")])
    capsys.readouterr()
    _run(monkeypatch, t_bench_eval, [*common, "--result_dir", str(tmp_path / "t"),
                                     "--device", "cpu"])
    assert "all" in capsys.readouterr().out
    name = f"{MODEL}_DALLE_3.npz"
    want, got = (np.load(tmp_path / r / name, allow_pickle=True) for r in ("j", "t"))
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_TOL, rtol=0)
    assert list(got["idxs"]) == list(want["idxs"]) == ["00000", "00001", "00002"]


def test_device_defaults_to_the_gpu_and_tpu_raises(genai_root, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["genai_image_eval"])
    assert t_image.config().device is None
    argv = ["--root_dir", str(genai_root), "--model", MODEL,
            "--result_dir", str(tmp_path / "r"), "--device", "tpu"]
    with pytest.raises(RuntimeError, match="tpu"):
        _run(monkeypatch, t_image, argv)
    if not torch.cuda.is_available():  # the default asks for the GPU, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(monkeypatch, t_image, argv[:-2])


CLIS = {
    "eval": (t_eval, "t2v_metrics_tpu.cli.eval", ["--batch_size", "4", "--question", "q {}"]),
    "gpt4_eval": (t_gpt4, "t2v_metrics_tpu.cli.gpt4_eval",
                  ["--model", "gpt-4.1", "--top_logprobs", "5", "--openai_key", "k"]),
    "genai_bench_evaluate": (t_bench_eval, "t2v_metrics_tpu.cli.genai_bench_evaluate",
                             ["--image_dir", "x", "--answer", "yes"]),
    "genai_image_ranking": (t_rank, "t2v_metrics_tpu.cli.genai_image_ranking",
                            ["--gen_model", "SDXL_Base", "--result_dir", "r"]),
    "genai_video_eval": (t_video, "t2v_metrics_tpu.cli.genai_video_eval",
                         ["--num_prompts", "800", "--eval_mode", "sample_9_frame"]),
    "genai_image_eval": (t_image, "t2v_metrics_tpu.cli.genai_image_eval",
                         ["--num_prompts", "527", "--top_logprobs", "3"]),
    "genai_bench_generate": (t_generate, "t2v_metrics_tpu.cli.genai_bench_generate",
                             ["--steps", "4", "--seed", "2"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_flags_parse_as_jax(name, monkeypatch):
    import importlib

    port, jname, argv = CLIS[name]
    jmod = importlib.import_module(jname)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    got, want = vars(port.config()), vars(jmod.config())
    if "device" in want:
        assert want.pop("device") == "tpu" and got.pop("device") is None
    assert got == want
    assert callable(port.main)


def test_genai_bench_generate_needs_diffusers(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "diffusers", None)  # absent, as on the GPU machine
    monkeypatch.setattr(sys, "argv", ["genai_bench_generate", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="diffusers") as e:
        t_generate.main()
    assert isinstance(e.value.__cause__, ImportError)


def test_chip_smoke_genai_bench_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's GenAI-Bench phase, rehearsed on the CPU: clip-flant5-xl's
    registry entry pointed at the test config, its checkpoint staged by the
    script's own key map and writer as a hub snapshot, the plain versions
    counted as their kernels' launches. The phase's own checks run: the
    snapshot found through --cache_dir, scores bitwise those of
    VQAScore(checkpoint=<snapshot>), the npz cache, every skill tag in the
    JSON, TIFA160, launch counts, no host-only package imported by the
    phase."""
    import chip_smoke as cs
    from t2v_metrics_tpu_torch.models import adapters as A
    from t2v_metrics_tpu_torch.models import clip_flant5 as C
    from t2v_metrics_tpu_torch.models.checkpoint import resolve_snapshot
    from t2v_metrics_tpu_torch import tracing
    from t2v_metrics_tpu_torch.ops import attention, norms

    cfg = A.CLIP_T5_MODELS[MODEL]["config"]
    monkeypatch.setitem(A.CLIP_T5_MODELS["clip-flant5-xl"], "config", cfg)
    monkeypatch.setattr(cs, "card_line", lambda: "CPU")
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    for mod, name, kernel in ((attention, "attention_flat_reference", "flash_attention_flat"),
                              (norms, "layer_norm_plain", "layer_norm"),
                              (norms, "rms_norm_plain", "rms_norm")):
        def counted(*a, _fn=getattr(mod, name), _kernel=kernel, **k):
            tracing.count("launch." + _kernel)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    cache = str(tmp_path / "hub")
    model = C.init_clip_t5(cfg, 5, "cpu", torch.float32)
    snapshot, _ = cs.stage_snapshot(cs.hf_clip_t5_tensors(model, cfg), cache,
                                    "zhiqiulin/clip-flant5-xl", 2)
    assert resolve_snapshot("zhiqiulin/clip-flant5-xl", cache) == snapshot
    cwd = os.getcwd()
    counts = cs.phase_genai_bench(cache, device="cpu", side=64, tifa_side=32)
    assert os.getcwd() == cwd
    assert counts == [cs.clip_t5_launches(cfg, 6), cs.clip_t5_launches(cfg, 5)]
    # the staged fixture names every tag of the CLI's tag groups
    root = cs.stage_genai_bench(str(tmp_path / "fixture"), 16, 0)
    skills = json.load(open(os.path.join(root, "genai_skills.json")))
    assert set(skills) | {"all"} == {t for ts in t_image.tag_groups.values() for t in ts}
