"""Port parity: the twelve dataset classes of
``t2v_metrics_tpu_torch.benchmarks.datasets`` against the JAX package's, on
staged fixtures (those of ``tests/test_datasets.py``, and as small ones for
the classes it does not stage): the same items from ``__getitem__`` and
the same ``evaluate_scores`` results for the same seeded scores.

Exact: both sides run the same float64 statistics on the same numbers.
The CSV classes (Winoground, SeeTrue, TIFA160) are read by pandas in the
JAX package and by the stdlib ``csv`` module in the port; SeeTrue's
per-source table is a DataFrame in JAX and its ``to_dict("records")`` rows
in the port.
"""

import json
import math
import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
Image = pytest.importorskip("PIL.Image")

from t2v_metrics_tpu.benchmarks import datasets as J  # noqa: E402
from t2v_metrics_tpu_torch.benchmarks import datasets as T  # noqa: E402


def _img(path, seed=0):
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (16, 16, 3), dtype=np.uint8)).save(path)


def same(a, b) -> bool:
    """Deep equality with nan == nan, numpy scalars and arrays by value."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, (float, np.floating)) and isinstance(b, (float, np.floating)):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def items(ds):
    return [ds[i] for i in range(len(ds))]


def check_pair(j, t, scores, seed=None):
    """Items equal; evaluate_scores equal (numpy's global generator seeded
    alike for the sampled pairwise accuracy)."""
    assert len(t) == len(j) > 0
    assert same(items(t), items(j))
    if seed is not None:
        np.random.seed(seed)
    want = j.evaluate_scores(scores)
    if seed is not None:
        np.random.seed(seed)
    got = t.evaluate_scores(scores)
    assert same(got, want), (got, want)
    return got, want


# ---------------------------------------------------------------------------
# the fixtures of tests/test_datasets.py
# ---------------------------------------------------------------------------

@pytest.fixture()
def winoground_dir(tmp_path):
    d = tmp_path / "winoground"
    (d / "images").mkdir(parents=True)
    rows, examples, tags = [], [], {}
    for i in range(4):
        _img(d / "images" / f"ex_{i}_img_0.png")
        _img(d / "images" / f"ex_{i}_img_1.png")
        rows.append({"id": i, "image_0": f"images/ex_{i}_img_0.png",
                     "image_1": f"images/ex_{i}_img_1.png",
                     # a caption with a comma, a quote and one that reads as a number
                     "caption_0": f"cap0, \"{i}\"", "caption_1": f"{i}"})
        examples.append({"id": i, "num_main_preds": 1 + i % 2,
                         "collapsed_tag": "Relation" if i % 2 else "Object"})
        tags[str(i)] = ["Unusual Image"] if i == 0 else []
    pd.DataFrame(rows).to_csv(d / "metadata.csv", index=False)
    with open(d / "examples.jsonl", "w") as f:
        for ex in examples:
            f.write(json.dumps(ex) + "\n")
    json.dump(tags, open(d / "why_winoground_hard.json", "w"))
    return str(tmp_path)


def test_winoground(winoground_dir):
    j, t = J.Winoground(root_dir=winoground_dir), T.Winoground(root_dir=winoground_dir)
    assert same(t.metadata, j.metadata)
    got, _ = check_pair(j, t, np.random.default_rng(1).random((4, 2, 2)))
    assert "Object" in got and "1 Main Pred" in got and "No Tag" in got


def test_eqben(tmp_path):
    base = tmp_path / "eqben_vllm"
    meta = []
    for i, sub in enumerate(["eqbensd", "eqbenag", "eqbenkubric_cnt"]):
        (base / "images" / sub).mkdir(parents=True)
        _img(base / "images" / sub / f"a{i}.png")
        _img(base / "images" / sub / f"b{i}.png")
        meta.append({"image0": f"{sub}/a{i}.png", "image1": f"{sub}/b{i}.png",
                     "caption0": "c0", "caption1": "c1"})
    json.dump(meta, open(base / "all_select.json", "w"))
    j, t = J.EqBen_Mini(root_dir=str(tmp_path)), T.EqBen_Mini(root_dir=str(tmp_path))
    assert t.subset_indices == j.subset_indices
    check_pair(j, t, np.random.default_rng(0).random((3, 2, 2)))


def test_naturalbench(tmp_path):
    d = tmp_path / "NaturalBench-Retrieval" / "images"
    d.mkdir(parents=True)
    meta = []
    for i in range(3):
        _img(d / f"i{i}_0.png")
        _img(d / f"i{i}_1.png")
        meta.append({"index": i, "image_0": f"i{i}_0.png", "image_1": f"i{i}_1.png",
                     "caption_0": "x", "caption_1": "y"})
    json.dump(meta, open(tmp_path / "NaturalBench-Retrieval" / "metadata.json", "w"))
    root = str(tmp_path)
    check_pair(J.NaturalBench_Retrieval(root_dir=root), T.NaturalBench_Retrieval(root_dir=root),
               np.random.default_rng(0).random((3, 2, 2)))


@pytest.fixture()
def genai_image_root(tmp_path):
    d = tmp_path / "GenAI-Image-1600"
    prompts = {f"{i:05d}": {"prompt": f"prompt {i}",
                            "models": {m: [3 + (i % 3), 4]
                                       for m in J.GenAIBench_Image.MODELS}}
               for i in range(4)}
    for m in J.GenAIBench_Image.MODELS:
        (d / m).mkdir(parents=True)
        for p in prompts:
            _img(d / m / f"{p}.jpeg")
    json.dump(prompts, open(d / "genai_image.json", "w"))
    json.dump({"basic": [0, 1], "advanced": [2, 3]}, open(d / "genai_skills.json", "w"))
    return str(tmp_path)


def test_genai_bench_image(genai_image_root):
    j = J.GenAIBench_Image(root_dir=genai_image_root, num_prompts=1600)
    t = T.GenAIBench_Image(root_dir=genai_image_root, num_prompts=1600)
    assert t.prompt_to_images == j.prompt_to_images and same(t.images, j.images)
    scores = np.random.default_rng(2).random((24, 1, 1))
    check_pair(j, t, scores)
    want, got = j.evaluate_scores_per_skill(scores), t.evaluate_scores_per_skill(scores)
    assert set(got) == {"basic", "advanced"} and same(got, want)


def test_genai_bench_image_arrays(genai_image_root):
    """return_image_paths=False: items are what image_preprocess makes of
    each path."""
    def pre(path):
        return np.frombuffer(path.encode(), np.uint8)

    j = J.GenAIBench_Image(root_dir=genai_image_root, return_image_paths=False,
                           image_preprocess=pre)
    t = T.GenAIBench_Image(root_dir=genai_image_root, return_image_paths=False,
                           image_preprocess=pre)
    assert same(items(t), items(j))
    assert isinstance(t[0]["images"][0], np.ndarray)


def test_pickapic(tmp_path):
    d = tmp_path / "pickapic_v1"
    (d / "imgs").mkdir(parents=True)
    all_data = [{"id": i, "caption": f"c{i}", "label_0": int(i % 2 == 0),
                 "label_1": int(i % 2 == 1), "image_0": "imgs/a.png", "image_1": "imgs/b.png"}
                for i in range(max(J.Pickapic_v1.SELECTED_IDXS) + 1)]
    _img(d / "imgs" / "a.png")
    _img(d / "imgs" / "b.png")
    json.dump(all_data, open(d / "test_captions.json", "w"))
    j, t = J.Pickapic_v1(root_dir=str(tmp_path)), T.Pickapic_v1(root_dir=str(tmp_path))
    assert len(t) == 100
    check_pair(j, t, np.random.default_rng(3).random((100, 2, 1)))


def test_genai_ranking(tmp_path):
    d = tmp_path / "GenAI-Image-Ranking-800"
    (d / "DALLE_3").mkdir(parents=True)
    prompts = {}
    for i in range(3):
        pid = f"{i:05d}"
        prompts[pid] = {"id": pid, "prompt": f"p{i}",
                        "models": {"DALLE_3": {str(k): [float(k % 5 + 1), float(i % 3 + 2)]
                                               for k in range(1, 10)}}}
        for k in range(1, 10):
            _img(d / "DALLE_3" / f"{int(pid):05d}_{k:02d}.jpeg")
    json.dump(prompts, open(d / "human_rating.json", "w"))
    j = J.GenAIBench_Ranking(root_dir=str(tmp_path), gen_model="DALLE_3")
    t = T.GenAIBench_Ranking(root_dir=str(tmp_path), gen_model="DALLE_3")
    assert t.images_to_prompt_idx == j.images_to_prompt_idx
    got, _ = check_pair(j, t, np.random.default_rng(4).random((27, 1, 1)))
    assert got["ranking_accuracy"].shape == (3,)


def _tifa_fixture(root, answers=(3, 5, 2), source_ids=("0", "0", "1")):
    os.makedirs(root / "tifa160", exist_ok=True)
    dsdir = root / "datasets"
    dsdir.mkdir(exist_ok=True)
    keys = ["0_mini_dalle", "1_mini_dalle", "0_vq_diffusion"]
    dataset = {k: {"text": f"t{k}", "text_id": k.split("_")[0], "image_path": f"{k}.jpg"}
               for k in keys}
    json.dump(dataset, open(dsdir / "tifa160.json", "w"))
    n = len(answers)
    pd.DataFrame({"model_type": ["mini-dalle"] * (n - 1) + ["vq-diffusion"],
                  "source_id": list(source_ids), "answer": list(answers)}
                 ).to_csv(dsdir / "dsg_tifa160_anns.csv", index=False)
    for k in keys:
        _img(root / "tifa160" / f"{k}.jpg")


@pytest.mark.parametrize("answers", [(3, 5, 2, 4), (3.5, 5.0, 2.0, 1.0)], ids=["int", "float"])
def test_tifa160(tmp_path, monkeypatch, answers):
    """The annotations CSV read from ./datasets (the reference's quirk, not
    root_dir); integer and float answers keep pandas' types."""
    _tifa_fixture(tmp_path, answers, ("0", "0", "1", "0"))
    monkeypatch.chdir(tmp_path)
    j = J.TIFA160_DSG(root_dir=str(tmp_path), download=False)
    t = T.TIFA160_DSG(root_dir=str(tmp_path), download=False)
    assert same(t.dsg_items, j.dsg_items)
    assert [type(x) for x in t.dsg_items["0_mini_dalle"]["human_scores"]] == \
        [type(x) for x in j.dsg_items["0_mini_dalle"]["human_scores"]]
    check_pair(j, t, np.array([[[0.9]], [[0.2]], [[0.4]]]))


def test_seetrue(tmp_path, monkeypatch):
    """SeeTRUE.csv read from ./datasets; ROC-AUC per dataset_source (a
    source of one class gives nan on both sides)."""
    (tmp_path / "seetrue" / "images").mkdir(parents=True)
    (tmp_path / "datasets").mkdir()
    rng = np.random.default_rng(5)
    rows = []
    for i in range(14):
        name = f"im{i}.png"
        _img(tmp_path / "seetrue" / "images" / name, seed=i)
        src = ("drawbench", "coco_t2i", "pickapic_con")[i % 3] if i < 12 else "single"
        rows.append({"image": name, "text": f"a text {i}" if i != 3 else "", "label":
                     int(rng.integers(0, 2)) if src != "single" else 1,
                     "dataset_source": src})
    pd.DataFrame(rows).to_csv(tmp_path / "datasets" / "SeeTRUE.csv", index=False)
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path)
    j = J.SeeTrue(root_dir=root, download=False)
    t = T.SeeTrue(root_dir=root, download=False)
    assert same(items(t), items(j))
    assert t[3]["texts"] == ["nan"]          # an empty cell reads as nan on both sides
    scores = rng.random((14, 1, 1))
    with pytest.warns(UserWarning, match="Only one class"):
        got = t.evaluate_scores(scores)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j.evaluate_scores(scores)
    want = want["per_dataset_source"].to_dict(orient="records")
    assert same(got["per_dataset_source"], want), (got, want)
    assert [r["dataset_source"] for r in got["per_dataset_source"]] == sorted(
        {r["dataset_source"] for r in rows})


def test_flickr8k(tmp_path):
    d = tmp_path / "flickr8k"
    d.mkdir()
    data = {}
    for i in range(5):
        _img(d / f"f{i}.jpg", seed=i)
        data[f"k{i}"] = {"image_path": f"f{i}.jpg",
                         "ground_truth": [f"a  dog {i}", "a cat"],
                         "human_judgement": [{"caption": f"a dog  runs {i}.", "rating": 1 + i % 4},
                                             {"caption": f" two cats {i}", "rating": 4 - i % 3}]}
    json.dump(data, open(d / "crowdflower_flickr8k.json", "w"))
    root = str(tmp_path)
    j, t = J.Flickr8K_CF(root_dir=root), T.Flickr8K_CF(root_dir=root)
    assert t.refs == j.refs and t.candidates == j.candidates
    check_pair(j, t, np.random.default_rng(6).random((10, 1, 1)), seed=13)


def _write_mp4(path, frames, seed):
    import cv2

    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (16, 16))
    for _ in range(frames):
        vw.write(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
    vw.release()


def test_genai_bench_video(tmp_path):
    """Frames extracted with cv2 into JPEGs (JAX first; the port extracts
    again over the same files); both then load the cached lists."""
    pytest.importorskip("cv2")
    root = tmp_path / "GenAI-Video-527"
    prompts = {f"{i:05d}": {"prompt": f"video {i}",
                            "models": {"Gen2": [2, 3 + i], "Pika_v1": [4, 4]}}
               for i in range(2)}
    for m in ("Gen2", "Pika_v1"):
        (root / m).mkdir(parents=True)
        for i, p in enumerate(prompts):
            _write_mp4(root / m / f"{p}.mp4", 5 + i, seed=i)
    json.dump(prompts, open(root / "genai_video.json", "w"))
    kw = dict(root_dir=str(tmp_path), num_prompts=527, num_frames=8)
    j = J.GenAIBench_Video(**kw)
    t = T.GenAIBench_Video(extract_videos=True, **kw)
    assert same(t.videos, j.videos) and t.prompt_to_videos == j.prompt_to_videos
    check_pair(j, t, np.random.default_rng(7).random((4, 8, 1)))
    cached = T.GenAIBench_Video(**kw)
    assert same(cached.videos, j.videos)


def test_t2vscore(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    root = tmp_path / "t2vscore"
    (tmp_path / "datasets").mkdir()
    align = {str(i): {"prompt": f"clip {i}", "models": {"gen2": [1, 2 + i], "pika": [3]}}
             for i in range(2)}
    quality = {str(i): {"models": {"gen2": [4], "pika": [5]}} for i in range(2)}
    json.dump(align, open(tmp_path / "datasets" / "t2vscore_alignment_score.json", "w"))
    json.dump(quality, open(tmp_path / "datasets" / "t2vscore_quality_score.json", "w"))
    for m in ("gen2", "pika"):
        (root / m).mkdir(parents=True)
        for i in range(2):
            _write_mp4(root / m / f"{i:04d}.mp4", 4 + i, seed=10 + i)
    monkeypatch.chdir(tmp_path)
    kw = dict(root_dir=str(tmp_path), num_frames=6, eval_mode="sample_4_frame")
    j = J.T2VScore(**kw)
    t = T.T2VScore(extract_videos=True, **kw)
    assert same(t.videos, j.videos)
    check_pair(j, t, np.random.default_rng(8).random((4, 4, 1)))


def test_stanford_t23d(tmp_path, monkeypatch):
    root = tmp_path / "stanfordt23d"
    (tmp_path / "datasets").mkdir()
    data = {str(i): {"prompt": f"shape {i}", "models": {"mvdream": [3, 4 + i]}}
            for i in range(2)}
    json.dump(data, open(tmp_path / "datasets" / "stanfordt23d.json", "w"))
    for i in range(2):
        folder = root / "mvdream" / str(i) / "0"
        folder.mkdir(parents=True)
        for v in range(120):
            for kind in ("rgb", "normal"):
                Image.fromarray(np.full((4, 4, 3), (v * 2 + i) % 256, np.uint8)).save(
                    folder / f"{kind}_{v}.jpg")
    monkeypatch.chdir(tmp_path)
    j = J.StanfordT23D(root_dir=str(tmp_path))
    t = T.StanfordT23D(root_dir=str(tmp_path), extract_images=True)
    assert same(t.images, j.images)
    check_pair(j, t, np.random.default_rng(9).random((2, 1, 1)))
    grid = t.images[0]["rgb_grid_3_x_3"][0]
    assert Image.open(grid).size == (12, 12)


def test_missing_data_raises(tmp_path):
    with pytest.raises(RuntimeError, match="TestData"):
        T.ensure_downloaded(str(tmp_path / "nope"), lambda: None, "TestData")
    T.ensure_downloaded(str(tmp_path), lambda: None, "Present")  # present: no fetch


def test_read_csv_records_types_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    df = pd.DataFrame({"i": [0, 1, 2], "f": [1.5, None, 2], "s": ["a", "", "1"],
                       "b": [True, False, True], "n": ["3", "5", "2"],
                       "q": ['say "hi", now', "x\ny", "NA"]})
    df.to_csv(path, index=False)
    want = pd.read_csv(path).to_dict(orient="records")
    got = T.read_csv_records(str(path))
    assert same(got, want)
    assert [[type(v) for v in r.values()] for r in got] == \
        [[type(v) for v in r.values()] for r in want]
