"""Benchmark dataset classes (the port's copy of
t2v_metrics_tpu/benchmarks/datasets.py, under the same names).

The 12 dataset classes of reference dataset.py:230-1799. Each yields ``{"images": [paths...], "texts": [str...]}`` from ``__getitem__``
and owns its ``evaluate_scores(scores)`` where ``scores`` is the
(num_samples, num_images, num_texts) array from ``Score.batch_forward``.

Differences from the reference:
  * CSV files are read with the stdlib ``csv`` module, each column cast to
    the type pandas infers for it (``read_csv``), and SeeTrue's ROC-AUC is
    ``stats.roc_auc_score``: the port needs neither pandas nor sklearn
    (the GPU machine has no sklearn).
    SeeTrue's ``evaluate_scores`` gives its per-source table as a list of
    row dicts (``DataFrame.to_dict(orient="records")`` of the JAX table);
  * plain Python sequences (no torch.utils.data dependency) — batch_forward
    only needs __len__/__getitem__;
  * downloads go through one `ensure_downloaded` helper that raises a clear
    error in offline environments instead of calling gdown/wget ad hoc;
  * video frame extraction decodes sequentially via OpenCV once and caches
    JPEG frames exactly like the reference (same filenames/counts).

Evaluation semantics (metric names, NaN filtering, frame averaging, skill
tags, sample rates) match the reference line-for-line in behavior; see the
per-class citations.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess

import numpy as np

from ..media.video import MediaError
from .stats import (calc_pearson, calc_metric, get_winoground_scores,
                    get_winoground_acc, roc_auc_score)


def _call(cmd, cwd=None, env=None):
    return subprocess.call(cmd, cwd=cwd, env=env)


def ensure_downloaded(target_dir: str, fetch_fn, what: str):
    """Run fetch_fn() if target_dir is missing; raise informatively offline."""
    if os.path.exists(target_dir):
        return
    try:
        fetch_fn()
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            f"{what} is not present at {target_dir} and could not be "
            f"downloaded ({e}). Pre-stage the data there.") from e
    if not os.path.exists(target_dir):
        raise RuntimeError(
            f"{what} missing at {target_dir} (download unavailable in this "
            "environment — pre-stage the data).")


def _gdown_zip(file_id: str, zip_path: str, extract_cwd: str):
    _call(["gdown", "--no-cookies", file_id, "--output", zip_path])
    _call(["unzip", "-q", os.path.basename(zip_path)], cwd=extract_cwd)


def _wget_zip(url: str, cwd: str, unzip: bool = True):
    name = url.split("/")[-1]
    _call(["wget", url, "-O", name], cwd=cwd)
    if unzip:
        _call(["unzip", "-q", name], cwd=cwd)


# the cells pandas.read_csv reads as missing by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _cast_column(values: list):
    """A CSV column as ``pandas.read_csv`` types it: all integers -> int, all
    numbers -> float (missing cells nan), all true/false -> bool, else str
    (missing cells nan)."""
    missing = [v in _NA for v in values]
    if not any(missing):
        try:
            return [int(v) for v in values]
        except ValueError:
            pass
    try:
        return [float("nan") if m else float(v) for v, m in zip(values, missing)]
    except ValueError:
        pass
    truth = {"True": True, "TRUE": True, "true": True,
             "False": False, "FALSE": False, "false": False}
    if not any(missing) and all(v in truth for v in values):
        return [truth[v] for v in values]
    return [float("nan") if m else v for v, m in zip(values, missing)]


def read_csv_records(path: str) -> list[dict]:
    """The rows of a CSV file with a header line, as dicts, each column cast
    by ``_cast_column`` (``pd.read_csv(path).to_dict(orient="records")``)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    columns = {name: _cast_column([r[i] if i < len(r) else "" for r in body])
               for i, name in enumerate(header)}
    return [{name: columns[name][j] for name in header} for j in range(len(body))]


def _mean(x) -> float:
    return float(np.asarray(x, dtype=np.float64).mean())


class _CorrelationMixin:
    """pearson + tau_b + tau-optimized pairwise accuracy block shared by the
    Likert-style datasets (reference dataset.py:1320-1335 et al.)."""

    @staticmethod
    def correlation(our_scores, human_scores, sample_rate: float = 1.0) -> dict:
        pearson = calc_pearson(human_scores, our_scores)
        print("Pearson's Correlation (no grouping): ", pearson)
        kendall_b = calc_metric(human_scores, our_scores, variant="tau_b")
        print("Kendall Tau-B Score (no grouping): ", kendall_b)
        pairwise_acc = calc_metric(human_scores, our_scores,
                                   variant="pairwise_acc_with_tie_optimization",
                                   sample_rate=sample_rate)
        print("Pairwise Accuracy Score (no grouping): ", pairwise_acc)
        return {"pearson": pearson, "kendall_b": kendall_b,
                "pairwise_acc": pairwise_acc}

    @staticmethod
    def _filter_nan(our_scores, human_scores):
        ours, human = [], []
        for o, h in zip(our_scores, human_scores):
            if np.isnan(o):
                print(f"Warning: nan score skipped for evaluation")
                continue
            ours.append(o)
            human.append(h)
        return ours, human


class _WinogroundStyle:
    """2 images x 2 captions group accuracy (reference dataset.py:315-330)."""

    dataset_name = "Winoground-style"

    def evaluate_scores(self, scores):
        wg = get_winoground_scores(np.asarray(scores))
        acc = get_winoground_acc(wg)
        print(f"{self.dataset_name} performance (overall)")
        print(f"{'Dataset': <70} {'Text': <10} {'Image': <10} {'Group': <10}")
        print(f"{self.dataset_name: <70} {acc['text']: <10.2%} "
              f"{acc['image']: <10.2%} {acc['group']: <10.2%}")
        return {"all": acc}, wg


class Winoground(_WinogroundStyle):
    """2x2 image/caption groups with tag breakdowns
    (reference dataset.py:230-330)."""

    dataset_name = "Winoground"
    GDRIVE_ID = "1Lril_90vjsbL_2qOaxMu3I-aPpckCDiF"

    def __init__(self, image_preprocess=None, root_dir="./",
                 return_image_paths=True):
        self.root_dir = os.path.join(root_dir, "winoground")
        ensure_downloaded(
            self.root_dir,
            lambda: _gdown_zip(self.GDRIVE_ID,
                               os.path.join(root_dir, "winoground.zip"),
                               root_dir),
            "Winoground")
        self.metadata = read_csv_records(os.path.join(self.root_dir, "metadata.csv"))
        with open(os.path.join(self.root_dir, "examples.jsonl")) as f:
            self.examples = [json.loads(line) for line in f]
        self.return_image_paths = return_image_paths
        self.preprocess = image_preprocess
        self.original_tags = self._original_tags()
        self.new_tags = self._new_tags(
            os.path.join(self.root_dir, "why_winoground_hard.json"))

    def _original_tags(self):
        tags = {}
        for ex in self.examples:
            pred_tag = f"{ex['num_main_preds']} Main Pred"
            tags.setdefault(pred_tag, []).append(ex["id"])
            tags.setdefault(ex["collapsed_tag"], []).append(ex["id"])
        return tags

    def _new_tags(self, path):
        tags = {}
        for idx, curr in json.load(open(path)).items():
            if not curr:
                tags.setdefault("No Tag", []).append(int(idx))
            for tag in curr:
                tags.setdefault(tag, []).append(int(idx))
        return tags

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx):
        meta = self.metadata[idx]
        assert meta["id"] == idx
        paths = [os.path.join(self.root_dir, meta["image_0"]),
                 os.path.join(self.root_dir, meta["image_1"])]
        images = paths if self.return_image_paths else [
            self.preprocess(p) for p in paths]
        return {"images": images,
                "texts": [meta["caption_0"], meta["caption_1"]]}

    def evaluate_scores(self, scores):
        results, wg = super().evaluate_scores(scores)
        for tag, ids in {**self.original_tags, **self.new_tags}.items():
            results[tag] = get_winoground_acc([wg[i] for i in ids])
        return results


class NaturalBench_Retrieval(_WinogroundStyle):
    """NaturalBench 2x2 retrieval groups (reference dataset.py:1736-1799)."""

    dataset_name = "NaturalBench-Retrieval"
    URL = "https://huggingface.co/datasets/BaiqiL/NaturalBench/resolve/main/NaturalBench-Retrieval.zip"

    def __init__(self, root_dir="./datasets", download=True,
                 image_preprocess=None, return_image_paths=True):
        self.dataset_dir = os.path.join(root_dir, "NaturalBench-Retrieval")
        self.image_dir = os.path.join(self.dataset_dir, "images")
        ensure_downloaded(self.dataset_dir,
                          lambda: _wget_zip(self.URL, root_dir),
                          "NaturalBench-Retrieval")
        with open(os.path.join(self.dataset_dir, "metadata.json"),
                  encoding="utf-8") as f:
            self.metadata = json.load(f)
        self.return_image_paths = return_image_paths
        self.preprocess = image_preprocess

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx):
        m = self.metadata[idx]
        assert m["index"] == idx
        paths = [os.path.join(self.image_dir, m["image_0"]),
                 os.path.join(self.image_dir, m["image_1"])]
        images = paths if self.return_image_paths else [
            self.preprocess(p) for p in paths]
        return {"images": images, "texts": [m["caption_0"], m["caption_1"]]}

    def evaluate_scores(self, scores):
        results, _ = super().evaluate_scores(scores)
        return results


class EqBen_Mini(_WinogroundStyle):
    """EqBen 2x2 groups with 5 subset breakdowns
    (reference dataset.py:652-724)."""

    dataset_name = "EQBen_Mini"
    GDRIVE_ID = "11YUTf06uzRHtFV8rYi96z4vTPi8_GNEM"
    SUBSET_TYPES = {
        "eqbensd": ["eqbensd"],
        "eqbenk": ["eqbenkubric_cnt", "eqbenkubric_loc", "eqbenkubric_attr"],
        "eqbeng": ["eqbengebc"],
        "eqbenag": ["eqbenag"],
        "eqbeny": ["eqbenyoucook2"],
    }

    def __init__(self, image_preprocess=None, root_dir="./",
                 return_image_paths=True):
        base = os.path.join(root_dir, "eqben_vllm")
        ensure_downloaded(
            base,
            lambda: (os.makedirs(base, exist_ok=True),
                     _gdown_zip(self.GDRIVE_ID,
                                os.path.join(base, "eqben_vllm.zip"), base)),
            "EqBen_Mini")
        self.root_dir = os.path.join(base, "images")
        self.metadata = json.load(open(os.path.join(base, "all_select.json")))
        self.subset_indices = {t: [] for t in self.SUBSET_TYPES}
        for i, item in enumerate(self.metadata):
            prefix = item["image0"].split("/")[0]
            for t, members in self.SUBSET_TYPES.items():
                if prefix in members:
                    self.subset_indices[t].append(i)
                    break
        self.return_image_paths = return_image_paths
        self.transform = image_preprocess

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx):
        m = self.metadata[idx]
        paths = [os.path.join(self.root_dir, m["image0"]),
                 os.path.join(self.root_dir, m["image1"])]
        images = paths if self.return_image_paths else [
            self.transform(p) for p in paths]
        return {"images": images, "texts": [m["caption0"], m["caption1"]]}

    def evaluate_scores(self, scores):
        results, wg = super().evaluate_scores(scores)
        for t, ids in self.subset_indices.items():
            if ids:  # real data always populates all 5 subsets
                results[t] = get_winoground_acc([wg[i] for i in ids])
        return results


class SeeTrue(_CorrelationMixin):
    """Binary-label alignment, ROC-AUC per dataset_source
    (reference dataset.py:333-414)."""

    IMAGES_URL = "https://huggingface.co/datasets/yonatanbitton/SeeTRUE/resolve/main/images.zip"
    CSV_URL = "https://huggingface.co/datasets/yonatanbitton/SeeTRUE/resolve/main/SeeTRUE.csv"

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True):
        self.root_dir = os.path.join(root_dir, "seetrue")
        if download:
            ensure_downloaded(
                self.root_dir,
                lambda: (os.makedirs(self.root_dir, exist_ok=True),
                         _wget_zip(self.IMAGES_URL, self.root_dir)),
                "SeeTRUE images")
        csv_path = os.path.join("datasets", "SeeTRUE.csv")
        if not os.path.exists(csv_path) and download:
            _wget_zip(self.CSV_URL, "datasets", unzip=False)
        self.dataset = read_csv_records(csv_path)
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        path = os.path.join(self.root_dir, "images", self.dataset[idx]["image"])
        image = path if self.return_image_paths else self.image_preprocess(path)
        return {"images": [image], "texts": [str(self.dataset[idx]["text"])]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        ours = np.array([float(scores[i][0][0]) for i in range(len(self.dataset))])
        groups = {}
        for i, row in enumerate(self.dataset):
            groups.setdefault(row["dataset_source"], []).append(i)
        table = []
        for source in sorted(groups):   # groupby's order
            idx = groups[source]
            labels = np.array([self.dataset[i]["label"] for i in idx])
            pos = int(labels.sum())
            table.append({"dataset_source": source, "num_samples": len(idx),
                          "num_pos": pos, "num_neg": len(idx) - pos,
                          "roc_auc": roc_auc_score(labels, ours[idx])})
        print(f"{'dataset_source':<24} {'num_samples':>11} {'num_pos':>8} "
              f"{'num_neg':>8} {'roc_auc':>9}")
        for r in table:
            print(f"{r['dataset_source']:<24} {r['num_samples']:>11} {r['num_pos']:>8} "
                  f"{r['num_neg']:>8} {r['roc_auc']:>9.6f}")
        return {"per_dataset_source": table}


class TIFA160_DSG(_CorrelationMixin):
    """TIFA-160 with DSG Likert human scores (reference dataset.py:417-557)."""

    GDRIVE_ID = "1hHVMeVDZlnJz1FFhy_BxiZGIz1tEMm0s"
    MODEL_NAMES = {
        "mini-dalle": "mini_dalle",
        "vq-diffusion": "vq_diffusion",
        "sd1dot5": "stable_diffusion_v1_5",
        "sd2dot1": "stable_diffusion_v2_1",
        "sd1dot1": "stable_diffusion_v1_1",
    }

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True):
        self.root_dir = os.path.join(root_dir, "tifa160")
        if download:
            ensure_downloaded(
                self.root_dir,
                lambda: _gdown_zip(self.GDRIVE_ID,
                                   os.path.join(root_dir, "tifa160.zip"),
                                   root_dir),
                "TIFA160 images")
        self.dataset = json.load(open(os.path.join("datasets", "tifa160.json")))
        anns = read_csv_records(os.path.join("datasets", "dsg_tifa160_anns.csv"))
        keys = [f"{a['source_id']}_{self.MODEL_NAMES[a['model_type']]}" for a in anns]
        self.dsg_items = {}
        for k, ans in zip(keys, (a["answer"] for a in anns)):
            if k in self.dsg_items:
                self.dsg_items[k]["human_scores"].append(ans)
            else:
                self.dsg_items[k] = {"human_scores": [ans],
                                     "text": self.dataset[k]["text"],
                                     "image_path": f"{k}.jpg",
                                     "text_id": self.dataset[k]["text_id"]}
        for k, v in self.dsg_items.items():
            v["human_avg"] = _mean(v["human_scores"])
        self.items = list(self.dataset.keys())
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[self.items[idx]]
        path = os.path.join(self.root_dir, item["image_path"])
        image = path if self.return_image_paths else self.image_preprocess(path)
        return {"images": [image], "texts": [str(item["text"])]}

    def get_metric_scores(self, metric):
        if metric == "human_avg":
            return [self.dsg_items[k][metric] for k in self.items]
        return [self.dataset[k][metric] for k in self.items]

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        ours = [float(scores[i][0][0]) for i in range(len(self.items))]
        ours, human = self._filter_nan(ours, self.get_metric_scores("human_avg"))
        corr = self.correlation(ours, human)
        return {"pearson_no_grouping": corr["pearson"],
                "kendall_b_no_grouping": corr["kendall_b"],
                "pairwise_acc_no_grouping": corr["pairwise_acc"]}


class Flickr8K_CF(_CorrelationMixin):
    """CrowdFlower caption ratings (reference dataset.py:560-649).
    Pairwise accuracy uses sample_rate=0.1 (reference :641)."""

    GDRIVE_ID = "1WEg-xbUZ971P3Q0RDA8nVfKJrtpjTqCM"

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True, json_path="crowdflower_flickr8k.json"):
        self.root_dir = root_dir
        flickr_dir = os.path.join(root_dir, "flickr8k")
        if download:
            ensure_downloaded(
                flickr_dir,
                lambda: _gdown_zip(self.GDRIVE_ID,
                                   os.path.join(root_dir, "flickr8k.zip"),
                                   root_dir),
                "Flickr8K")
        self.dataset = json.load(open(os.path.join(flickr_dir, json_path)))
        print(f"Loaded {len(self.dataset)} images")
        self.images, self.refs, self.candidates, self.human_scores = [], [], [], []
        for k, v in self.dataset.items():
            for judgement in v["human_judgement"]:
                if np.isnan(judgement["rating"]):
                    raise ValueError(f"Human judgement score is nan for {k}")
                self.images.append(os.path.join(flickr_dir, v["image_path"]))
                self.refs.append([" ".join(gt.split()) for gt in v["ground_truth"]])
                self.candidates.append(" ".join(judgement["caption"].split()))
                self.human_scores.append(judgement["rating"])
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        path = self.images[idx]
        image = path if self.return_image_paths else self.image_preprocess(path)
        text = self.candidates[idx].strip(".").strip(" ")
        return {"images": [image], "texts": [text]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        ours = [float(scores[i][0][0]) for i in range(len(self.images))]
        ours, human = self._filter_nan(ours, self.human_scores)
        corr = self.correlation(ours, human, sample_rate=0.1)
        return {"pearson_no_grouping": corr["pearson"],
                "kendall_b_no_grouping": corr["kendall_b"],
                "pairwise_acc_no_grouping": corr["pairwise_acc"]}


class Pickapic_v1(_CorrelationMixin):
    """100 curated preference pairs, pick accuracy
    (reference dataset.py:1111-1222)."""

    URL = "https://huggingface.co/datasets/zhiqiulin/vqascore_ablation/resolve/main/pickapic_v1.zip"
    SELECTED_IDXS = [
        1, 9, 385, 14, 138, 5, 31, 33, 39, 352, 21, 417, 399, 17, 82, 412, 78,
        53, 54, 59, 60, 308, 76, 142, 98, 259, 317, 110, 113, 118, 112, 119,
        144, 148, 149, 153, 159, 162, 172, 111, 124, 196, 197, 220, 35, 141,
        252, 475, 368, 214, 150, 43, 221, 163, 228, 236, 57, 326, 257, 266,
        268, 62, 274, 277, 278, 281, 105, 285, 286, 301, 419, 91, 312, 316,
        318, 319, 334, 335, 339, 340, 347, 350, 367, 374, 375, 382, 376, 387,
        345, 405, 411, 478, 441, 444, 99, 384, 472, 479, 490, 493]

    def __init__(self, image_preprocess=None, root_dir="./",
                 return_image_paths=True, download=True):
        self.root_dir = os.path.join(root_dir, "pickapic_v1")
        if download:
            ensure_downloaded(self.root_dir,
                              lambda: _wget_zip(self.URL, root_dir),
                              "Pickapic_v1")
        all_data = json.load(open(os.path.join(self.root_dir,
                                               "test_captions.json")))
        self.dataset = []
        for new_id, sel in enumerate(self.SELECTED_IDXS):
            assert sel == all_data[sel]["id"]
            self.dataset.append({
                "id": new_id,
                "caption": all_data[sel]["caption"],
                "label_0": all_data[sel]["label_0"],
                "label_1": all_data[sel]["label_1"],
                "image_0": all_data[sel]["image_0"],
                "image_1": all_data[sel]["image_1"],
            })
        self.return_image_paths = return_image_paths
        self.preprocess = image_preprocess

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        d = self.dataset[idx]
        paths = [os.path.join(self.root_dir, d["image_0"]),
                 os.path.join(self.root_dir, d["image_1"])]
        images = paths if self.return_image_paths else [
            self.preprocess(p) for p in paths]
        return {"images": images, "texts": [d["caption"]]}

    def evaluate_scores(self, scores):
        # (B, 2 images, 1 text) -> per-sample (P(img0), P(img1))
        arr = np.swapaxes(np.asarray(scores), 1, 2)
        probs = [(arr[i][0][0], arr[i][0][1]) for i in range(len(arr))]
        correct = sum(
            int((p0 >= p1) == (d["label_0"] == 1))
            for (p0, p1), d in zip(probs, self.dataset))
        acc = correct / len(probs)
        print("ACC:", acc)
        return acc, probs


def _decode_all_frames_to_jpegs(video_path, out_dir, name_fmt):
    """Decode every frame sequentially, save JPEGs, return paths
    (reference dataset.py:805-827 flow)."""
    import cv2
    from PIL import Image

    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out_path = os.path.join(out_dir, name_fmt.format(len(frames)))
        if not os.path.exists(out_path):
            Image.fromarray(frame[:, :, ::-1]).save(out_path)
        frames.append(out_path)
    cap.release()
    return frames


def _pad_truncate(frames, num_frames):
    if len(frames) < num_frames:
        return frames + [frames[-1]] * (num_frames - len(frames))
    return frames[:num_frames]


class T2VScore(_CorrelationMixin):
    """EvalCrafter text-to-video alignment (reference dataset.py:727-932)."""

    MODELS = ["floor33", "gen2", "pika", "modelscope", "zeroscope"]
    LINKS = {
        "floor33": "https://huggingface.co/datasets/RaphaelLiu/EvalCrafter_T2V_Dataset/resolve/main/floor33.tar.gz",
        "gen2": "https://huggingface.co/datasets/RaphaelLiu/EvalCrafter_T2V_Dataset/resolve/main/gen2_december.tar.gz",
        "pika": "https://huggingface.co/datasets/RaphaelLiu/EvalCrafter_T2V_Dataset/resolve/main/pika_v1_december.tar.gz",
        "modelscope": "https://huggingface.co/datasets/RaphaelLiu/EvalCrafter_T2V_Dataset/resolve/main/modelscope.tar.gz",
        "zeroscope": "https://huggingface.co/datasets/RaphaelLiu/EvalCrafter_T2V_Dataset/resolve/main/zeroscope.tar.gz",
    }

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True, image_save_dir="t2vscore_images",
                 num_frames=36, eval_mode="avg_frames", extract_videos=False):
        self.root_dir = os.path.join(root_dir, "t2vscore")
        self.eval_mode = eval_mode
        if download:
            ensure_downloaded(self.root_dir, lambda: self._fetch(), "T2VScore")
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths
        self.image_save_dir = os.path.join(root_dir, image_save_dir)
        os.makedirs(self.image_save_dir, exist_ok=True)
        self.dataset = json.load(open(
            os.path.join("datasets", "t2vscore_alignment_score.json")))
        self.dataset_quality = json.load(open(
            os.path.join("datasets", "t2vscore_quality_score.json")))

        vids_file = os.path.join(self.root_dir, "t2v_videos.json")
        p2v_file = os.path.join(self.root_dir, "t2v_prompt_to_videos.json")
        if (os.path.exists(vids_file) and os.path.exists(p2v_file)
                and not extract_videos):
            self.videos = json.load(open(vids_file))
            self.prompt_to_videos = json.load(open(p2v_file))
            return

        self.videos, self.prompt_to_videos = [], {}
        for model in self.MODELS:
            model_dir = os.path.join(self.image_save_dir, model)
            os.makedirs(model_dir, exist_ok=True)
            for prompt_idx in self.dataset:
                entry = self.dataset[prompt_idx]["models"]
                if model not in entry or not entry[model]:
                    continue
                video_path = os.path.join(self.root_dir, model,
                                          f"{int(prompt_idx):04d}.mp4")
                frames = _decode_all_frames_to_jpegs(
                    video_path, model_dir,
                    f"video_{int(prompt_idx):04d}_frame_{{:04d}}.jpg")
                frames = _pad_truncate(frames, num_frames)
                sample4 = [frames[0], frames[num_frames // 3],
                           frames[num_frames // 3 * 2], frames[-1]]
                self.videos.append({
                    "prompt_idx": prompt_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "model": model,
                    "video_path": video_path,
                    "num_frames": len(frames),
                    "frames": frames,
                    "sample_4_frames": sample4,
                    "human_alignment": entry[model],
                    "human_quality": self.dataset_quality[prompt_idx]["models"][model],
                })
                self.prompt_to_videos.setdefault(prompt_idx, []).append(
                    len(self.videos) - 1)
        json.dump(self.videos, open(vids_file, "w"))
        json.dump(self.prompt_to_videos, open(p2v_file, "w"))

    def _fetch(self):  # pragma: no cover
        os.makedirs(self.root_dir, exist_ok=True)
        for model in self.MODELS:
            name = self.LINKS[model].split("/")[-1]
            _call(["wget", self.LINKS[model], "-O", name], cwd=self.root_dir)
            _call(["tar", "-xvf", name], cwd=self.root_dir)
            extracted = name.split(".tar.gz")[0]
            if extracted == "pika_v1_december":
                extracted = "pika_v1_december_1"
            if extracted != model:
                _call(["mv", extracted, model], cwd=self.root_dir)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        item = self.videos[idx]
        paths = item["frames"]
        if self.eval_mode == "first_frame":
            paths = [paths[0]]
        elif self.eval_mode == "last_frame":
            paths = [paths[-1]]
        elif self.eval_mode == "sample_4_frame":
            paths = item["sample_4_frames"]
        elif self.eval_mode != "avg_frames":
            raise ValueError(f"Invalid eval_mode: {self.eval_mode}")
        images = paths if self.return_image_paths else [
            self.image_preprocess(p) for p in paths]
        return {"images": images, "texts": [str(item["prompt"])]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        human = [_mean(v["human_alignment"]) for v in self.videos]
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.videos))]
        return {"alignment": self.correlation(ours, human)}


class StanfordT23D(_CorrelationMixin):
    """Stanford text-to-3D multi-view grids (reference dataset.py:935-1108)."""

    MODELS = ["dreamfusion", "instant3d", "latent-nerf", "magic3d", "mvdream",
              " shap-e"]
    VIEWS_FOUR = [5, 35, 65, 95]
    VIEWS_NINE = [2, 15, 28, 41, 54, 67, 80, 93, 106]
    URL = "https://huggingface.co/datasets/zhiqiulin/vqascore_ablation/resolve/main/stanfordt23d.zip"

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True, image_save_dir="stanfordt23d_images",
                 num_views=120, eval_mode="rgb_grid_3_x_3",
                 extract_images=False):
        from PIL import Image

        self.root_dir = os.path.join(root_dir, "stanfordt23d")
        self.eval_mode = eval_mode
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths
        self.image_save_dir = os.path.join(root_dir, image_save_dir)
        os.makedirs(self.image_save_dir, exist_ok=True)
        if download:
            ensure_downloaded(self.root_dir,
                              lambda: _wget_zip(self.URL, root_dir),
                              "StanfordT23D")
        self.dataset = json.load(open(os.path.join("datasets",
                                                   "stanfordt23d.json")))
        imgs_file = os.path.join(self.root_dir, "stanfordt23d_images.json")
        p2i_file = os.path.join(self.root_dir,
                                "stanfordt23d_prompt_to_images.json")
        if (os.path.exists(imgs_file) and os.path.exists(p2i_file)
                and not extract_images):
            self.images = json.load(open(imgs_file))
            self.prompt_to_images = json.load(open(p2i_file))
            return

        self.images, self.prompt_to_images = [], {}
        for model in self.MODELS:
            model_dir = os.path.join(self.image_save_dir, model)
            os.makedirs(model_dir, exist_ok=True)
            for prompt_idx in self.dataset:
                entry = self.dataset[prompt_idx]["models"]
                if model not in entry or not entry[model]:
                    continue
                folder = os.path.join(self.root_dir, model, str(prompt_idx), "0")
                rgb = [os.path.join(folder, f"rgb_{v}.jpg")
                       for v in range(num_views)]
                normal = [os.path.join(folder, f"normal_{v}.jpg")
                          for v in range(num_views)]
                record = {
                    "prompt_idx": prompt_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "model": model,
                    "folder_path": folder,
                    "num_views": num_views,
                    "rgb_views": rgb,
                    "normal_views": normal,
                    "human_alignment": entry[model],
                }
                for kind, views in (("rgb", rgb), ("normal", normal)):
                    record[f"sample_4_{kind}_views"] = [views[v] for v in self.VIEWS_FOUR]
                    record[f"sample_9_{kind}_views"] = [views[v] for v in self.VIEWS_NINE]
                    for grid, sample in ((2, record[f"sample_4_{kind}_views"]),
                                         (3, record[f"sample_9_{kind}_views"])):
                        out = os.path.join(
                            model_dir,
                            f"{kind}_{int(prompt_idx)}_grid_{grid}x{grid}.jpg")
                        if not os.path.exists(out):
                            w, h = Image.open(sample[0]).size
                            canvas = Image.new("RGB", (w * grid, h * grid))
                            for gi in range(grid * grid):
                                tile = Image.open(sample[gi]).convert("RGB")
                                canvas.paste(tile, (w * (gi % grid),
                                                    h * (gi // grid)))
                            canvas.save(out)
                        record[f"{kind}_grid_{grid}_x_{grid}"] = [out]
                self.images.append(record)
                self.prompt_to_images.setdefault(prompt_idx, []).append(
                    len(self.images) - 1)
        json.dump(self.images, open(imgs_file, "w"))
        json.dump(self.prompt_to_images, open(p2i_file, "w"))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        item = self.images[idx]
        assert self.eval_mode in item, f"Invalid eval_mode: {self.eval_mode}"
        paths = item[self.eval_mode]
        images = paths if self.return_image_paths else [
            self.image_preprocess(p) for p in paths]
        return {"images": images, "texts": [str(item["prompt"])]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        human = [_mean(v["human_alignment"]) for v in self.images]
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.images))]
        return {"alignment": self.correlation(ours, human)}


class GenAIBench_Image(_CorrelationMixin):
    """GenAI-Bench image alignment: 527/1600 prompts x 6 models
    (reference dataset.py:1225-1391)."""

    MODELS = ["DALLE_3", "SDXL_Turbo", "DeepFloyd_I_XL_v1", "Midjourney_6",
              "SDXL_2_1", "SDXL_Base"]

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 num_prompts=1600, return_image_paths=True):
        assert num_prompts in (527, 1600), \
            "num_prompts must be 527 (VQAScore paper) or 1600 (GenAI-Bench paper)"
        self.root_dir = os.path.join(root_dir, f"GenAI-Image-{num_prompts}")
        repo = ("zhiqiulin/GenAI-Bench-527" if num_prompts == 527
                else "BaiqiL/GenAI-Bench-1600")
        if download:
            ensure_downloaded(self.root_dir,
                              lambda: self._fetch(repo), "GenAIBench_Image")
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths
        self.dataset = json.load(open(os.path.join(self.root_dir,
                                                   "genai_image.json")))
        print("Loaded dataset: genai_image.json")
        self.images, self.prompt_to_images = [], {}
        for model in self.MODELS:
            for prompt_idx in self.dataset:
                if model not in self.dataset[prompt_idx]["models"]:
                    continue
                self.images.append({
                    "prompt_idx": prompt_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "model": model,
                    "image": os.path.join(self.root_dir, model,
                                          f"{prompt_idx}.jpeg"),
                    "human_alignment": self.dataset[prompt_idx]["models"][model],
                })
                self.prompt_to_images.setdefault(prompt_idx, []).append(
                    len(self.images) - 1)

    def _fetch(self, repo):  # pragma: no cover
        os.makedirs(self.root_dir, exist_ok=True)
        for model in self.MODELS:
            _wget_zip(f"https://huggingface.co/datasets/{repo}/resolve/main/{model}.zip",
                      self.root_dir)
        for filename in ("genai_image", "genai_skills"):
            _wget_zip(f"https://huggingface.co/datasets/{repo}/resolve/main/{filename}.json",
                      self.root_dir, unzip=False)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        item = self.images[idx]
        paths = [item["image"]]
        images = paths if self.return_image_paths else [
            self.image_preprocess(p) for p in paths]
        return {"images": images, "texts": [str(item["prompt"])]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        human = [_mean(v["human_alignment"]) for v in self.images]
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.images))]
        return {"alignment": self.correlation(ours, human)}

    def evaluate_scores_per_skill(self, scores):
        scores = np.asarray(scores)
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.images))]
        human = [_mean(v["human_alignment"]) for v in self.images]
        tags = json.load(open(os.path.join(self.root_dir, "genai_skills.json")))
        tag_results = {}
        for tag, prompt_ids in tags.items():
            idxs = [i for p in prompt_ids
                    for i in self.prompt_to_images[f"{p:05d}"]]
            o = [ours[i] for i in idxs]
            h = [human[i] for i in idxs]
            tag_results[tag] = {"alignment": {
                "pearson": calc_pearson(h, o),
                "kendall_b": calc_metric(h, o, variant="tau_b"),
                "pairwise_acc": calc_metric(
                    h, o, variant="pairwise_acc_with_tie_optimization"),
            }}
        col = 15
        header = f"{'Metrics':<{col}}" + " ".join(
            f"{t:<{col}}" for t in tag_results)
        print(header)
        print("-" * len(header))
        for metric in ("pearson", "kendall_b", "pairwise_acc"):
            vals = [tag_results[t]["alignment"][metric][0]
                    if metric == "pairwise_acc"
                    else tag_results[t]["alignment"][metric]
                    for t in tag_results]
            print(f"{metric:<{col}}" + " ".join(f"{v:<{col}.2f}" for v in vals))
        return tag_results


class GenAIBench_Video(_CorrelationMixin):
    """GenAI-Bench video alignment: 527/800 prompts x 4 T2V models
    (reference dataset.py:1393-1578)."""

    MODELS = ["Floor33", "Gen2", "Pika_v1", "Modelscope"]

    def __init__(self, image_preprocess=None, root_dir="./", download=True,
                 return_image_paths=True,
                 image_save_dir="genai_video_{}_extracted_images",
                 num_prompts=527, num_frames=36, eval_mode="avg_frames",
                 extract_videos=False):
        self.root_dir = os.path.join(root_dir, f"GenAI-Video-{num_prompts}")
        print(f"Root dir: {self.root_dir}")
        self.eval_mode = eval_mode
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths
        self.image_save_dir = os.path.join(root_dir,
                                           image_save_dir.format(num_prompts))
        os.makedirs(self.image_save_dir, exist_ok=True)
        repo = f"zhiqiulin/GenAI-Bench-{num_prompts}"
        if download:
            ensure_downloaded(self.root_dir, lambda: self._fetch(repo),
                              "GenAIBench_Video")
        self.dataset = json.load(open(os.path.join(self.root_dir,
                                                   "genai_video.json")))
        vids_file = os.path.join(self.root_dir,
                                 "genai_videos_extracted_images.json")
        p2v_file = os.path.join(self.root_dir, "genai_prompt_to_videos.json")
        if (os.path.exists(vids_file) and os.path.exists(p2v_file)
                and not extract_videos):
            self.videos = json.load(open(vids_file))
            self.prompt_to_videos = json.load(open(p2v_file))
            return

        self.videos, self.prompt_to_videos = [], {}
        for model in self.MODELS:
            model_dir = os.path.join(self.image_save_dir, model)
            os.makedirs(model_dir, exist_ok=True)
            for prompt_idx in self.dataset:
                if model not in self.dataset[prompt_idx]["models"]:
                    continue
                video_path = os.path.join(self.root_dir, model,
                                          f"{prompt_idx}.mp4")
                frames = _decode_all_frames_to_jpegs(
                    video_path, model_dir,
                    f"video_{prompt_idx}_frame_{{:04d}}.jpg")
                if not frames:
                    raise MediaError(f"no frames decoded from {video_path}")
                frames = _pad_truncate(frames, num_frames)
                self.videos.append({
                    "prompt_idx": prompt_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "model": model,
                    "video_path": video_path,
                    "num_frames": len(frames),
                    "frames": frames,
                    "human_alignment": self.dataset[prompt_idx]["models"][model],
                })
                self.prompt_to_videos.setdefault(prompt_idx, []).append(
                    len(self.videos) - 1)
        json.dump(self.videos, open(vids_file, "w"))
        json.dump(self.prompt_to_videos, open(p2v_file, "w"))

    def _fetch(self, repo):  # pragma: no cover
        os.makedirs(self.root_dir, exist_ok=True)
        for model in self.MODELS:
            _wget_zip(f"https://huggingface.co/datasets/{repo}/resolve/main/{model}.zip",
                      self.root_dir)
        for filename in ("genai_video", "genai_skills"):
            _wget_zip(f"https://huggingface.co/datasets/{repo}/resolve/main/{filename}.json",
                      self.root_dir, unzip=False)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        item = self.videos[idx]
        paths = item["frames"]
        if self.eval_mode == "sample_4_frame":
            paths = [paths[i] for i in (0, 8, 16, 24)]
        elif self.eval_mode == "sample_9_frame":
            paths = [paths[i] for i in (0, 4, 8, 12, 16, 20, 24, 28, 32)]
        elif self.eval_mode != "avg_frames":
            raise ValueError(f"Invalid eval_mode: {self.eval_mode}")
        images = paths if self.return_image_paths else [
            self.image_preprocess(p) for p in paths]
        return {"images": images, "texts": [str(item["prompt"])]}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        human = [_mean(v["human_alignment"]) for v in self.videos]
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.videos))]
        return {"alignment": self.correlation(ours, human)}


class GenAIBench_Ranking(_CorrelationMixin):
    """800 prompts x 9 images/gen-model, rank-by-score vs human oracle
    (reference dataset.py:1583-1733)."""

    def __init__(self, gen_model="DALLE_3", image_preprocess=None,
                 root_dir="./datasets", download=True, return_image_paths=True):
        assert gen_model in ("DALLE_3", "SDXL_Base"), "Invalid gen_model"
        self.gen_model = gen_model
        self.root_dir = os.path.join(root_dir, "GenAI-Image-Ranking-800")
        self.image_preprocess = image_preprocess
        self.return_image_paths = return_image_paths
        if download:
            ensure_downloaded(os.path.join(self.root_dir, gen_model),
                              lambda: self._fetch(), "GenAIBench_Ranking")
        self.dataset = json.load(open(os.path.join(self.root_dir,
                                                   "human_rating.json")))
        print("Loaded dataset from: human_rating.json")
        self.images, self.images_to_prompt_idx = [], []
        for prompt_idx in self.dataset:
            assert prompt_idx == self.dataset[prompt_idx]["id"]
            ratings = self.dataset[prompt_idx]["models"][self.gen_model]
            for img_idx in range(1, 10):
                self.images.append({
                    "prompt_idx": prompt_idx,
                    "img_idx": img_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "model": self.gen_model,
                    "image": os.path.join(
                        self.root_dir, self.gen_model,
                        f"{int(prompt_idx):05d}_{img_idx:02d}.jpeg"),
                    "human_score": _mean(ratings[str(img_idx)]),
                })
            self.images_to_prompt_idx.append(int(prompt_idx))

    def _fetch(self):  # pragma: no cover
        os.makedirs(self.root_dir, exist_ok=True)
        base = "https://huggingface.co/datasets/zhiqiulin/GenAI-Image-Ranking-800/resolve/main"
        _wget_zip(f"{base}/{self.gen_model}.zip", self.root_dir)
        for filename in ("human_rating", "genai_skills"):
            _wget_zip(f"{base}/{filename}.json", self.root_dir, unzip=False)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        item = self.images[idx]
        paths = [item["image"]]
        images = paths if self.return_image_paths else [
            self.image_preprocess(p) for p in paths]
        return {"images": images, "texts": [str(item["prompt"])]}

    def correlation(self, our_scores, human_scores):
        pearson = calc_pearson(human_scores, our_scores)
        print("Pearson's Correlation (no grouping): ", pearson)
        kendall_b = calc_metric(human_scores, our_scores, variant="tau_b")
        print("Kendall Tau-B Score (no grouping): ", kendall_b)

        ours = np.array(our_scores).reshape(-1, 9)
        human = np.array(human_scores).reshape(-1, 9)
        rows = np.arange(len(ours))
        hi = np.argmax(human, axis=1)
        lo = np.argmin(human, axis=1)
        ranking_acc = ours[rows, hi] > ours[rows, lo]
        print(f"Ranking accuracy for human argmax and argmin: "
              f"{ranking_acc.mean()}")
        perfect = np.where(human[rows, hi] == 5.0)[0]
        print(f"Ranking accuracy for {len(perfect)} pairs with 5.0 human "
              f"score: {ranking_acc[perfect].mean()}")
        return {"pearson": pearson, "kendall_b": kendall_b,
                "ranking_accuracy": ranking_acc}

    def evaluate_scores(self, scores):
        scores = np.asarray(scores)
        human = [v["human_score"] for v in self.images]
        ours = scores.mean(axis=1)
        ours = [float(ours[i][0]) for i in range(len(self.images))]
        return self.correlation(ours, human)
