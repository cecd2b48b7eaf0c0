"""CameraBench Stage 2: VQA + retrieval evaluation
(reference camerabench/vqa_and_retrieval_evaluation.py). The port's copy of
t2v_metrics_tpu/camerabench/vqa_and_retrieval_evaluation.py.

Metrics preserved:
  * VQA binary_acc — four independent Yes-vs-No comparisons per sample
    (:95-101);
  * VQA question_acc — both images right per question (:103-111);
  * Winoground-style retrieval text/image/group from yes-scores (:119-153).
"""

import argparse
import json
from pathlib import Path

import numpy as np


def load_score_file(score_file):
    with open(score_file) as f:
        return json.load(f)


def extract_score_matrices(score_data):
    yes_scores, no_scores = [], []
    order = ("pos_text_pos_image", "pos_text_neg_image",
             "neg_text_pos_image", "neg_text_neg_image")
    for r in score_data["scores"]:
        if r["error"] is None:
            yes_scores.append([r["yes_scores"][k] for k in order])
            no_scores.append([r["no_scores"][k] for k in order])
    return np.array(yes_scores), np.array(no_scores)


def compute_retrieval_scores_from_vqa(yes_scores):
    keys = ("pos_text_pos_image", "pos_text_neg_image",
            "neg_text_pos_image", "neg_text_neg_image")
    return [dict(zip(keys, row)) for row in yes_scores]


def evaluate_vqa_metrics(yes_scores, no_scores):
    if len(yes_scores) == 0:
        return {"binary_acc": 0.0, "question_acc": 0.0, "num_samples": 0}
    binary = questions = 0
    for y, n in zip(yes_scores, no_scores):
        # order: [p_t p_i, p_t n_i, n_t p_i, n_t n_i]
        checks = [y[0] > n[0],   # pos text + pos image: Yes wins
                  n[1] > y[1],   # pos text + neg image: No wins
                  n[2] > y[2],   # neg text + pos image: No wins
                  y[3] > n[3]]   # neg text + neg image: Yes wins
        binary += sum(checks)
        questions += int(checks[0] and checks[1]) + int(checks[2] and checks[3])
    total = len(yes_scores)
    return {"binary_acc": binary / (4 * total),
            "question_acc": questions / (2 * total),
            "num_samples": total}


def evaluate_retrieval_metrics(scores):
    if len(scores) == 0:
        return {"text": 0.0, "image": 0.0, "group": 0.0, "num_samples": 0}

    def text_ok(r):
        return (r["pos_text_pos_image"] > r["neg_text_pos_image"]
                and r["neg_text_neg_image"] > r["pos_text_neg_image"])

    def image_ok(r):
        return (r["pos_text_pos_image"] > r["pos_text_neg_image"]
                and r["neg_text_neg_image"] > r["neg_text_pos_image"])

    t = sum(text_ok(r) for r in scores)
    i = sum(image_ok(r) for r in scores)
    g = sum(text_ok(r) and image_ok(r) for r in scores)
    n = len(scores)
    return {"text": t / n, "image": i / n, "group": g / n, "num_samples": n}


def evaluate_single_file(score_file, mode="both", quiet=False):
    if not quiet:
        print(f"\nEvaluating: {score_file}")
    data = load_score_file(score_file)
    yes_scores, no_scores = extract_score_matrices(data)
    meta = data.get("metadata", {})
    out = {"method": meta.get("model_name", "unknown"),
           "skill": meta.get("skill_name", Path(score_file).stem)}
    if mode in ("vqa", "both"):
        out["vqa"] = evaluate_vqa_metrics(yes_scores, no_scores)
        if not quiet:
            print(f"  VQA: binary_acc={out['vqa']['binary_acc']:.4f} "
                  f"question_acc={out['vqa']['question_acc']:.4f}")
    if mode in ("retrieval", "both"):
        retrieval = compute_retrieval_scores_from_vqa(yes_scores)
        out["retrieval"] = evaluate_retrieval_metrics(retrieval)
        if not quiet:
            r = out["retrieval"]
            print(f"  Retrieval: text={r['text']:.4f} image={r['image']:.4f} "
                  f"group={r['group']:.4f}")
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scores_dir", type=str, default="scores")
    parser.add_argument("--score_files", type=str, nargs="+", default=None)
    parser.add_argument("--mode", type=str, default="both",
                        choices=["vqa", "retrieval", "both"])
    parser.add_argument("--output_file", type=str,
                        default="vqa_retrieval_summary.json")
    args = parser.parse_args()

    files = (args.score_files if args.score_files else
             sorted(Path(args.scores_dir).glob("vqa_retrieval_scores_*.json")))
    if not files:
        print(f"No score files found in {args.scores_dir}")
        return
    results = [evaluate_single_file(f, args.mode) for f in files]
    with open(args.output_file, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nSummary saved to {args.output_file}")


if __name__ == "__main__":
    main()
