"""CameraBench Stage 2: method-agnostic binary-classification evaluation
(reference camerabench/binary_classification_evaluation.py). The port's
copy of t2v_metrics_tpu/camerabench/binary_classification_evaluation.py:
average precision, ROC-AUC and the curves come from
``benchmarks/stats.py`` (sklearn's definitions; the GPU machine has no
sklearn), matplotlib is imported only to draw the plots.

Consumes any ``classification_scores_*.json`` matching the Stage-1 contract;
reports mAP (average precision) + ROC-AUC per split, with optional PR/ROC
plots and a hierarchical per-method report."""

import argparse
import json
import os
from pathlib import Path

import numpy as np

from ..benchmarks.stats import (average_precision_score, precision_recall_curve,
                                roc_auc_score, roc_curve)


def load_score_file(path):
    with open(path) as f:
        return json.load(f)


def extract_scores_and_labels(score_data):
    """Only error-free samples count (reference :25-36)."""
    scores, labels = [], []
    for r in score_data["scores"]:
        if r["error"] is None:
            scores.append(r["score"])
            labels.append(1 if r["ground_truth_label"].lower() == "yes" else 0)
    return np.array(scores), np.array(labels)


def compute_binary_classification_metrics(scores, labels):
    if len(np.unique(labels)) < 2:
        print("Warning: Only one class present in labels")
        return {"average_precision": 0.0, "roc_auc": 0.0,
                "num_samples": len(scores),
                "num_positive": int(np.sum(labels == 1)),
                "num_negative": int(np.sum(labels == 0))}
    scores = np.where(np.isfinite(scores), scores, -1e10)
    n = len(scores)
    npos = int(np.sum(labels == 1))
    return {
        "average_precision": float(average_precision_score(labels, scores)),
        "roc_auc": float(roc_auc_score(labels, scores)),
        "num_samples": int(n),
        "num_positive": npos,
        "num_negative": int(n - npos),
        "positive_ratio": float(npos / n) if n else 0.0,
    }


def generate_plots(scores, labels, output_dir, method_name, split_name):
    if len(np.unique(labels)) < 2:
        print("Cannot generate plots: only one class present")
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plots_dir = Path(output_dir) / "plots"
    plots_dir.mkdir(exist_ok=True)
    precision, recall, _ = precision_recall_curve(labels, scores)
    fpr, tpr, _ = roc_curve(labels, scores)
    plt.figure(figsize=(10, 4))
    plt.subplot(1, 2, 1)
    plt.plot(recall, precision, "b-", linewidth=2)
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.title(f"Precision-Recall Curve\n{method_name} - {split_name}")
    plt.grid(True, alpha=0.3)
    plt.subplot(1, 2, 2)
    plt.plot(fpr, tpr, "r-", linewidth=2)
    plt.plot([0, 1], [0, 1], "k--", alpha=0.5)
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.title(f"ROC Curve\n{method_name} - {split_name}")
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plot_path = plots_dir / f"{method_name}_{split_name}_curves.png"
    plt.savefig(plot_path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Plots saved to: {plot_path}")


def evaluate_single_file(score_file, generate_plots_flag=False,
                         output_dir=None, quiet=False):
    if not quiet:
        print(f"\nEvaluating: {score_file}")
    data = load_score_file(score_file)
    scores, labels = extract_scores_and_labels(data)
    metrics = compute_binary_classification_metrics(scores, labels)
    meta = data.get("metadata", {})
    method = meta.get("model_name", "unknown")
    split = meta.get("split_name", Path(score_file).stem)
    if not quiet:
        print(f"  mAP: {metrics['average_precision']:.4f}  "
              f"ROC-AUC: {metrics['roc_auc']:.4f}  "
              f"({metrics['num_samples']} samples, "
              f"{metrics['num_positive']} pos)")
    if generate_plots_flag and output_dir:
        generate_plots(scores, labels, output_dir, method, split)
    return {"method": method, "split": split, **metrics}


def discover_score_files(scores_dir):
    """Auto-discovery of classification_scores_*.json (reference :283-293)."""
    return sorted(Path(scores_dir).glob("classification_scores_*.json"))


def hierarchical_report(results):
    """Per-method summary over splits (reference :224-281)."""
    by_method = {}
    for r in results:
        by_method.setdefault(r["method"], []).append(r)
    print(f"\n{'=' * 70}\nHIERARCHICAL REPORT\n{'=' * 70}")
    for method, rs in by_method.items():
        maps = [r["average_precision"] for r in rs]
        aucs = [r["roc_auc"] for r in rs]
        print(f"\nMethod: {method} ({len(rs)} splits)")
        print(f"  mean mAP:     {np.mean(maps):.4f}")
        print(f"  mean ROC-AUC: {np.mean(aucs):.4f}")
        for r in sorted(rs, key=lambda x: x["split"]):
            print(f"    {r['split']:<40} mAP={r['average_precision']:.4f} "
                  f"auc={r['roc_auc']:.4f}")
    return by_method


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scores_dir", type=str, default="scores")
    parser.add_argument("--score_files", type=str, nargs="+", default=None)
    parser.add_argument("--generate_plots", action="store_true")
    parser.add_argument("--output_dir", type=str, default="evaluation_results")
    args = parser.parse_args()

    files = (args.score_files if args.score_files
             else discover_score_files(args.scores_dir))
    if not files:
        print(f"No score files found in {args.scores_dir}")
        return
    os.makedirs(args.output_dir, exist_ok=True)
    results = [evaluate_single_file(f, args.generate_plots, args.output_dir)
               for f in files]
    hierarchical_report(results)
    out = Path(args.output_dir) / "binary_classification_summary.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nSummary saved to {out}")


if __name__ == "__main__":
    main()
