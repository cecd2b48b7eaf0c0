"""CameraBench Stage 1: VQAScore generation over binary-classification
splits (reference camerabench/binary_classification_vlm_scores.py). The port's
copy of t2v_metrics_tpu/camerabench/binary_classification_vlm_scores.py.

JSON contract preserved exactly: output is
``{"metadata": {...}, "scores": [{"video_path", "question",
"ground_truth_label", "method", "score", "error"}, ...]}`` with missing
videos / unreadable media (``MediaError``) recorded as error strings +
score 0.0, and the default
question template ``"{} Please only answer Yes or No."``.
"""

import argparse
import json
import os
from datetime import datetime
from pathlib import Path

import t2v_metrics_tpu_torch as t2v

from ..media.video import MediaError


def load_jsonl_data(file_path):
    with open(file_path) as f:
        return [json.loads(line.strip()) for line in f if line.strip()]


def generate_vqa_scores(data, model_name, video_base_path, checkpoint_name=None,
                        question_template="{} Please only answer Yes or No.",
                        answer_template="Yes", scorer=None):
    print(f"Initializing VQAScore model: {model_name}")
    if scorer is None:
        kwargs = {"checkpoint": checkpoint_name} if checkpoint_name else {}
        scorer = t2v.VQAScore(model=model_name, **kwargs)

    method = model_name + (f"_{checkpoint_name}" if checkpoint_name else "")
    results = []
    for item in data:
        video_path = item["image"]  # 'image' key carries the video path
        entry = {
            "video_path": video_path,
            "question": item["question"],
            "ground_truth_label": item["label"],
            "method": method,
            "score": None,
            "error": None,
        }
        full = os.path.join(video_base_path, video_path)
        if not os.path.exists(full):
            print(f"Warning: Video not found: {full}")
            entry["error"] = f"Video file not found: {full}"
            entry["score"] = 0.0
            results.append(entry)
            continue
        try:
            score = scorer(images=[full], texts=[item["question"]],
                           question_template=question_template,
                           answer_template=answer_template)
            entry["score"] = float(score[0][0])
        except MediaError as e:
            print(f"Error processing {full}: {e}")
            entry["error"] = str(e)
            entry["score"] = 0.0
        results.append(entry)
    return results


def save_scores(results, output_file, metadata=None):
    with open(output_file, "w") as f:
        json.dump({"metadata": metadata or {}, "scores": results}, f, indent=2)
    print(f"Scores saved to: {output_file}")


def generate_output_filename(model_name, checkpoint_name, split_name):
    clean = lambda s: s.replace("/", "_").replace("\\", "_").replace(":", "_")
    parts = ["classification_scores", clean(model_name)]
    if checkpoint_name:
        parts.append(clean(checkpoint_name))
    parts.append(split_name)
    return "_".join(parts) + ".json"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=False)
    parser.add_argument("--data_dir", type=str, default="data/binary_classification")
    parser.add_argument("--video_dir", type=str, default="data/videos")
    parser.add_argument("--splits", type=str, nargs="+", default=None)
    parser.add_argument("--question_template", type=str,
                        default="{} Please only answer Yes or No.")
    parser.add_argument("--answer_template", type=str, default="Yes")
    parser.add_argument("--output_dir", type=str, default="scores")
    args = parser.parse_args()

    output_dir = Path(args.output_dir)
    output_dir.mkdir(exist_ok=True)
    data_dir = Path(args.data_dir)
    if args.splits:
        jsonl_files = [(s, data_dir / f"{s}.jsonl") for s in args.splits
                       if (data_dir / f"{s}.jsonl").exists()]
    else:
        jsonl_files = [(f.stem, f) for f in data_dir.glob("*.jsonl")]
    if not jsonl_files:
        print(f"No JSONL files found in {data_dir}")
        return
    print(f"Found {len(jsonl_files)} JSONL files to process")

    for split_name, jsonl_file in jsonl_files:
        print(f"\n{'=' * 60}\nPROCESSING SPLIT: {split_name}\n{'=' * 60}")
        data = load_jsonl_data(jsonl_file)
        print(f"Loaded {len(data)} samples from {jsonl_file}")
        if not data:
            continue
        results = generate_vqa_scores(data, args.model, args.video_dir,
                                      args.checkpoint, args.question_template,
                                      args.answer_template)
        metadata = {
            "model_name": args.model,
            "checkpoint": args.checkpoint,
            "split_name": split_name,
            "data_file": str(jsonl_file),
            "video_dir": args.video_dir,
            "question_template": args.question_template,
            "answer_template": args.answer_template,
            "generation_timestamp": datetime.now().isoformat(),
            "method_type": "VQAScore_LMM",
        }
        out = output_dir / generate_output_filename(args.model,
                                                    args.checkpoint, split_name)
        save_scores(results, out, metadata)


if __name__ == "__main__":
    main()
