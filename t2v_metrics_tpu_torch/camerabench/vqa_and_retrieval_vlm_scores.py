"""CameraBench Stage 1: VQA + retrieval score generation
(reference camerabench/vqa_and_retrieval_vlm_scores.py). The port's copy of
t2v_metrics_tpu/camerabench/vqa_and_retrieval_vlm_scores.py.

For each (pos_video, neg_video, pos_question, neg_question) sample computes
8 scores — the 2x2 {text, image} grid with both "Yes" and "No" answer
templates — and writes the standardized JSON contract (yes_scores /
no_scores dicts; a sample whose media cannot be read (``MediaError``) is
recorded with its error and scores 0.0)."""

import argparse
import json
import os
from collections import defaultdict
from datetime import datetime
from pathlib import Path

import t2v_metrics_tpu_torch as t2v

from ..media.video import MediaError

_DEFAULT_SCORES = {
    "pos_text_pos_image": 0.0,
    "pos_text_neg_image": 0.0,
    "neg_text_pos_image": 0.0,
    "neg_text_neg_image": 0.0,
}


def load_jsonl_data(file_path):
    with open(file_path) as f:
        return [json.loads(line.strip()) for line in f if line.strip()]


def load_data_by_skill(data_dir, specific_skill=None):
    """skill dir -> task jsonl files -> samples (reference :25-52)."""
    data_dir = Path(data_dir)
    skill_data = defaultdict(lambda: defaultdict(list))
    if specific_skill:
        skill_dir = data_dir / specific_skill.replace(" ", "_").replace("/", "_")
        dirs = [skill_dir] if skill_dir.exists() else []
        if not dirs:
            print(f"Warning: Skill directory not found: {skill_dir}")
    else:
        dirs = [d for d in data_dir.iterdir() if d.is_dir()]
    for skill_dir in dirs:
        skill_name = (specific_skill if specific_skill
                      else skill_dir.name.replace("_", " "))
        for task_file in skill_dir.glob("*.jsonl"):
            task_name = task_file.stem.replace("_", " ")
            samples = load_jsonl_data(task_file)
            skill_data[skill_name][task_name] = samples
            print(f"Loaded {len(samples)} samples for {skill_name} -> {task_name}")
    return skill_data


def generate_vqa_retrieval_scores(samples, model, video_base_path,
                                  question_template="{}", method_name=""):
    results = []
    for sample in samples:
        pos_video, neg_video = sample["pos_video"], sample["neg_video"]
        pos_q = sample.get("pos_question", sample.get("pos_text"))
        neg_q = sample.get("neg_question", sample.get("neg_text"))
        entry = {"pos_video": pos_video, "neg_video": neg_video,
                 "pos_question": pos_q, "neg_question": neg_q,
                 "method": method_name, "yes_scores": None,
                 "no_scores": None, "error": None}
        full_pos = os.path.join(video_base_path, pos_video)
        full_neg = os.path.join(video_base_path, neg_video)
        missing = next((p for p in (full_pos, full_neg)
                        if not os.path.exists(p)), None)
        if missing:
            print(f"Warning: Video not found: {missing}")
            entry["error"] = f"Video file not found: {missing}"
            entry["yes_scores"] = dict(_DEFAULT_SCORES)
            entry["no_scores"] = dict(_DEFAULT_SCORES)
            results.append(entry)
            continue
        try:
            out = {}
            for ans in ("Yes", "No"):
                kw = {"question_template": question_template,
                      "answer_template": ans}
                out[ans] = {
                    "pos_text_pos_image": float(model(images=[full_pos], texts=[pos_q], **kw)[0][0]),
                    "pos_text_neg_image": float(model(images=[full_neg], texts=[pos_q], **kw)[0][0]),
                    "neg_text_pos_image": float(model(images=[full_pos], texts=[neg_q], **kw)[0][0]),
                    "neg_text_neg_image": float(model(images=[full_neg], texts=[neg_q], **kw)[0][0]),
                }
            entry["yes_scores"] = out["Yes"]
            entry["no_scores"] = out["No"]
        except MediaError as e:
            print(f"Error processing sample: {e}")
            entry["error"] = str(e)
            entry["yes_scores"] = dict(_DEFAULT_SCORES)
            entry["no_scores"] = dict(_DEFAULT_SCORES)
        results.append(entry)
    return results


def save_scores(results, output_file, metadata=None):
    with open(output_file, "w") as f:
        json.dump({"metadata": metadata or {}, "scores": results}, f, indent=2)
    print(f"Scores saved to: {output_file}")


def generate_output_filename(model_name, checkpoint_name, name):
    clean = lambda s: s.replace("/", "_").replace("\\", "_").replace(":", "_").replace(" ", "_")
    parts = ["vqa_retrieval_scores", clean(model_name)]
    if checkpoint_name:
        parts.append(clean(checkpoint_name))
    parts.append(clean(name))
    return "_".join(parts) + ".json"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=False)
    parser.add_argument("--data_dir", type=str, default="data/vqa_and_retrieval")
    parser.add_argument("--video_dir", type=str, default="data/videos")
    parser.add_argument("--skill", type=str, default=None)
    parser.add_argument("--question_template", type=str, default="{}")
    parser.add_argument("--output_dir", type=str, default="scores")
    parser.add_argument("--combine_tasks", action="store_true")
    args = parser.parse_args()

    output_dir = Path(args.output_dir)
    output_dir.mkdir(exist_ok=True)
    skill_data = load_data_by_skill(args.data_dir, args.skill)
    if not skill_data:
        print("No data found")
        return

    kwargs = {"checkpoint": args.checkpoint} if args.checkpoint else {}
    model = t2v.VQAScore(model=args.model, **kwargs)
    method_name = args.model + (f"_{args.checkpoint}" if args.checkpoint else "")

    for skill_name, skill_tasks in skill_data.items():
        print(f"\n{'=' * 60}\nPROCESSING SKILL: {skill_name}\n{'=' * 60}")
        units = ([(skill_name, [s for t in skill_tasks.values() for s in t],
                   list(skill_tasks))] if args.combine_tasks
                 else [(t, samples, [t]) for t, samples in skill_tasks.items()])
        for name, samples, task_names in units:
            if not samples:
                continue
            results = generate_vqa_retrieval_scores(
                samples, model, args.video_dir, args.question_template,
                method_name)
            metadata = {
                "model_name": args.model,
                "checkpoint": args.checkpoint,
                "skill_name": skill_name,
                "task_names": task_names,
                "combined_tasks": args.combine_tasks,
                "video_dir": args.video_dir,
                "question_template": args.question_template,
                "generation_timestamp": datetime.now().isoformat(),
                "method_type": "VQAScore_LMM",
            }
            out = output_dir / generate_output_filename(
                args.model, args.checkpoint, name)
            save_scores(results, out, metadata)


if __name__ == "__main__":
    main()
