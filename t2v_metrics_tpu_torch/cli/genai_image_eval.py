"""GenAI-Bench image evaluation CLI (reference genai_image_eval.py). The
port's copy of t2v_metrics_tpu/cli/genai_image_eval.py.

Same flow: score-result caching (npz instead of torch .pt), per-skill
metric/human tables (basic/advanced/overall groups), overall correlation,
per-skill correlation JSON dump. ``--device`` is cuda (the default: the GPU,
which raises without one) or cpu; weights come from the model's snapshot in
``--cache_dir`` (never downloaded):

    python -m t2v_metrics_tpu_torch.cli.genai_image_eval --root_dir ./datasets \
        --model clip-flant5-xl --cache_dir <local HF cache>
"""

import argparse
import json
import os

import numpy as np

import t2v_metrics_tpu_torch as t2v
from ..benchmarks.datasets import GenAIBench_Image

tag_groups = {
    "basic": ["attribute", "scene", "spatial relation", "action relation",
              "part relation", "basic"],
    "advanced": ["counting", "comparison", "differentiation", "negation",
                 "universal", "advanced"],
    "overall": ["basic", "advanced", "all"],
}


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="./datasets", type=str)
    parser.add_argument("--cache_dir", default=t2v.constants.HF_CACHE_DIR, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="cuda (the default: the GPU) or cpu")
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--num_prompts", default=1600, type=int, choices=[527, 1600])
    parser.add_argument("--model", default="clip-flant5-xxl", type=str)
    parser.add_argument("--question", default=None, type=str)
    parser.add_argument("--answer", default=None, type=str)
    parser.add_argument("--result_dir", default="./genai_image_results", type=str)
    parser.add_argument("--openai_key", default=None, type=str)
    parser.add_argument("--openai_key_path", default="./_OPENAI_API_KEY.txt", type=str)
    parser.add_argument("--top_logprobs", type=int, default=20)
    return parser.parse_args()


def show_performance_per_skill(our_scores, dataset, items_name="images",
                               prompt_to_items_name="prompt_to_images",
                               print_std=False, tag_groups=tag_groups):
    """Per-skill metric/human mean tables (reference :40-105)."""
    tag_result = {}
    tags = json.load(open(f"{dataset.root_dir}/genai_skills.json"))
    items = getattr(dataset, items_name)
    prompt_to_items = getattr(dataset, prompt_to_items_name)
    human_scores = np.array([np.mean(it["human_alignment"]) for it in items])
    our_scores = np.asarray(our_scores)

    items_by_model_tag = {}
    for tag in tags:
        items_by_model_tag[tag] = {}
        for prompt_idx in tags[tag]:
            for image_idx in prompt_to_items[f"{prompt_idx:05d}"]:
                model = items[image_idx]["model"]
                items_by_model_tag[tag].setdefault(model, []).append(image_idx)

    for tag in tags:
        tag_result[tag] = {}
        for model, idxs in items_by_model_tag[tag].items():
            tag_result[tag][model] = {
                "metric": {"mean": our_scores[idxs].mean(),
                           "std": our_scores[idxs].std()},
                "human": {"mean": human_scores[idxs].mean(),
                          "std": human_scores[idxs].std()},
            }
    tag_result["all"] = {}
    all_models = items_by_model_tag[tag]
    for model in all_models:
        idxs = sorted({i for t in items_by_model_tag
                       for i in items_by_model_tag[t].get(model, [])})
        tag_result["all"][model] = {
            "metric": {"mean": our_scores[idxs].mean(),
                       "std": our_scores[idxs].std()},
            "human": {"mean": human_scores[idxs].mean(),
                      "std": human_scores[idxs].std()},
        }

    for tag_group in tag_groups:
        for score_name in ["metric", "human"]:
            print(f"Tag Group: {tag_group} ({score_name} performance)")
            print(f"{'Model':<20}" + " ".join(
                f"{t:<20}" for t in tag_groups[tag_group]))
            for model_name in all_models:
                if print_std:
                    cells = [f"{tag_result[t][model_name][score_name]['mean']:.2f} "
                             f"+- {tag_result[t][model_name][score_name]['std']:.2f}"
                             for t in tag_groups[tag_group]]
                else:
                    cells = [f"{tag_result[t][model_name][score_name]['mean']:.2f}"
                             for t in tag_groups[tag_group]]
                print(f"{model_name:<20}" + " ".join(f"{c:<20}" for c in cells))
            print()
        print()
    return tag_result


def load_or_compute_scores(args, dataset, result_path):
    """Result-file caching (reference :116-120)."""
    if os.path.exists(result_path):
        print(f"Result file {result_path} already exists. Skipping.")
        return np.load(result_path)["scores"]
    extra = {}
    if args.model in ("gpt-4o", "gpt-4-turbo", "gpt-4.1"):
        if args.openai_key is None and os.path.exists(args.openai_key_path):
            args.openai_key = open(args.openai_key_path).read().strip()
        extra = {"api_key": args.openai_key, "top_logprobs": args.top_logprobs}
        for item in dataset:
            for image in item["images"]:
                assert os.path.getsize(image) < 15 * 1024 * 1024
    score_func = t2v.get_score_model(model=args.model, device=args.device,
                                     cache_dir=args.cache_dir, **extra)
    kwargs = {}
    if args.question is not None:
        kwargs["question_template"] = args.question
    if args.answer is not None:
        kwargs["answer_template"] = args.answer
    print(f"Performance of {args.model}.")
    scores = score_func.batch_forward(dataset, batch_size=args.batch_size, **kwargs)
    np.savez(result_path, scores=scores)
    return scores


def main():
    args = config()
    os.makedirs(args.root_dir, exist_ok=True)
    os.makedirs(args.result_dir, exist_ok=True)
    dataset = GenAIBench_Image(root_dir=args.root_dir,
                               num_prompts=args.num_prompts)
    result_path = f"{args.result_dir}/{args.model}_{args.num_prompts}_prompts.npz"
    scores = load_or_compute_scores(args, dataset, result_path)

    our_scores = np.asarray(scores).mean(axis=1)[:, 0]
    show_performance_per_skill(our_scores, dataset, print_std=True)

    print("Overall Alignment Performance")
    dataset.evaluate_scores(scores)

    print("Evaluating scores of each skill for model:", args.model)
    skill_result = dataset.evaluate_scores_per_skill(scores)
    output_file = f"{args.result_dir}/{args.model}_{args.num_prompts}_per_skill.json"
    with open(output_file, "w") as f:
        json.dump(skill_result, f, default=float)
    print("Results saved to:", output_file)


if __name__ == "__main__":
    main()
