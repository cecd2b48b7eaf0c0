"""GenAI-Bench user pipeline — score your own generations
(reference genai_bench/evaluate.py:1-150). The port's copy of
t2v_metrics_tpu/cli/genai_bench_evaluate.py: ``--device`` is cuda (the
default) or cpu.

Scores ``<image_dir>/<idx>.jpeg`` for every GenAI-Bench prompt with any
registry model (or GPT-4o), caches scores, prints the per-skill table.
"""

import argparse
import json
import os

import numpy as np

import t2v_metrics_tpu_torch as t2v


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", required=True, type=str,
                        help="directory of <prompt_idx>.jpeg generations")
    parser.add_argument("--prompts", default="./datasets/GenAI-Image-1600/genai_image.json")
    parser.add_argument("--skills", default="./datasets/GenAI-Image-1600/genai_skills.json")
    parser.add_argument("--model", default="clip-flant5-xxl", type=str)
    parser.add_argument("--cache_dir", default=t2v.constants.HF_CACHE_DIR, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="cuda (the default: the GPU) or cpu")
    parser.add_argument("--result_dir", default="./genai_bench_results", type=str)
    parser.add_argument("--question", default=None, type=str)
    parser.add_argument("--answer", default=None, type=str)
    parser.add_argument("--openai_key", default=None, type=str)
    parser.add_argument("--top_logprobs", type=int, default=20)
    return parser.parse_args()


def main():
    args = config()
    os.makedirs(args.result_dir, exist_ok=True)
    prompts = json.load(open(args.prompts))

    samples = []
    for prompt_idx, entry in prompts.items():
        path = os.path.join(args.image_dir, f"{prompt_idx}.jpeg")
        if os.path.exists(path):
            samples.append((prompt_idx, path, entry["prompt"]))
    print(f"Scoring {len(samples)} generated images from {args.image_dir}")

    tag_name = os.path.basename(os.path.normpath(args.image_dir))
    result_path = f"{args.result_dir}/{args.model}_{tag_name}.npz"
    if os.path.exists(result_path):
        data = np.load(result_path, allow_pickle=True)
        scores = data["scores"]
        idxs = list(data["idxs"])
    else:
        extra = {}
        if args.model.startswith("gpt-"):
            extra = {"api_key": args.openai_key,
                     "top_logprobs": args.top_logprobs}
        scorer = t2v.get_score_model(model=args.model, device=args.device,
                                     cache_dir=args.cache_dir, **extra)
        kwargs = {}
        if args.question is not None:
            kwargs["question_template"] = args.question
        if args.answer is not None:
            kwargs["answer_template"] = args.answer
        scores = np.concatenate([
            scorer(images=[path], texts=[prompt], **kwargs)[:, 0]
            for _, path, prompt in samples])
        idxs = [s[0] for s in samples]
        np.savez(result_path, scores=scores, idxs=idxs)

    skills = json.load(open(args.skills)) if os.path.exists(args.skills) else {}
    by_idx = dict(zip(idxs, scores))
    print(f"{'Skill':<20}{'Mean VQAScore':<15}{'#prompts':<10}")
    for tag, prompt_ids in skills.items():
        sel = [by_idx[f"{p:05d}"] for p in prompt_ids
               if f"{p:05d}" in by_idx]
        if sel:
            print(f"{tag:<20}{np.mean(sel):<15.4f}{len(sel):<10}")
    print(f"{'all':<20}{np.mean(scores):<15.4f}{len(scores):<10}")


if __name__ == "__main__":
    main()
