"""GenAI-Bench video evaluation CLI (reference genai_video_eval.py:1-67).
The port's copy of t2v_metrics_tpu/cli/genai_video_eval.py: ``--device`` is
cuda (the default) or cpu. Extracting the videos' frames needs cv2 and
Pillow."""

import argparse
import os

import numpy as np

import t2v_metrics_tpu_torch as t2v
from ..benchmarks.datasets import GenAIBench_Video
from .genai_image_eval import show_performance_per_skill, load_or_compute_scores


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="./datasets", type=str)
    parser.add_argument("--cache_dir", default=t2v.constants.HF_CACHE_DIR, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="cuda (the default: the GPU) or cpu")
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--num_prompts", default=527, type=int, choices=[527, 800])
    parser.add_argument("--model", default="clip-flant5-xxl", type=str)
    parser.add_argument("--question", default=None, type=str)
    parser.add_argument("--answer", default=None, type=str)
    parser.add_argument("--result_dir", default="./genai_video_results", type=str)
    parser.add_argument("--eval_mode", default="avg_frames", type=str,
                        choices=["avg_frames", "sample_4_frame", "sample_9_frame"])
    parser.add_argument("--openai_key", default=None, type=str)
    parser.add_argument("--openai_key_path", default="./_OPENAI_API_KEY.txt", type=str)
    parser.add_argument("--top_logprobs", type=int, default=20)
    return parser.parse_args()


def main():
    args = config()
    os.makedirs(args.root_dir, exist_ok=True)
    os.makedirs(args.result_dir, exist_ok=True)
    dataset = GenAIBench_Video(root_dir=args.root_dir,
                               num_prompts=args.num_prompts,
                               eval_mode=args.eval_mode)
    result_path = (f"{args.result_dir}/{args.model}_{args.num_prompts}"
                   f"_{args.eval_mode}.npz")
    scores = load_or_compute_scores(args, dataset, result_path)

    our_scores = np.asarray(scores).mean(axis=1)[:, 0]
    show_performance_per_skill(our_scores, dataset, items_name="videos",
                               prompt_to_items_name="prompt_to_videos",
                               print_std=True)
    print("Overall Alignment Performance")
    dataset.evaluate_scores(scores)


if __name__ == "__main__":
    main()
