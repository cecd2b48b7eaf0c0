"""GPT-4 paper-benchmarks CLI (reference gpt4_eval.py:1-79): the same
dataset loop as eval.py with OpenAI key handling, 15MB/type asserts, and
score caching. The port's copy of t2v_metrics_tpu/cli/gpt4_eval.py; the API
scorer runs on no device."""

import argparse
import os

import numpy as np

import t2v_metrics_tpu_torch as t2v
from ..benchmarks.datasets import (Winoground, EqBen_Mini, TIFA160_DSG,
                                   Flickr8K_CF, SeeTrue, Pickapic_v1)


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="./datasets", type=str)
    parser.add_argument("--cache_dir", default=t2v.constants.HF_CACHE_DIR, type=str)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--model", default="gpt-4o", type=str)
    parser.add_argument("--question", default=None, type=str)
    parser.add_argument("--answer", default=None, type=str)
    parser.add_argument("--result_dir", default="./gpt4_results", type=str)
    parser.add_argument("--openai_key", default=None, type=str)
    parser.add_argument("--openai_key_path", default="./_OPENAI_API_KEY.txt", type=str)
    parser.add_argument("--top_logprobs", type=int, default=20)
    return parser.parse_args()


def main():
    args = config()
    os.makedirs(args.result_dir, exist_ok=True)
    if args.openai_key is None and os.path.exists(args.openai_key_path):
        args.openai_key = open(args.openai_key_path).read().strip()
    assert args.openai_key, "Provide --openai_key or --openai_key_path"

    score_func = t2v.get_score_model(
        model=args.model, cache_dir=args.cache_dir, api_key=args.openai_key,
        top_logprobs=args.top_logprobs)
    kwargs = {}
    if args.question is not None:
        kwargs["question_template"] = args.question
    if args.answer is not None:
        kwargs["answer_template"] = args.answer

    for dataset_cls in [Winoground, EqBen_Mini, TIFA160_DSG, Pickapic_v1,
                        SeeTrue, Flickr8K_CF]:
        dataset = dataset_cls(root_dir=args.root_dir)
        # 15MB / type asserts (reference gpt4_eval.py:60-66)
        for item in dataset:
            for image in item["images"]:
                assert os.path.getsize(image) < 15 * 1024 * 1024, \
                    f"{image} larger than 15mb"
                assert image.split(".")[-1] in ("png", "jpeg", "jpg", "gif", "webp")
        result_path = f"{args.result_dir}/{args.model}_{dataset_cls.__name__}.npz"
        if os.path.exists(result_path):
            scores = np.load(result_path)["scores"]
        else:
            scores = score_func.batch_forward(dataset,
                                              batch_size=args.batch_size,
                                              **kwargs)
            np.savez(result_path, scores=scores)
        dataset.evaluate_scores(scores)


if __name__ == "__main__":
    main()
