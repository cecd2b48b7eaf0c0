"""GenAI-Rank CLI (reference genai_image_ranking.py): 800 prompts x 9
images per generator; rerank-by-9/-3 human score vs oracle, top-1 accuracy
per skill. The port's copy of t2v_metrics_tpu/cli/genai_image_ranking.py:
``--device`` is cuda (the default) or cpu."""

import argparse
import json
import os

import numpy as np

import t2v_metrics_tpu_torch as t2v
from ..benchmarks.datasets import GenAIBench_Ranking


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="./datasets", type=str)
    parser.add_argument("--cache_dir", default=t2v.constants.HF_CACHE_DIR, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="cuda (the default: the GPU) or cpu")
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--gen_model", default="DALLE_3", type=str,
                        choices=["DALLE_3", "SDXL_Base"])
    parser.add_argument("--model", default="clip-flant5-xxl", type=str)
    parser.add_argument("--question", default=None, type=str)
    parser.add_argument("--answer", default=None, type=str)
    parser.add_argument("--result_dir", default="./genai_ranking_results", type=str)
    return parser.parse_args()


def compute_scores_per_skill(scores, tags, images_to_prompt_idx):
    """Mean metric score per skill tag (reference :40-54)."""
    out = {}
    scores = np.asarray(scores)
    for tag, tag_indices in tags.items():
        sel = [scores[i] for i in range(len(scores))
               if images_to_prompt_idx[i] in tag_indices]
        out[tag] = float(np.mean(sel)) if sel else float("nan")
    out["all"] = float(scores.mean())
    return out


def rerank_human_scores(dataset, rerank_idx_by_9, rerank_idx_by_3,
                        items_name="images"):
    """Human score achieved when picking by metric rank (reference :56-92)."""
    items = getattr(dataset, items_name)
    human = np.array([it["human_score"] for it in items]).reshape(-1, 9)
    rows = np.arange(len(human))
    out = {
        "random": human.mean(axis=1),
        "rerank_by_9": human[rows, rerank_idx_by_9],
        "human_oracle_by9": human.max(axis=1),
    }
    by3_oracle, by3_rerank = [], []
    for p in range(len(human)):
        tops_h, tops_r = [], []
        for g in range(0, 9, 3):
            tops_h.append(human[p, g:g + 3].max())
            tops_r.append(human[p, rerank_idx_by_3[p][g // 3]])
        by3_oracle.append(np.mean(tops_h))
        by3_rerank.append(np.mean(tops_r))
    out["human_oracle_by3"] = np.array(by3_oracle)
    out["rerank_by_3"] = np.array(by3_rerank)
    return out, human


def compute_top1_acc_skill(vqascores, human_scores, tags, images_to_prompt_idx):
    """Top-1 ranking accuracy per skill (reference :95-113)."""
    acc = {}
    for skill in ("basic", "advanced", "all"):
        tag_indices = tags[skill]
        count = 0
        for i in range(len(vqascores)):
            if images_to_prompt_idx[i] in tag_indices:
                top = int(np.argmax(vqascores[i]))
                human_top = np.where(human_scores[i] == human_scores[i].max())[0]
                if top in human_top:
                    count += 1
        acc[skill] = count / len(tag_indices)
    return acc


def main():
    args = config()
    os.makedirs(args.result_dir, exist_ok=True)
    dataset = GenAIBench_Ranking(root_dir=args.root_dir,
                                 gen_model=args.gen_model)
    result_path = f"{args.result_dir}/{args.model}_{args.gen_model}.npz"
    if os.path.exists(result_path):
        scores = np.load(result_path)["scores"]
    else:
        score_func = t2v.get_score_model(model=args.model, device=args.device,
                                         cache_dir=args.cache_dir)
        kwargs = {}
        if args.question is not None:
            kwargs["question_template"] = args.question
        if args.answer is not None:
            kwargs["answer_template"] = args.answer
        scores = score_func.batch_forward(dataset,
                                          batch_size=args.batch_size, **kwargs)
        np.savez(result_path, scores=scores)

    flat = np.asarray(scores).mean(axis=1)[:, 0]
    per_prompt = flat.reshape(-1, 9)
    rerank9 = per_prompt.argmax(axis=1)
    rerank3 = [[int(np.argmax(per_prompt[p, g:g + 3])) + g
                for g in range(0, 9, 3)] for p in range(len(per_prompt))]

    human_scores, human_per_prompt = rerank_human_scores(dataset, rerank9, rerank3)
    print("Human score achieved when picking by metric rank:")
    for k, v in human_scores.items():
        print(f"  {k:<18} {np.mean(v):.3f}")

    tags_file = os.path.join(dataset.root_dir, "genai_skills.json")
    if os.path.exists(tags_file):
        tags = json.load(open(tags_file))
        acc = compute_top1_acc_skill(per_prompt, human_per_prompt, tags,
                                     dataset.images_to_prompt_idx)
        print("Top-1 ranking accuracy per skill:", acc)

    dataset.evaluate_scores(scores)


if __name__ == "__main__":
    main()
