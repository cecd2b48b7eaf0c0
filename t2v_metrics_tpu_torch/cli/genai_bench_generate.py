"""GenAI-Bench user pipeline — image generation
(reference genai_bench/generate.py:1-134). The port's copy of
t2v_metrics_tpu/cli/genai_bench_generate.py.

Loops the GenAI-Bench prompt file through a diffusers text-to-image model
and writes ``outputs/<model>/<idx>.jpeg``. Requires the ``diffusers``
package (not part of the scoring port); a clear error is raised if it is
unavailable.
"""

import argparse
import json
import os


def config():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="stabilityai/stable-diffusion-xl-base-1.0")
    parser.add_argument("--prompts", default="./datasets/GenAI-Image-1600/genai_image.json")
    parser.add_argument("--output_dir", default="./outputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=50)
    return parser.parse_args()


def main():
    args = config()
    try:
        import torch
        from diffusers import AutoPipelineForText2Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "genai_bench generation requires the `diffusers` package; the "
            "PyTorch port ships the scoring side only. Install diffusers or "
            "generate images elsewhere, then run genai_bench_evaluate.") from e

    prompts = json.load(open(args.prompts))
    out_dir = os.path.join(args.output_dir, args.model.split("/")[-1])
    os.makedirs(out_dir, exist_ok=True)

    pipe = AutoPipelineForText2Image.from_pretrained(args.model)
    g = torch.Generator().manual_seed(args.seed)
    for prompt_idx, entry in prompts.items():
        out_path = os.path.join(out_dir, f"{prompt_idx}.jpeg")
        if os.path.exists(out_path):
            continue
        image = pipe(entry["prompt"], num_inference_steps=args.steps,
                     generator=g).images[0]
        image.save(out_path)
        print(f"saved {out_path}")


if __name__ == "__main__":
    main()
