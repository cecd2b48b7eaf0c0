"""CameraBench caption generation (reference camerabench/caption_generation.py):
parse ``model:checkpoint`` specs, run ``scorer.model.generate`` per
caption_data.json sample, save standardized JSON. The port's copy of
t2v_metrics_tpu/camerabench/caption_generation.py: a chunk whose media
cannot be read (``MediaError``) is retried one sample at a time, and a
sample that still fails is recorded with its error."""

import argparse
import json
import os
from datetime import datetime
from pathlib import Path

import t2v_metrics_tpu_torch as t2v

from ..media.video import MediaError


def parse_model_spec(spec: str):
    """'model' or 'model:checkpoint' -> (model, checkpoint|None)
    (reference :12-27)."""
    if ":" in spec:
        model, checkpoint = spec.split(":", 1)
        return model.strip(), checkpoint.strip()
    return spec.strip(), None


def generate_captions(samples, model_spec, video_base_path,
                      question="Describe the camera motion in this video.",
                      max_new_tokens=256):
    model_name, checkpoint = parse_model_spec(model_spec)
    kwargs = {"checkpoint": checkpoint} if checkpoint else {}
    scorer = t2v.VQAScore(model=model_name, **kwargs)

    results = []
    pending = []  # (entry, full path) for a batched generate call
    for sample in samples:
        video_path = sample.get("video", sample.get("image"))
        entry = {"video_path": video_path,
                 "question": question,
                 "reference_caption": sample.get("caption"),
                 "method": model_spec,
                 "generated_caption": None,
                 "error": None}
        full = os.path.join(video_base_path, video_path)
        if not os.path.exists(full):
            entry["error"] = f"Video file not found: {full}"
        else:
            pending.append((entry, full))
        results.append(entry)

    # one generate call a chunk; where a chunk's media cannot be read, one a
    # sample, which keeps the reference's error-tolerant entries
    batch = 8
    for lo in range(0, len(pending), batch):
        chunk = pending[lo:lo + batch]
        try:
            outs = scorer.model.generate(
                images=[f for _, f in chunk],
                texts=[question] * len(chunk),
                max_new_tokens=max_new_tokens)
            for (entry, _), out in zip(chunk, outs):
                entry["generated_caption"] = out
        except MediaError:
            for entry, full in chunk:
                try:
                    out = scorer.model.generate(
                        images=[full], texts=[question],
                        max_new_tokens=max_new_tokens)
                    entry["generated_caption"] = out[0]
                except MediaError as e:
                    print(f"Error generating for {full}: {e}")
                    entry["error"] = str(e)
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        help="model or model:checkpoint spec")
    parser.add_argument("--caption_data", type=str,
                        default="data/caption_data.json")
    parser.add_argument("--video_dir", type=str, default="data/videos")
    parser.add_argument("--question", type=str,
                        default="Describe the camera motion in this video.")
    parser.add_argument("--max_new_tokens", type=int, default=256)
    parser.add_argument("--output_dir", type=str, default="captions")
    args = parser.parse_args()

    with open(args.caption_data) as f:
        data = json.load(f)
    samples = data if isinstance(data, list) else list(data.values())

    results = generate_captions(samples, args.model, args.video_dir,
                                args.question, args.max_new_tokens)
    Path(args.output_dir).mkdir(exist_ok=True)
    clean = args.model.replace("/", "_").replace(":", "_")
    out = Path(args.output_dir) / f"captions_{clean}.json"
    with open(out, "w") as f:
        json.dump({"metadata": {
            "model_spec": args.model,
            "question": args.question,
            "generation_timestamp": datetime.now().isoformat(),
        }, "captions": results}, f, indent=2)
    print(f"Captions saved to {out}")


if __name__ == "__main__":
    main()
