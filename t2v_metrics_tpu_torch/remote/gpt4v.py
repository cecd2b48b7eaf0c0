"""GPT-4V/4o API adapter (pure Python; network-bound). The port's copy of
t2v_metrics_tpu/remote/gpt4v.py: it runs no model, so ``device`` is
accepted and ignored and no GPU is asked for; the ``openai`` client is
injected (``client=``) or imported when the scorer is built, cv2 only to
read a video.

Scoring rules preserved from reference gpt4v_model.py:
  * chat-completions with logprobs=True, top_logprobs=k (default 2; eval
    scripts pass 20) and max 1 token (:127-133);
  * score = exp(logprob) of the target token if present among the FIRST
    generated token's top-k; else 1 - exp(logprob) of the opposite
    (Yes<->No); else 0.0 (:179-199);
  * one retry, failures score 0.0 (:135-165);
  * videos: num_frames evenly-spaced JPEG frames, base64-inline (:35-50);
  * 'gpt-5'-era names use max_completion_tokens (:125).
"""

from __future__ import annotations

import base64
import os

import numpy as np

from ..constants import VIDEO_EXTENSIONS
from . import RemoteVQAScoreModel

GPT4V_MODELS = {
    "gpt-4o": {},
    "gpt-4.1": {},
    "gpt-4-turbo": {},
}

default_question_template = 'Does this figure show "{}"? Please answer Yes or No.'
default_answer_template = "Yes"


def _encode_image_b64(path) -> tuple[str, str]:
    ext = os.path.splitext(str(path))[1].lstrip(".").lower() or "png"
    if ext == "jpg":
        ext = "jpeg"
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode(), ext


def _encode_video_frames(path, num_frames: int) -> list[str]:
    import cv2

    video = cv2.VideoCapture(str(path))
    total = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    step = max(total // num_frames, 1)
    frames = []
    for i in range(num_frames):
        video.set(cv2.CAP_PROP_POS_FRAMES, i * step)
        ok, frame = video.read()
        if ok:
            _, buf = cv2.imencode(".jpg", frame)
            frames.append(base64.b64encode(buf.tobytes()).decode())
    video.release()
    return frames


class GPT4VAdapter(RemoteVQAScoreModel):
    video_mode = "direct"
    allows_image = True
    allows_video = True

    def load_model(self):
        self.top_logprobs = self.kwargs.get("top_logprobs", 2)
        if "client" in self.kwargs:  # injected client (tests)
            self.client = self.kwargs["client"]
            return
        api_key = self.kwargs.get("api_key") or os.environ.get("OPENAI_API_KEY")
        if not api_key:
            raise ValueError("OPENAI_API_KEY not set (or pass api_key=)")
        from openai import OpenAI

        self.client = OpenAI(api_key=api_key)

    def load_images(self, paths, num_frames: int = 4):
        out = []
        for path in paths:
            if path is None:
                out.append(None)
            elif str(path).lower().endswith(VIDEO_EXTENSIONS):
                out.append({"type": "video", "path": path,
                            "frames": _encode_video_frames(path, num_frames)})
            else:
                b64, ext = _encode_image_b64(path)
                out.append({"type": ext, "path": path, "base64": b64})
        return out

    def _content(self, data, question):
        if data is None:
            return [{"type": "text", "text": question}]
        if data["type"] == "video":
            return ([{"type": "text", "text": question}]
                    + [{"type": "image_url",
                        "image_url": {"url": f"data:image/jpg;base64,{f}"}}
                       for f in data["frames"]])
        return [{"type": "text", "text": question},
                {"type": "image_url",
                 "image_url": {"url": f"data:image/{data['type']};base64,{data['base64']}"}}]

    def forward_single(self, data, question, answer, max_new_tokens=1) -> float:
        token_key = ("max_completion_tokens" if "gpt-5" in self.model_name
                     else "max_tokens")
        completion = None
        for attempt in range(2):
            try:
                completion = self.client.chat.completions.create(
                    model=self.model_name,
                    messages=[{"role": "user",
                               "content": self._content(data, question)}],
                    logprobs=True,
                    top_logprobs=self.top_logprobs,
                    **{token_key: max_new_tokens})
                break
            except Exception as e:
                if attempt == 1:
                    print(f"Failed: {data['path'] if data else 'text-only'} "
                          f"question: {question}: {e}")
                    return 0.0

        first = completion.choices[0].logprobs.content[0]
        target = answer.lower().strip()
        opposite = "no" if target == "yes" else "yes"
        target_lp = opposite_lp = None
        for cand in first.top_logprobs:
            tok = cand.token.strip().lower()
            if tok == target:
                target_lp = cand.logprob
            elif tok == opposite:
                opposite_lp = cand.logprob
        if target_lp is not None:
            return float(np.exp(target_lp))
        if opposite_lp is not None:
            return float(1.0 - np.exp(opposite_lp))
        print(f"[GPT] Warning: neither '{target}' nor '{opposite}' in top "
              f"{self.top_logprobs} logprobs")
        return 0.0

    def forward(self, images, texts,
                question_template: str = default_question_template,
                answer_template: str = default_answer_template,
                num_frames: int = 4, fps=None, max_new_tokens: int = 1,
                temperature=None, **kw) -> np.ndarray:
        loaded = ([None] * len(texts) if images is None
                  else self.load_images(images, num_frames))
        assert len(loaded) == len(texts)
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        return np.asarray([
            self.forward_single(d, qu, a, max_new_tokens)
            for d, qu, a in zip(loaded, questions, answers)], np.float32)

    def generate(self, images, texts, num_frames: int = 4,
                 max_new_tokens: int = 256, **kw) -> list[str]:
        loaded = self.load_images(images, num_frames)
        outs = []
        token_key = ("max_completion_tokens" if "gpt-5" in self.model_name
                     else "max_tokens")
        for data, text in zip(loaded, texts):
            try:
                completion = self.client.chat.completions.create(
                    model=self.model_name,
                    messages=[{"role": "user",
                               "content": self._content(data, text)}],
                    **{token_key: max_new_tokens})
                outs.append(completion.choices[0].message.content.strip())
            except Exception as e:
                print(f"generate failed: {e}")
                outs.append("")
        return outs
