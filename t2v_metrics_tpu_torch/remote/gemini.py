"""Gemini (Vertex AI / Developer API) adapter. The port's copy of
t2v_metrics_tpu/remote/gemini.py: it runs no model, so ``device`` is
accepted and ignored; ``google.genai`` is imported when the scorer is
built.

Scoring rules preserved from reference gemini_model.py:
  * Vertex-vs-API-key credential resolution, Vertex priority (:102-118);
  * scoring requires a Vertex project — the Developer API does not return
    logprobs (:238-242);
  * videos are uploaded as whole encoded bytes with mime type (:132-167);
  * response_logprobs=True with top-k candidates; the first non-thinking
    output token is found by toggling on '<ctrl' tokens (:69-84); score is
    the max exp(logprob) over top candidates whose token CONTAINS the
    target substring (:213-220); two attempts, failure -> 0.0;
  * max_output_tokens=65536 headroom for thinking models (:187);
  * permissive safety settings (:35-40).
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..constants import VIDEO_EXTENSIONS
from . import RemoteVQAScoreModel

GEMINI_MODELS = {
    "gemini-2.5-flash": {},
    "gemini-2.5-pro": {},
}

default_question_template = 'Does this figure show "{}"? Please answer Yes or No.'
default_answer_template = "Yes"

_VIDEO_MIME = {
    "mp4": "video/mp4", "avi": "video/x-msvideo", "mov": "video/quicktime",
    "mkv": "video/x-matroska", "mpeg": "video/mpeg", "mpg": "video/mpeg",
    "wmv": "video/x-ms-wmv", "webm": "video/webm", "3gpp": "video/3gpp",
}


def find_first_output_token_index(chosen_candidates):
    """Skip '<ctrl..>'-delimited thinking blocks
    (reference gemini_model.py:69-84)."""
    in_thinking = False
    for i, chosen in enumerate(chosen_candidates):
        if chosen.token.startswith("<ctrl"):
            in_thinking = not in_thinking
            continue
        if in_thinking:
            continue
        return i
    return None


class GeminiAdapter(RemoteVQAScoreModel):
    video_mode = "direct"
    allows_image = True
    allows_video = True

    def load_model(self):
        project_id = (self.kwargs.get("project_id")
                      or os.environ.get("GOOGLE_CLOUD_PROJECT"))
        api_key = self.kwargs.get("api_key") or os.environ.get("GEMINI_API_KEY")
        location = (self.kwargs.get("location")
                    or os.environ.get("GOOGLE_CLOUD_LOCATION") or "global")
        if project_id is None and api_key is None:
            raise ValueError(
                "No Gemini credentials: pass project_id=/GOOGLE_CLOUD_PROJECT "
                "(Vertex, ADC auth) or api_key=/GEMINI_API_KEY (Developer API)")
        self.project_id = project_id
        self.api_key = api_key if project_id is None else None
        self.location = location
        self.logprobs = self.kwargs.get("logprobs", 5)

        from google import genai

        self._genai = genai
        if project_id is not None:
            self.client = genai.Client(vertexai=True, project=project_id,
                                       location=location)
        else:
            self.client = genai.Client(api_key=self.api_key)

    def _safety_settings(self):
        t = self._genai.types
        return [t.SafetySetting(category=c, threshold="BLOCK_NONE")
                for c in ("HARM_CATEGORY_HATE_SPEECH",
                          "HARM_CATEGORY_DANGEROUS_CONTENT",
                          "HARM_CATEGORY_SEXUALLY_EXPLICIT",
                          "HARM_CATEGORY_HARASSMENT")]

    def load_images(self, paths, num_frames: int | None = None):
        out = []
        for path in paths:
            p = str(path)
            if p.lower().endswith(VIDEO_EXTENSIONS):
                ext = p.split(".")[-1].lower()
                with open(p, "rb") as f:
                    out.append({"path": p, "type": "video", "data": f.read(),
                                "mime_type": _VIDEO_MIME.get(ext, "video/mp4")})
            else:
                ext = os.path.splitext(p)[1].lstrip(".").lower() or "png"
                if ext == "jpg":
                    ext = "jpeg"
                with open(p, "rb") as f:
                    out.append({"path": p, "type": "image", "data": f.read(),
                                "mime_type": f"image/{ext}"})
        return out

    def _build_parts(self, data, question):
        Part = self._genai.types.Part
        return [question,
                Part.from_bytes(data=data["data"], mime_type=data["mime_type"])]

    def forward_single(self, data, question, answer, temperature=0.0) -> float:
        types = self._genai.types
        config = types.GenerateContentConfig(
            temperature=temperature, top_p=0.95, top_k=20,
            response_logprobs=True, logprobs=self.logprobs,
            max_output_tokens=65536,
            safety_settings=self._safety_settings())
        for attempt in range(2):
            try:
                response = self.client.models.generate_content(
                    model=self.model_name,
                    contents=self._build_parts(data, question),
                    config=config)
                lr = response.candidates[0].logprobs_result
                if lr is None:
                    print(f"logprobs_result is None for {data['path']}")
                    return 0.0
                first = find_first_output_token_index(lr.chosen_candidates)
                if first is None:
                    print(f"No output token found for {data['path']}")
                    return 0.0
                target = answer.lower().strip()
                prob = 0.0
                for cand in lr.top_candidates[first].candidates:
                    if target in cand.token.lower().strip():
                        prob = max(prob, math.exp(cand.log_probability))
                return prob
            except Exception as e:
                if attempt == 0:
                    print(f"Attempt 1 failed for {data['path']}: {e}. Retrying...")
                else:
                    print(f"Both attempts failed for {data['path']}: {e}")
                    return 0.0

    def forward(self, images, texts,
                question_template: str = default_question_template,
                answer_template: str = default_answer_template,
                num_frames: int = 4, fps=None, temperature: float = 1.0,
                **kw) -> np.ndarray:
        if self.project_id is None:
            raise ValueError(
                "VQAScore scoring requires Vertex AI (set GOOGLE_CLOUD_PROJECT); "
                "the Gemini Developer API does not expose logprobs")
        loaded = self.load_images(images, num_frames)
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        return np.asarray([
            self.forward_single(d, qu, a)
            for d, qu, a in zip(loaded, questions, answers)], np.float32)

    def generate(self, images, texts, max_new_tokens: int = 256, **kw) -> list[str]:
        types = self._genai.types
        loaded = self.load_images(images)
        outs = []
        for data, text in zip(loaded, texts):
            try:
                r = self.client.models.generate_content(
                    model=self.model_name,
                    contents=self._build_parts(data, text),
                    config=types.GenerateContentConfig(
                        max_output_tokens=max_new_tokens,
                        safety_settings=self._safety_settings()))
                outs.append((r.text or "").strip())
            except Exception as e:
                print(f"generate failed: {e}")
                outs.append("")
        return outs
