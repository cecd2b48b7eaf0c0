"""Port parity: the remote API scorers (``remote/gpt4v.py``,
``remote/gemini.py``) against the JAX package's, through fake clients:
the cases of ``tests/test_remote_and_checkpoint.py`` (target in the top
logprobs, the opposite answer's fallback, neither, one retry, two
failures, text only, Gemini's thinking-token skip), the requests each side
sends, and the registry. No client reaches the network; no scorer asks for
a GPU.

Exact: both sides compute the same float from the same fake logprobs.
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.remote import gemini as JG  # noqa: E402
from t2v_metrics_tpu.remote import gpt4v as JV  # noqa: E402
from t2v_metrics_tpu_torch.remote import gemini as TG  # noqa: E402
from t2v_metrics_tpu_torch.remote import gpt4v as TV  # noqa: E402


def _fake_completion(top_tokens):
    top = [types.SimpleNamespace(token=t, logprob=lp) for t, lp in top_tokens]
    first = types.SimpleNamespace(token=top_tokens[0][0], logprob=top_tokens[0][1],
                                  top_logprobs=top)
    choice = types.SimpleNamespace(
        message=types.SimpleNamespace(content=f" {top_tokens[0][0]} "),
        logprobs=types.SimpleNamespace(content=[first]))
    return types.SimpleNamespace(choices=[choice])


class _FakeClient:
    """chat.completions.create pops the next response (raising it if it is
    an exception) and records each request."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.requests = []
        outer = self

        class _Completions:
            def create(self, **kw):
                outer.requests.append(kw)
                r = outer.responses.pop(0)
                if isinstance(r, Exception):
                    raise r
                return r

        self.chat = types.SimpleNamespace(completions=_Completions())


@pytest.fixture()
def img(tmp_path):
    p = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)).save(p)
    return str(p)


CASES = {
    "target_in_topk": [[("Yes", np.log(0.9)), ("No", np.log(0.1))]],
    "opposite_fallback": [[("No", np.log(0.8)), ("Maybe", np.log(0.1))]],
    "neither": [[("Hm", np.log(0.5)), ("Eh", np.log(0.2))]],
    "retry_then_success": [RuntimeError("boom"), [(" yes", np.log(0.7))]],
    "double_failure": [RuntimeError("boom"), RuntimeError("boom2")],
}


def _responses(case):
    return [r if isinstance(r, Exception) else _fake_completion(r) for r in CASES[case]]


@pytest.mark.parametrize("media", ["image", "text_only"])
@pytest.mark.parametrize("case", list(CASES))
def test_gpt_scores_match_jax(case, media, img):
    images = [img] if media == "image" else None
    jc, tc = _FakeClient(_responses(case)), _FakeClient(_responses(case))
    want = JV.GPT4VAdapter("gpt-4o", client=jc).forward(images, ["a cat"])
    got = TV.GPT4VAdapter("gpt-4o", client=tc).forward(images, ["a cat"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tc.requests == jc.requests and len(tc.requests) == len(CASES[case])


def test_gpt_requests_match_jax_for_images_and_video(img, tmp_path):
    """The same messages (base64 image, the video's JPEG frames), tokens
    key and top_logprobs; 'gpt-5' names take max_completion_tokens."""
    cv2 = pytest.importorskip("cv2")
    vid = str(tmp_path / "v.avi")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"FFV1"), 10.0, (16, 12))
    rng = np.random.default_rng(1)
    for _ in range(9):
        vw.write(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    vw.release()
    ok = [("Yes", np.log(0.6))]
    for name in ("gpt-4o", "gpt-5-mini"):
        jc, tc = (_FakeClient([_fake_completion(ok)] * 2) for _ in range(2))
        kw = dict(client=None, top_logprobs=20)
        ja = JV.GPT4VAdapter(name, **{**kw, "client": jc})
        ta = TV.GPT4VAdapter(name, **{**kw, "client": tc})
        want = ja.forward([img, vid], ["a cat", "a clip"], num_frames=3,
                          question_template="Q: {}", answer_template="Yes")
        got = ta.forward([img, vid], ["a cat", "a clip"], num_frames=3,
                         question_template="Q: {}", answer_template="Yes")
        np.testing.assert_array_equal(got, want)
        assert tc.requests == jc.requests
        key = "max_completion_tokens" if "gpt-5" in name else "max_tokens"
        assert tc.requests[0][key] == 1 and tc.requests[0]["top_logprobs"] == 20
        assert len(tc.requests[1]["messages"][0]["content"]) == 1 + 3


def test_gpt_generate_matches_jax(img):
    jc = _FakeClient([_fake_completion([("a", 0.0)]), RuntimeError("x")])
    tc = _FakeClient([_fake_completion([("a", 0.0)]), RuntimeError("x")])
    want = JV.GPT4VAdapter("gpt-4o", client=jc).generate([img, img], ["q", "r"])
    got = TV.GPT4VAdapter("gpt-4o", client=tc).generate([img, img], ["q", "r"])
    assert got == want == ["a", ""]
    assert tc.requests == jc.requests


def test_gpt_without_a_key_raises(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(ValueError, match="OPENAI_API_KEY"):
        TV.GPT4VAdapter("gpt-4o")


def test_remote_scorers_ask_for_no_gpu(img, monkeypatch):
    """Built through the facade with the device left out (the GPU for a
    local model), an API scorer keeps ``device`` as given and never asks
    torch.cuda."""
    def no_cuda():
        raise AssertionError("torch.cuda asked")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    tc = _FakeClient(_responses("target_in_topk") * 2)
    scorer = tt2v.get_score_model("gpt-4o", client=tc)
    assert scorer.model.device is None
    out = scorer(images=[img], texts=["a cat"])
    assert out.shape == (1, 1) and out[0, 0] == np.float32(0.9)
    rows = scorer.batch_forward([{"images": [img], "texts": ["a cat"]}], batch_size=4)
    np.testing.assert_array_equal(rows, out[None])
    assert tt2v.VQAScore("gpt-4o", device="tpu", client=tc).model.device == "tpu"


def test_gemini_thinking_skip_matches_jax():
    T = lambda tok: types.SimpleNamespace(token=tok)  # noqa: E731
    for chosen in ([T("<ctrl94>"), T("thought"), T("<ctrl95>"), T("Yes")], [T("Yes")],
                   [T("<ctrl94>"), T("x")], [], [T("<ctrl1>"), T("<ctrl2>"), T("No")]):
        assert (TG.find_first_output_token_index(chosen)
                == JG.find_first_output_token_index(chosen))
    assert TG.find_first_output_token_index(
        [T("<ctrl94>"), T("thought"), T("<ctrl95>"), T("Yes")]) == 3


def _fake_genai(responses, calls):
    """A stand-in for ``google.genai``: Client(...).models.generate_content
    pops the next response (raising exceptions); types build plain
    records."""
    class _Models:
        def generate_content(self, **kw):
            calls.append(kw)
            r = responses.pop(0)
            if isinstance(r, Exception):
                raise r
            return r

    class Client:
        def __init__(self, **kw):
            calls.append(("client", kw))
            self.models = _Models()

    def record(kind):
        return lambda **kw: (kind, tuple(sorted((k, str(v)) for k, v in kw.items())))

    part = types.SimpleNamespace(from_bytes=lambda data, mime_type: ("part", mime_type,
                                                                     len(data)))
    typ = types.SimpleNamespace(SafetySetting=record("safety"), Part=part,
                                GenerateContentConfig=record("config"))
    return types.SimpleNamespace(Client=Client, types=typ)


def _gemini_response(tokens, top):
    cand = lambda tok, lp=0.0: types.SimpleNamespace(token=tok, log_probability=lp)  # noqa: E731
    lr = types.SimpleNamespace(
        chosen_candidates=[cand(t) for t in tokens],
        top_candidates=[types.SimpleNamespace(candidates=[cand(t, lp) for t, lp in top])
                        for _ in tokens])
    return types.SimpleNamespace(candidates=[types.SimpleNamespace(logprobs_result=lr)],
                                 text=" out ")


GEMINI_CASES = {
    "thinking_then_yes": [_gemini_response(["<ctrl94>", "t", "<ctrl95>", "Yes"],
                                           [(" Yes", np.log(0.6)), ("yes!", np.log(0.3))])],
    "no_output_token": [_gemini_response(["<ctrl94>", "t"], [("Yes", 0.0)])],
    "retry_then_success": [RuntimeError("x"), _gemini_response(["No"], [("Yes", np.log(0.2))])],
    "double_failure": [RuntimeError("x"), RuntimeError("y")],
}


@pytest.mark.parametrize("case", list(GEMINI_CASES))
def test_gemini_scores_match_jax(case, img, monkeypatch):
    import google

    out = {}
    for label, module in (("jax", JG), ("port", TG)):
        calls = []
        fake = _fake_genai(list(GEMINI_CASES[case]), calls)
        monkeypatch.setattr(google, "genai", fake, raising=False)
        monkeypatch.setitem(sys.modules, "google.genai", fake)
        adapter = module.GeminiAdapter("gemini-2.5-pro", project_id="p", logprobs=3)
        out[label] = (adapter.forward([img], ["a cat"]), calls)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]


def test_gemini_developer_api_cannot_score(monkeypatch, img):
    import google

    fake = _fake_genai([], [])
    monkeypatch.setattr(google, "genai", fake, raising=False)
    monkeypatch.setitem(sys.modules, "google.genai", fake)
    monkeypatch.delenv("GOOGLE_CLOUD_PROJECT", raising=False)
    adapter = TG.GeminiAdapter("gemini-2.5-flash", api_key="k")
    with pytest.raises(ValueError, match="Vertex"):
        adapter.forward([img], ["a cat"])
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    with pytest.raises(ValueError, match="credentials"):
        TG.GeminiAdapter("gemini-2.5-flash")


def test_remote_models_registered_as_in_jax():
    for name in ("gpt-4o", "gpt-4.1", "gpt-4-turbo", "gemini-2.5-pro", "gemini-2.5-flash"):
        assert name in tt2v.list_all_models() and name in tt2v.list_all_vqascore_models()
    assert tt2v.list_all_vqascore_models() == jt2v.list_all_vqascore_models()
    assert list(TV.GPT4V_MODELS) == list(JV.GPT4V_MODELS)
    assert list(TG.GEMINI_MODELS) == list(JG.GEMINI_MODELS)
