"""Port parity: generation and traces through the adapters —
``VQAScore(..., device="cpu").model.generate`` for clip-flant5-test (fp32
and ``int8``), the Qwen2.5-VL and Qwen3-VL test models (images and a clip)
and gemma-3-test (batched and one sequence at a time, images and a clip);
Qwen's ``forward_with_trace`` and ``forward_with_trace_teacher_forcing``;
clip-flant5's ``first_token_distribution`` — against the JAX package on the
same parameters, the same tokenizer instance and the same seeded inputs.

The tokenizer decodes ids as their numbers, so equal strings are equal
tokens. Tolerances: strings and trace ids, texts and positions equal; trace
scores, probabilities and distributions within 1e-5, and the scores' and
trace probabilities' logs within 1e-4 nats, the image tests' bar (fp32; the
two CPU BLAS libraries sum in different orders, and through the vision tower
and the widened weights that moves a probability by up to ~2e-5 of itself);
the teacher-forced trace against the one-token rollout
within 1e-6 (the reference's test_teacher_vs_rollout.py); the first-token
distribution within 1e-5 of its largest probability.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models import gemma3 as jg3  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl as jq  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-5
LOG_TOL = 1e-4     # nats, the scores' bar of the image tests
VID = "_test_assets/vid.mp4"
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
QWEN = ("qwen2.5-vl-test", "qwen3-vl-test", "qwen3-vl-moe-test")
_SCORERS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids, so that generated
    strings compare token for token."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _scaled(tree, factor, seed=None):
    """Numpy leaves; matrices times ``factor`` (wider logits than the random
    init's); with a seed, vectors moved off their init by N(0, 0.1) (the
    Gemma norm scales, zero at init)."""
    rng = None if seed is None else np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(tree)
    out = []
    for x in leaves:
        x = np.asarray(x)
        matrix = np.ndim(x) >= 2 if rng is not None else np.ndim(x) == 2
        if matrix:
            x = x * np.float32(factor)
        elif rng is not None:
            x = (x + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
        out.append(x)
    return jax.tree.unflatten(treedef, out)


def scorers(name, quant=None):
    """(JAX scorer, port scorer on the CPU) of a test model, made once."""
    key = (name, quant)
    if key not in _SCORERS:
        if name == "clip-flant5-test":
            params = _scaled(jcft5.init_clip_t5(jax.random.PRNGKey(1),
                                                J_MODELS[name]["config"]), 2.0)
            vocab = J_MODELS[name]["config"].t5.vocab_size
        elif name == "gemma-3-test":
            cfg = jg3.GEMMA3_MODELS[name]["config"]
            params = _scaled(jg3.init_gemma3(jax.random.PRNGKey(0), cfg), 2.0, seed=0)
            vocab = cfg.text.vocab_size
        else:
            cfg = (jq.QWEN2_VL_MODELS[name]["config"] if name.startswith("qwen2.5")
                   else jq3.resolve_config(name))
            init = jq.init_qwen2vl if name.startswith("qwen2.5") else jq3.init_qwen3vl
            params = _scaled(init(jax.random.PRNGKey(0), cfg), 3.0)
            vocab = cfg.text.vocab_size
        tok = IdTokenizer(vocab)
        kw = {} if quant is None else {"quant": quant}
        _SCORERS[key] = (jt2v.VQAScore(name, params=params, tokenizer=tok, **kw),
                         tt2v.VQAScore(name, params=params, tokenizer=tok, device="cpu",
                                       config=_port_config(name), **kw))
    return _SCORERS[key]


def _port_config(name):
    """The port's Qwen3-VL config with the JAX package's pixel
    normalisation, CLIP's mean and std (the port gives Qwen3-VL its
    published processor's 0.5); None (the registry's) for the others."""
    if not name.startswith("qwen3"):
        return None
    cfg = tq3.resolve_config(name)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_mean=CLIP_MEAN, image_std=CLIP_STD))


def _images(seed, n, hw):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _write_clip(path, h, w, n=14, fps=10.0, seed=0):
    """A seeded lossless (FFV1) clip: the JAX package's libav reader (where
    built) and cv2 decode the same frames."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    assert writer.isOpened()
    for _ in range(n):
        writer.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    writer.release()
    return str(path)


def _varied(outs):
    """The rollouts are not one repeated token."""
    return len({t for o in outs for t in o.split()}) > 2


# ---------------------------------------------------------------------------
# clip-flant5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
def test_clip_flant5_generate_matches_jax(quant):
    """Greedy T5 decode of 3 images x 8 tokens (the batch padded to the text
    bucket 4 by repeating the last row): equal strings. Under int8 the
    first-step distributions of the same prompts are held as the int8 slice
    test holds scores (1e-4 on 3/4 of the rows, 5e-3 on all, in log
    probability of the argmax token)."""
    j, t = scorers("clip-flant5-test", quant)
    images = _images(1, 3, (30, 38))
    want = j.model.generate(images, TEXTS, max_new_tokens=8)
    before = launch_counts()
    got = t.model.generate(images, TEXTS, max_new_tokens=8)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got == want and len(got) == 3 and _varied(got)
    with pytest.raises(ValueError, match="one image per text"):
        t.model.generate(images[:2], TEXTS)


def _first_token_inputs(engine, images, texts):
    questions = [jcft5.format_question(q, engine.cfg.conversation) for q in texts]
    arrays = engine._build_text_arrays(questions, [""] * len(texts))[:4]
    return arrays, np.arange(len(texts), dtype=np.int32)


def test_first_token_distribution_matches_jax():
    j, t = scorers("clip-flant5-test")
    images = _images(2, 3, (30, 38))
    arrays, idx = _first_token_inputs(j.model.engine, images, TEXTS)
    jfeats = j.model.engine.encode_images(images)[:3]
    want = np.asarray(jcft5.first_token_distribution(
        j.model.engine.params, j.model.config, jfeats, *arrays, idx, idx))
    with torch.inference_mode():
        feats = t.model.engine.encode_images(images)
        got = tcft5.first_token_distribution(
            t.model.engine.params, t.model.config, feats,
            *[torch.from_numpy(a) for a in arrays], torch.from_numpy(idx).long(),
            torch.from_numpy(idx).long())
    assert got.shape == want.shape == (3, t.model.config.t5.vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * want.max())


# ---------------------------------------------------------------------------
# Qwen2.5-VL and Qwen3-VL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QWEN)
def test_qwen_generate_matches_jax(name):
    """Batched greedy decode of 3 images x 6 tokens (prompts of different
    lengths in one bucket) and of a clip: equal strings."""
    j, t = scorers(name)
    images = _images(0, 2, (64, 96))
    media = [images[0], images[1], images[0]]
    texts = ["describe", "what is this picture about and why", TEXTS[0]]
    want = j.model.generate(media, texts, max_new_tokens=6)
    got = t.model.generate(media, texts, max_new_tokens=6)
    assert got == want and _varied(got)
    if name == "qwen2.5-vl-test":
        want = j.model.generate([VID, images[1]], ["describe", "a clip"], fps=2.0,
                                max_new_tokens=5)
        assert t.model.generate([VID, images[1]], ["describe", "a clip"], fps=2.0,
                                max_new_tokens=5) == want


@pytest.mark.parametrize("name", ("qwen2.5-vl-test", "qwen3-vl-test"))
def test_qwen_sampled_steps_match_jax(name):
    """The per-sequence path with nucleus sampling and one numpy seed: the
    same tokens, each step's distribution within 1e-5 (Qwen3-VL with its
    deepstack residuals at the prefill)."""
    j, t = scorers(name)
    img = _images(3, 1, (64, 96))
    jarr, jlens = j.model._prepare_pairs(img, ["describe"])
    tarr, tlens = t.model._prepare_pairs(img, ["describe"])
    assert jlens == tlens
    args = [(arr[0][0], arr[1][0], arr[2][0], arr[3][0], arr[4][:, 0]) for arr in (jarr, tarr)]
    kw = dict(temperature=0.9, sample=True, top_p=0.7)
    want = j.model._greedy_steps(*args[0], jlens[0], 6, rng=np.random.default_rng(4), **kw)
    got = t.model._greedy_steps(*args[1], tlens[0], 6, rng=np.random.default_rng(4), **kw)
    assert got[0] == want[0] and len(got[1]) == 6
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def _probs_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=0, atol=LOG_TOL)


def _assert_traces(got, want):
    assert got.keys() == want.keys()
    for key in ("generated_text", "generated_length", "score_position", "score_start_idx",
                "scored_indices", "scored_tokens_text"):
        assert got[key] == want[key], key
    _probs_close(got["probability"], want["probability"])
    assert len(got["token_details"]) == len(want["token_details"])
    for g, w in zip(got["token_details"], want["token_details"]):
        assert g.keys() == w.keys()
        for key in ("position", "expected_token_id", "expected_token_text"):
            assert g[key] == w[key], key
        _probs_close(g["probability"], w["probability"])
        assert ([a["token_id"] for a in g["top_alternatives"]]
                == [a["token_id"] for a in w["top_alternatives"]])
        assert ([a["token_text"] for a in g["top_alternatives"]]
                == [a["token_text"] for a in w["top_alternatives"]])
        _probs_close([a["probability"] for a in g["top_alternatives"]],
                     [a["probability"] for a in w["top_alternatives"]])


@pytest.mark.parametrize("max_new", [1, 4])
@pytest.mark.parametrize("position", ["start", "end"])
@pytest.mark.parametrize("name", ("qwen2.5-vl-test", "qwen3-vl-moe-test"))
def test_forward_with_trace_matches_jax(name, position, max_new):
    """Trace scores within 1e-5 (logs 1e-4 nats) and trace dicts with the
    same keys, ids, texts and positions, for a one-token and a two-token
    answer."""
    j, t = scorers(name)
    images = _images(5, 2, (64, 96))
    for answer in ("Yes", "Yes it is"):
        kw = dict(score_position=position, max_new_tokens=max_new, temperature=1.2,
                  answer_template=answer)
        want, wtr = j.model.forward_with_trace(images, TEXTS[:2], **kw)
        got, gtr = t.model.forward_with_trace(images, TEXTS[:2], **kw)
        assert got.dtype == np.float32 and got.shape == (2,)
        _probs_close(got, want)
        for g, w in zip(gtr, wtr):
            _assert_traces(g, w)


@pytest.mark.parametrize("name", QWEN)
def test_teacher_forcing_matches_jax_and_rollout(name):
    """The teacher-forced trace against JAX's (1e-5, logs 1e-4 nats), and, for a one-token
    answer, against the port's own one-token rollout scored at the start
    (1e-6: the reference's test_teacher_vs_rollout.py)."""
    j, t = scorers(name)
    images = _images(6, 2, (64, 96))
    for answer in ("Yes", "Yes it is"):
        want, wtr = j.model.forward_with_trace_teacher_forcing(images, TEXTS[:2],
                                                               answer_template=answer)
        got, gtr = t.model.forward_with_trace_teacher_forcing(images, TEXTS[:2],
                                                              answer_template=answer)
        _probs_close(got, want)
        for g, w in zip(gtr, wtr):
            _assert_traces(g, w)
    roll, rtr = t.model.forward_with_trace(images, TEXTS[:2], score_position="start")
    tf, ttr = t.model.forward_with_trace_teacher_forcing(images, TEXTS[:2])
    np.testing.assert_allclose(tf, roll, rtol=0, atol=1e-6)
    for r, f in zip(rtr, ttr):
        assert r["token_details"][0]["expected_token_id"] == \
            f["token_details"][0]["expected_token_id"]
        assert abs(r["token_details"][0]["probability"]
                   - f["token_details"][0]["probability"]) < 1e-6
    # and the scoring path's score of the same one-token answer
    np.testing.assert_allclose(t.model.forward(images, TEXTS[:2]), tf, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Gemma 3
# ---------------------------------------------------------------------------

def test_gemma_generate_matches_jax(tmp_path):
    """The batched path (more than one visual, no sampling; eos = the
    smallest id) and the per-sequence one (one visual), on images and on a
    28x28 clip at the test tower's size: equal strings."""
    j, t = scorers("gemma-3-test")
    images = _images(7, 2, (28, 28))
    clip = _write_clip(tmp_path / "tower.avi", 28, 28)
    cases = [(images + [images[0]], ["describe", "what is this picture about", "two dogs"]),
             (images[1:], ["describe"]),
             ([clip, images[0]], ["describe the clip", "a picture"]),
             ([clip], ["describe the clip"])]
    for media, texts in cases:
        want = j.model.generate(media, texts, max_new_tokens=6, num_frames=3)
        got = t.model.generate(media, texts, max_new_tokens=6, num_frames=3)
        assert got == want, (media, texts)
        assert _varied(got) or len(got) == 1
