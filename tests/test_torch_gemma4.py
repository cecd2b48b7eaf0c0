"""Port parity: Gemma 4 — the registry, ``parse_response``, the end-aligned
``score_rollout`` rule, ``VQAScore("gemma-4-test")`` scores (the batched
rollout for more than one pair, the per-sequence one for a single pair),
``score_matrix``, ``batch_forward`` and ``generate`` — against the JAX
package on the same parameters (carried over by ``bridge.py``), the same
tokenizer instance and the same seeded 28 x 28 uint8 images; the batched
rollout against the per-sequence one; the checkpoint paths (a native tree
whose dims are adopted, an HF directory in the Gemma 3 layout).

No public HF implementation of Gemma 4 exists (``models/gemma4.py``), so
there is no HF parity here. Tolerances (fp32): 1e-5 on log scores, strings
equal (the tokenizer spells ids, so equal strings are equal tokens).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import gemma4 as jg4  # noqa: E402
from t2v_metrics_tpu.models.generation import score_rollout as j_score_rollout  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from t2v_metrics_tpu_torch.models import gemma4 as tg4  # noqa: E402
from t2v_metrics_tpu_torch.models.generation import score_rollout  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-5
NAME = "gemma-4-test"
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids; ``special`` is its
    ``all_special_ids``."""

    def __init__(self, vocab_size, special=()):
        super().__init__(vocab_size)
        self.all_special_ids = list(special)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(key=0):
    """Numpy parameters of gemma-4-test in the JAX layout: matrices x 2,
    vectors (the zero-init Gemma norm scales) moved off their init by
    N(0, 0.1)."""
    if key not in _PARAMS:
        jp = jg4.init_gemma4(jax.random.PRNGKey(key), jg4.GEMMA4_MODELS[NAME]["config"])
        rng = np.random.default_rng(key)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[key] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[key]


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(n)]


def _scorers(tok):
    return (jt2v.VQAScore(NAME, params=_params(), tokenizer=tok),
            tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu"))


def test_registry_matches_jax():
    assert list(tg4.GEMMA4_MODELS) == list(jg4.GEMMA4_MODELS)
    for name, spec in jg4.GEMMA4_MODELS.items():
        got = tg4.GEMMA4_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
    text = tg4.GEMMA4_MODELS["gemma-4-31b-it"]["config"].text
    assert (text.heads, text.kv_heads, text.head_dim, text.q_scale) == (32, 16, 128, 168 ** -0.5)


@pytest.mark.parametrize("raw", ["<think>hmm</think>Yes", "plain answer",
                                 "<|channel|>thought\nblah<|channel|>Yes",
                                 "<|channel>thought\n<channel|> No ", "<think>a</think> b <think>c"])
def test_parse_response_matches_jax(raw):
    assert tg4.parse_response(raw) == jg4.parse_response(raw)


def test_score_rollout_end_alignment():
    """The answer is scored from the end of the rollout, one step earlier
    when the last token is special (the JAX package's own cases)."""
    v = np.zeros(16, np.float32)

    def dist(tok, p):
        d = v.copy()
        d[tok], d[0] = p, 1.0 - p
        return d

    dists = [dist(3, .9), dist(4, .9), dist(7, .8), dist(1, .9)]
    cases = [(dists, [3, 4, 7, 1], [7], 0.8), (dists[:3], [3, 4, 7], [7], 0.8),
             ([dist(5, .5), dist(7, .25), dist(1, .9)], [5, 7, 1], [5, 7],
              (0.5 * 0.25) ** 0.5)]
    for d, gen, ans, want in cases:
        assert abs(score_rollout(d, gen, ans, {1}) - want) < 1e-6
        assert score_rollout(d, gen, ans, {1}) == j_score_rollout(d, gen, ans, {1})


@pytest.mark.parametrize("path", ["batched", "per_sequence"])
def test_rollout_scores_match_jax(path):
    """More than one pair takes the batched rollout (the answer ids'
    probabilities gathered at each step), one pair the per-sequence one."""
    j, t = _scorers(IdTokenizer(512))
    images = _images(1, 3)
    if path == "batched":
        want = j(images=images, texts=TEXTS)
        before = launch_counts()
        got = t(images=images, texts=TEXTS)
        assert launch_counts() == before             # the CPU runs no kernel
        assert got.shape == (3, 3)
    else:
        want = np.stack([j(images=[im], texts=[TEXTS[1]]) for im in images])
        got = np.stack([t(images=[im], texts=[TEXTS[1]]) for im in images])
    assert np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * TOL


def test_batched_rollout_equals_sequential_and_special_offset():
    """The batched rollout's scores equal the per-sequence ones; with the
    last generated id special, both score one step earlier, as the JAX
    package does."""
    tok = IdTokenizer(512)
    j, t = _scorers(tok)
    images = _images(2, 3)
    batched = t.model.forward(images, TEXTS)
    single = np.concatenate([t.model.forward([im], [tx]) for im, tx in zip(images, TEXTS)])
    np.testing.assert_allclose(np.log(batched), np.log(single), atol=TOL, rtol=0)
    q = 'Does this figure show "{}"? Please answer Yes or No.'.format(TEXTS[0])
    gen, dists = t.model._rollout(images[0], q, 10, 5)
    assert len(gen) == 5
    tok.all_special_ids = [1, gen[-1]]
    want, got = j.model.forward(images, TEXTS), t.model.forward(images, TEXTS)
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    ans = t.model._encode_text("Yes")
    shifted = score_rollout(dists, gen, ans, {1, gen[-1]})
    assert abs(np.log(t.model.forward([images[0]], [TEXTS[0]])[0]) - np.log(shifted)) <= TOL
    assert abs(np.log(shifted) - np.log(score_rollout(dists, gen, ans, {1}))) > 100 * TOL


def test_batch_forward_takes_the_rollout():
    _, t = _scorers(IdTokenizer(512))
    images = _images(3, 2)
    data = [{"images": [images[i % 2]], "texts": TEXTS[:2]} for i in range(3)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (3, 1, 2)
    for i in range(3):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 2]], texts=TEXTS[:2])[0],
                                   atol=1e-7, rtol=1e-5)


def test_generate_matches_jax():
    """Specials kept in the decode, the thinking block stripped."""
    j, t = _scorers(IdTokenizer(512))
    images = _images(4, 2)
    texts = ["describe", "what is on the table"]
    want = j.model.generate(images, texts, max_new_tokens=6)
    assert t.model.generate(images, texts, max_new_tokens=6) == want
    assert all(len(w.split()) >= 1 for w in want)


def test_checkpoints_and_entry_points(tmp_path):
    """A native tree of other dims is adopted (with a warning); an HF
    directory loads through the Gemma 3 converter; without weights the
    registry models raise, as the JAX adapter does."""
    from test_torch_hf_parity import _gemma_hf, stage_safetensors

    tree = jax.tree.map(np.asarray, jg4.init_gemma4(jax.random.PRNGKey(3),
                                                    jg4.GEMMA4_MODELS[NAME]["config"]))
    tree["decoder"]["blocks"] = tree["decoder"]["blocks"][:2]
    ckpt.save_params(tree, str(tmp_path / "native"))
    with pytest.warns(UserWarning, match="text.layers 3 -> 2"):
        s = tt2v.VQAScore(NAME, checkpoint=str(tmp_path / "native"), device="cpu",
                          tokenizer=IdTokenizer(512))
    assert s.model.config.text.layers == 2 and len(s.model.params.decoder.blocks) == 2
    assert s(images=_images(5, 1), texts=["a"]).shape == (1, 1)
    hf, cfg3 = _gemma_hf()
    path = stage_safetensors(hf.state_dict(), str(tmp_path / "hf"))
    g4 = tt2v.VQAScore("gemma-4-12b-it", config=cfg3, checkpoint=path, device="cpu",
                       tokenizer=IdTokenizer(512))
    g3 = tt2v.VQAScore("gemma-3-4b-it", config=cfg3, checkpoint=path, device="cpu",
                       tokenizer=IdTokenizer(512))
    for a, b in zip(g4.model.params.state_dict().values(),
                    g3.model.params.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no public HF implementation"):
        tt2v.VQAScore("gemma-4-31b-it", device="cpu")
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("gemma-4-12b-it", init="random")
