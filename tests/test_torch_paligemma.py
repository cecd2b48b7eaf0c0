"""Port parity: PaliGemma — ``image_features``, the prefix-LM
``first_token_distribution`` (one bidirectional group over image and prompt,
pad rows causal and masked), ``VQAScore("paligemma-test")`` (scores,
``score_matrix``, ``batch_forward``, ``generate``) — against the JAX package
on the same parameters (carried over by ``bridge.py``), the same tokenizer
instance and the same seeded 28 x 28 uint8 images (the tower's size, where
the JAX package's Pillow resize and the port's device resize are both the
identity); and against a tiny HF PaliGemmaForConditionalGeneration loaded
through ``checkpoint=``.

The port splices the image rows as HF does (times sqrt(d_model) with the
token rows, see ``models/paligemma.py``), the JAX package without that
factor. The JAX side is therefore given the same function: its image
features times sqrt(d_model) (``first_token_distribution``), or its
projector's weight and bias times sqrt(d_model) (the adapters; its
``image_features`` divides them back out). ``test_jax_image_rows_differ``
shows the departure.

Tolerances (fp32): 1e-5 against the JAX package on features, probabilities
and log scores; towers 3e-5 and scores 1e-5 (log) against HF.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import paligemma as jpg  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import paligemma as tpg  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402
from test_torch_hf_parity import stage_safetensors, stage_tokenizer  # noqa: E402

TOL = 1e-5
NAME = "paligemma-test"
IMG = 28
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids: equal strings are
    equal tokens."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(key=0):
    """Numpy parameters of paligemma-test in the JAX layout, made once:
    matrices x 2 (wider logits), vectors (the Gemma norm scales, zero at
    init) moved off their init by N(0, 0.1)."""
    if key not in _PARAMS:
        jp = jpg.init_paligemma(jax.random.PRNGKey(key), jpg.PALIGEMMA_MODELS[NAME]["config"])
        rng = np.random.default_rng(key)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[key] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[key]


def _jax_params():
    """The parameters for the JAX adapter: the projector times sqrt(d_model),
    so that its image rows are the port's (and HF's)."""
    params = _params()
    c = np.float32(jpg.PALIGEMMA_MODELS[NAME]["config"].text.d_model ** 0.5)
    proj = {k: np.asarray(v) * c for k, v in params["projector"].items()}
    return {**params, "projector": proj}


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]


def _scorers(tok=None):
    tok = tok or IdTokenizer(512)
    return (jt2v.VQAScore(NAME, params=_jax_params(), tokenizer=tok),
            tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu"))


def test_registry_matches_jax():
    assert list(tpg.PALIGEMMA_MODELS) == list(jpg.PALIGEMMA_MODELS)
    for name, spec in jpg.PALIGEMMA_MODELS.items():
        got = tpg.PALIGEMMA_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
    cfg = tpg.PALIGEMMA_MODELS["paligemma-3b-mix-896"]["config"]
    assert (cfg.num_image_tokens, cfg.text.heads, cfg.text.kv_heads, cfg.text.head_dim) == \
        (4096, 8, 1, 256)


def test_image_features_match_jax():
    params = _params()
    cfg = jpg.PALIGEMMA_MODELS[NAME]["config"]
    tcfg = tpg.PALIGEMMA_MODELS[NAME]["config"]
    px = np.random.default_rng(1).uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jpg.image_features(params, cfg, jnp.asarray(px)))
    model = bridge.paligemma_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tpg.image_features(model, tcfg, torch.from_numpy(px.reshape(3, IMG, -1)))
    assert got.shape == (3, cfg.num_image_tokens, cfg.text.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_first_token_distribution_matches_jax():
    """Two sequences in one bucket, one shorter: its pad rows are outside the
    prefix group (-1), causal and masked, and its prefix stays one group."""
    params = _params()
    cfg = jpg.PALIGEMMA_MODELS[NAME]["config"]
    tcfg = tpg.PALIGEMMA_MODELS[NAME]["config"]
    n_vis, s = cfg.num_image_tokens, 16
    rng = np.random.default_rng(2)
    lens = [14, 9]
    ids = np.zeros((2, s), np.int64)
    attn = np.zeros((2, s), bool)
    for j, n in enumerate(lens):
        ids[j, :n] = [cfg.image_token_id] * n_vis + [2] + list(rng.integers(3, 500, n - n_vis - 1))
        attn[j, :n] = True
    vis_mask = ids == cfg.image_token_id
    vis_slot = np.zeros_like(ids)
    vis_slot[vis_mask] = np.tile(np.arange(n_vis), 2)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    last = np.asarray(lens) - 1
    feats = rng.normal(size=(2, n_vis, cfg.text.d_model)).astype(np.float32)
    arrays = (ids, feats, vis_mask, vis_slot, pos, attn, attn, last)
    c = np.float32(cfg.text.d_model ** 0.5)
    want = np.asarray(jpg.first_token_distribution(
        params, cfg, *map(jnp.asarray, (ids, feats * c, *arrays[2:]))))
    model = bridge.paligemma_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tpg.first_token_distribution(model, tcfg, *map(torch.from_numpy, arrays))
    assert got.shape == (2, cfg.text.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * want.max(), rtol=0)
    np.testing.assert_array_equal(tpg.prefix_groups(torch.from_numpy(attn)).numpy()[1],
                                  [0] * 9 + [-1] * 7)


def test_jax_image_rows_differ():
    """The JAX package on the port's own parameters gives other scores: its
    image rows miss the sqrt(d_model) factor."""
    tok = IdTokenizer(512)
    j = jt2v.VQAScore(NAME, params=_params(), tokenizer=tok)
    t = tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu")
    images = _images(3, 2)
    gap = np.abs(np.log(t(images=images, texts=TEXTS)) - np.log(j(images=images, texts=TEXTS)))
    assert gap.max() > 1e3 * TOL


def test_score_matrix_forward_and_batch_forward_match_jax():
    j, t = _scorers()
    images = _images(3, 3)
    want = j(images=images, texts=TEXTS)
    before = launch_counts()
    got = t(images=images, texts=TEXTS)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, 3) and got.dtype == np.float32
    assert np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * TOL          # the pairs differ
    imgs = [images[0], images[2], images[0]]
    np.testing.assert_allclose(np.log(t.model.forward(imgs, TEXTS)),
                               np.log(j.model.forward(imgs, TEXTS)), atol=TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(4)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (4, 1, 3)
    for i in range(4):
        np.testing.assert_allclose(out[i, 0], got[i % 3], atol=1e-7, rtol=1e-6)


def test_first_non_bos_answer_id():
    """A tokenizer that puts BOS first even without special tokens: the
    score is still the answer's first content id's probability."""
    class BosFirst(IdTokenizer):
        def encode(self, text, add_special_tokens=True):
            return [self.bos_token_id] + super().encode(text, add_special_tokens)

    tok = BosFirst(512)
    tok.bos_token_id = 7
    b = tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu")
    ans = b.model._first_answer_token("Yes")
    assert tok.encode("Yes", False)[0] == 7
    assert ans == tok.encode("Yes", False)[1] != 7


def test_generate_matches_jax():
    j, t = _scorers()
    images = _images(4, 2)
    texts = ["describe", "what is on the table"]
    want = j.model.generate(images, texts, max_new_tokens=6)
    got = t.model.generate(images, texts, max_new_tokens=6)
    assert got == want
    # the prompt's text comes first in the decode, as the reference's does
    prompt = t.model._encode_text(texts[1] + "\n")
    assert got[1].split()[:len(prompt)] == [str(i) for i in prompt]


def test_random_init_and_entry_points():
    cfg = tpg.PALIGEMMA_MODELS[NAME]["config"]
    m = tpg.init_paligemma(cfg, 0, "cpu")
    for norm in (m.decoder.blocks[0].ln1, m.decoder.blocks[1].ln2, m.decoder.ln_final):
        assert torch.equal(norm.scale, torch.zeros_like(norm.scale))
    assert m.decoder.lm_head is None and m.decoder.blocks[0].qkv.w.shape == (48, 6 * 16)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        for name in ("paligemma-3b-mix-224", NAME):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tt2v.VQAScore(name, init="random")
        assert tt2v.VQAScore(NAME, device="cpu").model.device.type == "cpu"


# ---------------------------------------------------------------------------
# Against HF, through checkpoint=
# ---------------------------------------------------------------------------

WORDS = ("Does this figure show \" a photo of cat \" ? Please answer Yes or No . "
         "two dogs on grass describe")


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import PaliGemmaForConditionalGeneration
    from transformers.models.paligemma.configuration_paligemma import \
        PaliGemmaConfig as HFConfig

    torch.manual_seed(5)
    hf = PaliGemmaForConditionalGeneration(HFConfig(
        text_config=dict(model_type="gemma", vocab_size=512, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=1, head_dim=16,
                         hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6,
                         rope_theta=10_000.0, attention_bias=False,
                         tie_word_embeddings=True, max_position_embeddings=512),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=IMG, patch_size=14,
                           hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6,
                           projection_dim=48),
        image_token_index=500, bos_token_id=2, pad_token_id=0, projection_dim=48)).eval()
    with torch.no_grad():     # the (1 + w) norm scales away from their zero init
        for name, p in hf.named_parameters():
            if "layernorm" in name or name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape))
    root = tmp_path_factory.mktemp("paligemma")
    path = stage_safetensors(hf.state_dict(), str(root / "ckpt"))
    tok = stage_tokenizer(str(root / "tok"), WORDS)
    return hf, path, tok


def test_checkpoint_matches_hf(monkeypatch, hf_dirs):
    from t2v_metrics_tpu_torch.models.gemma_adapters import siglip_preprocess

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    hf, path, tok = hf_dirs
    cfg = tpg.PALIGEMMA_MODELS[NAME]["config"]
    s = tt2v.VQAScore("paligemma-3b-mix-224", config=cfg, checkpoint=path, tokenizer=tok,
                      device="cpu", dtype=torch.float32)
    a = s.model
    images = _images(6, 2)
    texts = ["a photo of cat", "two dogs on grass"]
    got = s(images=images, texts=texts)
    for i, img in enumerate(images):
        px = siglip_preprocess(torch.from_numpy(img).reshape(1, IMG, IMG * 3), IMG)
        px = px.reshape(1, IMG, IMG, 3).permute(0, 3, 1, 2)
        with torch.no_grad():
            ref_feats = hf.model.get_image_features(px)[0]
        np.testing.assert_allclose(a._encode_images([img])[0].numpy(), ref_feats.numpy(),
                                   atol=3e-5, rtol=0)
        for jt, text in enumerate(texts):
            ids = a._prompt_ids('Does this figure show "{}"? Please answer Yes or No.'
                                .format(text))
            with torch.no_grad():
                logits = hf(input_ids=torch.tensor([ids]), pixel_values=px).logits
            ref = torch.log_softmax(logits[0, -1].float(), -1)[a._first_answer_token("Yes")]
            assert abs(np.log(got[i, jt]) - float(ref)) <= TOL, (i, jt)
