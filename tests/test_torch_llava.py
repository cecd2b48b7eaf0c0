"""Port parity: LLaVA-1.5 — the registry, the ``tokenizer_image_token``
splice, ``image_features`` (CLIP at feature layer -2, the CLS row dropped,
the 2-layer GELU projector), ``splice_and_score``, ``VQAScore("llava-test")``
(scores in the 640 and the 704 bucket, ``score_matrix``, ``batch_forward``,
``generate``) — against the JAX package on the same parameters (carried
over by ``bridge.py``), the same tokenizer instance and the same seeded
28 x 28 uint8 images (the tower's size: no resize on either side); and
against a tiny HF LlavaForConditionalGeneration loaded through
``checkpoint=``.

One departure from the JAX package: with a tokenizer that puts BOS first,
its splice writes two image markers for each ``<image>`` (so two image
blocks), where the reference's ``tokenizer_image_token`` writes one; the
port follows the reference (``test_splice_with_bos_follows_the_reference``).
The tokenizers of the parity tests put no BOS first, where both agree.

Tolerances (fp32): 1e-5 against the JAX package on features and log
scores; towers 3e-5 and mean answer log-probs 1e-5 against HF.
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
from t2v_metrics_tpu import tokenization as jtok  # noqa: E402
from t2v_metrics_tpu.models import llava as jlv  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch import tokenization as ttok  # noqa: E402
from t2v_metrics_tpu_torch.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from t2v_metrics_tpu_torch.models import llava as tlv  # noqa: E402
from t2v_metrics_tpu_torch.models.llava_adapter import SEQ_BUCKETS, _bucket  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402
from test_torch_hf_parity import stage_safetensors, stage_tokenizer  # noqa: E402

TOL = 1e-5
NAME = "llava-test"
IMG = 28
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
# past the 640-row bucket: the system prompt, 4 image rows and ~600 words
LONG = " ".join(["red", "cube", "on", "a", "wooden", "table"] * 104)
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(key=0):
    """Numpy parameters of llava-test in the JAX layout, matrices x 2 (wider
    logits), vectors moved off their init by N(0, 0.1)."""
    if key not in _PARAMS:
        jp = jlv.init_llava(jax.random.PRNGKey(key), jlv.LLAVA_MODELS[NAME]["config"])
        rng = np.random.default_rng(key)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[key] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[key]


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]


def _scorers(tok=None):
    tok = tok or IdTokenizer(512)
    return (jt2v.VQAScore(NAME, params=_params(), tokenizer=tok),
            tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu"))


def test_registry_matches_jax():
    assert list(tlv.LLAVA_MODELS) == list(jlv.LLAVA_MODELS)
    for name, spec in jlv.LLAVA_MODELS.items():
        got = tlv.LLAVA_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
    cfg = tlv.LLAVA_MODELS["llava-v1.5-7b"]["config"]
    assert (cfg.num_image_tokens, cfg.text.head_dim, cfg.text.rms_eps, cfg.text.vocab_size,
            cfg.text.tie_embeddings) == (576, 128, 1e-5, 32000, False)


def test_splice_matches_jax_without_bos():
    tok = IdTokenizer(512)
    prompt = "sys USER: <image>\nq one <image> two ASSISTANT:"
    got = ttok.splice_image_tokens(prompt, tok)
    assert got == jtok.splice_image_tokens(prompt, tok)
    assert got.count(IMAGE_TOKEN_INDEX) == 2


def test_splice_with_bos_follows_the_reference():
    """BOS once, from the first chunk; each ``<image>`` one marker (the
    reference's ``tokenizer_image_token``; the JAX package writes two)."""
    class Bos(IdTokenizer):
        def __call__(self, text, add_special_tokens=True):
            enc = super().__call__(text, add_special_tokens)
            enc.input_ids = [self.bos_token_id] + enc.input_ids
            return enc

    tok = Bos(512)
    tok.bos_token_id = 9
    prompt = "sys USER: <image>\nq ASSISTANT:"
    chunks = [tok(c).input_ids for c in prompt.split("<image>")]
    got = ttok.splice_image_tokens(prompt, tok)
    assert got == chunks[0] + [IMAGE_TOKEN_INDEX] + chunks[1][1:]
    assert jtok.splice_image_tokens(prompt, tok).count(IMAGE_TOKEN_INDEX) == 2


def test_image_features_and_splice_and_score_match_jax():
    params = _params()
    cfg = jlv.LLAVA_MODELS[NAME]["config"]
    tcfg = tlv.LLAVA_MODELS[NAME]["config"]
    rng = np.random.default_rng(1)
    px = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = np.array(jlv.image_features(params, cfg, jnp.asarray(px)))
    model = bridge.llava_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tlv.image_features(model, tcfg, torch.from_numpy(px.reshape(2, IMG, -1)))
    assert got.shape == (2, 4, cfg.text.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())

    b, s, t_img = 2, 20, cfg.num_image_tokens
    ids = rng.integers(3, 512, (b, s))
    vis_mask = np.zeros((b, s), bool)
    vis_mask[:, 3:3 + t_img] = True
    ids[vis_mask] = 0
    vis_slot = np.zeros((b, s), np.int64)
    vis_slot[vis_mask] = np.tile(np.arange(t_img), b)
    attn = np.arange(s)[None] < np.array([[20], [15]])
    ans_ids = rng.integers(3, 512, (b, 2))
    ans_pos = np.array([[17, 18], [12, 13]])
    ans_mask = np.array([[1, 1], [1, 0]], np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    arrays = (ids, want, vis_mask, vis_slot, pos, attn, ans_ids, ans_pos, ans_mask)
    w = np.asarray(jlv.splice_and_score(params, cfg, *map(jnp.asarray, arrays)))
    with torch.inference_mode():
        g = tlv.splice_and_score(model, tcfg, *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)


@pytest.mark.parametrize("texts,bucket", [(TEXTS, 640), ([TEXTS[0], LONG], 704)])
def test_scores_match_jax(texts, bucket):
    """The system prompt plus a long text pushes a prompt past 640 rows."""
    j, t = _scorers()
    images = _images(3, 3)
    question = 'Does this figure show "{}"? Please answer yes or no.'.format(texts[-1])
    spliced = ttok.splice_image_tokens(t.model._prompt(question), t.model.tokenizer)
    assert _bucket(t.model._length(spliced) + 1, SEQ_BUCKETS) == bucket
    want = j(images=images, texts=texts)
    before = launch_counts()
    got = t(images=images, texts=texts)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, len(texts)) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * TOL


def test_pairwise_forward_batch_forward_and_generate_match_jax():
    j, t = _scorers()
    images = _images(4, 3)
    imgs = [images[0], images[2], images[0]]
    np.testing.assert_allclose(np.log(t.model.forward(imgs, TEXTS)),
                               np.log(j.model.forward(imgs, TEXTS)), atol=TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(4)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (4, 1, 3)
    for i in range(4):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 3]], texts=TEXTS)[0],
                                   atol=1e-7, rtol=1e-5)
    gen_texts = ["describe", "what is on the table"]
    want = j.model.generate(images[:2], gen_texts, max_new_tokens=6)
    assert t.model.generate(images[:2], gen_texts, max_new_tokens=6) == want


def test_random_init_and_entry_points():
    cfg = tlv.LLAVA_MODELS[NAME]["config"]
    m = tlv.init_llava(cfg, 0, "cpu")
    assert m.decoder.lm_head.shape == (48, 512)
    assert torch.equal(m.projector.fc1.b, torch.zeros(48))
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("llava-v1.5-7b", init="random")
        assert tt2v.VQAScore(NAME, device="cpu").model.device.type == "cpu"


# ---------------------------------------------------------------------------
# Against HF, through checkpoint=
# ---------------------------------------------------------------------------

WORDS = ("A chat between a curious user and an artificial intelligence assistant . The "
         "assistant gives helpful , detailed , and polite answers to the user's questions "
         "USER: ASSISTANT: Does this figure show \" a photo of cat \" ? Please answer yes "
         "or no . Yes two dogs on grass")


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(6)
    hf = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=IMG, patch_size=14,
                           projection_dim=24),
        text_config=dict(model_type="llama", vocab_size=512, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=4, rms_norm_eps=1e-5, rope_theta=10000.0,
                         tie_word_embeddings=False, max_position_embeddings=256),
        image_token_index=500, vision_feature_layer=-2,
        vision_feature_select_strategy="default")).eval()
    root = tmp_path_factory.mktemp("llava")
    path = stage_safetensors(hf.state_dict(), str(root / "ckpt"))
    tok = stage_tokenizer(str(root / "tok"), WORDS)
    return hf, path, tok


def test_checkpoint_matches_hf(monkeypatch, hf_dirs):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    hf, path, tok = hf_dirs
    cfg = tlv.LLAVA_MODELS[NAME]["config"]
    s = tt2v.VQAScore("llava-v1.5-7b", config=cfg, checkpoint=path, tokenizer=tok,
                      device="cpu", dtype=torch.float32)
    a = s.model
    assert type(a.tokenizer).__name__ == "PreTrainedTokenizerFast"
    images = _images(7, 2)
    texts = ["a photo of cat", "two dogs on grass"]
    got = s(images=images, texts=texts)
    t_img = cfg.num_image_tokens
    for i, img in enumerate(images):
        px = torch.from_numpy(img).float().div(255)
        mean, std = (torch.tensor(v) for v in ((0.48145466, 0.4578275, 0.40821073),
                                               (0.26862954, 0.26130258, 0.27577711)))
        px = ((px - mean) / std).permute(2, 0, 1)[None]
        with torch.no_grad():
            hv = hf.vision_tower(px, output_hidden_states=True)
            ref_feats = hf.multi_modal_projector(hv.hidden_states[-2][:, 1:])[0]
        np.testing.assert_allclose(a._encode_images([img])[0].numpy(), ref_feats.numpy(),
                                   atol=3e-5, rtol=0)
        for jt, text in enumerate(texts):
            spliced = ttok.splice_image_tokens(a._prompt(
                'Does this figure show "{}"? Please answer yes or no.'.format(text)),
                a.tokenizer)
            prompt = [y for x in spliced
                      for y in ([500] * t_img if x == IMAGE_TOKEN_INDEX else [x])]
            ans = a._answer_ids("Yes")
            ids = torch.tensor([prompt + ans])
            with torch.no_grad():
                logits = hf(input_ids=ids, pixel_values=px).logits
            logp = torch.log_softmax(logits[0].float(), -1)
            ref = np.mean([float(logp[len(prompt) - 1 + k, x]) for k, x in enumerate(ans)])
            assert abs(np.log(got[i, jt]) - ref) <= TOL, (i, jt, np.log(got[i, jt]), ref)


@pytest.mark.parametrize("hw", [(17, 9), (40, 50), (300, 380), (500, 640)])
def test_scores_at_other_image_sizes_match_jax(hw):
    """Every image is padded and resized to uint8 as the JAX adapter's
    Pillow pipeline does (bit for bit, see tests/test_torch_image.py), below
    and above the 384 px of CLIP-FlanT5's device path."""
    j, t = _scorers()
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2)]
    np.testing.assert_allclose(np.log(t(images=images, texts=TEXTS[:2])),
                               np.log(j(images=images, texts=TEXTS[:2])), atol=TOL, rtol=0)
