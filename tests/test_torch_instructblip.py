"""Port parity: InstructBLIP — the registry, ``query_features`` (the queries
and the instruction in one self-attention stream through the Q-Former, the
queries alone cross-attending the EVA features), ``score_pairs``,
``VQAScore("instructblip-test")`` (``score_matrix``, ``batch_forward``,
``generate``) — against the JAX package on the same parameters (carried
over by ``bridge.py``), the same tokenizer instances and the same seeded
28 x 28 uint8 images (the tower's size, where the JAX package's Pillow
resize and the port's device resize are both the identity); and against a
tiny HF InstructBlipForConditionalGeneration loaded through
``checkpoint=``.

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
from t2v_metrics_tpu.models import instructblip as jib  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from t2v_metrics_tpu_torch.models import instructblip as tib  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402
from test_torch_hf_parity import stage_safetensors, stage_tokenizer  # noqa: E402

TOL = 1e-5
NAME = "instructblip-test"
IMG = 28
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
_PARAMS = {}


class IdTokenizer(SimpleT5Tokenizer):
    """SimpleT5Tokenizer whose decode spells the ids."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)


def _params(key=0):
    """Numpy parameters of instructblip-test in the JAX layout: matrices x 2
    (wider logits), vectors moved off their init by N(0, 0.1)."""
    if key not in _PARAMS:
        jp = jib.init_instructblip(jax.random.PRNGKey(key),
                                   jib.INSTRUCTBLIP_MODELS[NAME]["config"])
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


def _scorers():
    """(JAX scorer, port scorer on the CPU); the JAX one holds device arrays
    (its T5 decode loop indexes the embedding with traced ids)."""
    kw = dict(tokenizer=IdTokenizer(512), qf_tokenizer=IdTokenizer(256))
    return (jt2v.VQAScore(NAME, params=jax.tree.map(jnp.asarray, _params()), **kw),
            tt2v.VQAScore(NAME, params=_params(), device="cpu", **kw))


def _arrays(rng, b=2):
    """Seeded pixels, Q-Former instruction ids and mask, T5 prompt ids and
    mask (rows of other lengths), answers with ``</s>``."""
    px = rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32)
    qf_ids = np.array([[101, 5, 6, 102, 0], [101, 9, 102, 0, 0]])[:b]
    ids = np.array([[21, 22, 23, 1, 0], [31, 32, 1, 0, 0]])[:b]
    ans = np.array([[41, 1], [42, 1]])[:b]
    return px, qf_ids, qf_ids != 0, ids, ids != 0, ans, np.ones(ans.shape, np.float32)


def test_registry_matches_jax():
    assert list(tib.INSTRUCTBLIP_MODELS) == list(jib.INSTRUCTBLIP_MODELS)
    for name, spec in jib.INSTRUCTBLIP_MODELS.items():
        got = tib.INSTRUCTBLIP_MODELS[name]
        assert (got["hf"], got["tokenizer"]) == (spec["hf"], spec["tokenizer"])
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name


def test_query_features_and_score_pairs_match_jax():
    params = _params()
    cfg = jib.INSTRUCTBLIP_MODELS[NAME]["config"]
    tcfg = tib.INSTRUCTBLIP_MODELS[NAME]["config"]
    px, qf_ids, qf_mask, ids, enc_mask, ans, ans_mask = _arrays(np.random.default_rng(2))
    model = bridge.instructblip_from_numpy(params, tcfg, "cpu", torch.float32)
    want = np.asarray(jib.query_features(params, cfg, *map(jnp.asarray, (px, qf_ids, qf_mask))))
    with torch.inference_mode():
        got = tib.query_features(model, tcfg, torch.from_numpy(px.reshape(2, IMG, -1)),
                                 torch.from_numpy(qf_ids), torch.from_numpy(qf_mask))
    assert got.shape == (2, cfg.num_query_tokens, cfg.t5.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())
    arrays = (px, qf_ids, qf_mask, ids, enc_mask, ans, ans_mask)
    want = np.asarray(jib.score_pairs(params, cfg, *map(jnp.asarray, arrays)))
    with torch.inference_mode():
        got = tib.score_pairs(model, tcfg, torch.from_numpy(px.reshape(2, IMG, -1)),
                              *map(torch.from_numpy, arrays[1:]))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_scores_batch_forward_and_generate_match_jax():
    j, t = _scorers()
    images = _images(3, 3)
    want = j(images=images, texts=TEXTS)
    before = launch_counts()
    got = t(images=images, texts=TEXTS)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, 3) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * TOL
    imgs = [images[0], images[2], images[0]]
    np.testing.assert_allclose(np.log(t.model.forward(imgs, TEXTS)),
                               np.log(j.model.forward(imgs, TEXTS)), atol=TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(4)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (4, 1, 3)
    for i in range(4):
        np.testing.assert_allclose(out[i, 0], got[i % 3], atol=1e-7, rtol=1e-5)
    gen_texts = ["describe", "what is on the table"]
    want = j.model.generate(images[:2], gen_texts, max_new_tokens=6)
    assert t.model.generate(images[:2], gen_texts, max_new_tokens=6) == want


def test_random_init_and_entry_points():
    cfg = tib.INSTRUCTBLIP_MODELS[NAME]["config"]
    m = tib.init_instructblip(cfg, 0, "cpu")
    assert m.proj.w.shape == (32, 64) and torch.equal(m.proj.b, torch.zeros(64))
    assert abs(m.query_tokens.std().item() - 0.02) < 0.01
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("instructblip-flant5-xl", init="random")
        assert tt2v.VQAScore(NAME, device="cpu").model.device.type == "cpu"


# ---------------------------------------------------------------------------
# Against HF, through checkpoint=
# ---------------------------------------------------------------------------

WORDS = "Does this figure show \" a photo of cat \" ? Please answer yes or no . Yes two dogs"


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import InstructBlipConfig, InstructBlipForConditionalGeneration

    torch.manual_seed(1)
    hf = InstructBlipForConditionalGeneration(InstructBlipConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=IMG, patch_size=14,
                           hidden_act="gelu"),
        qformer_config=dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            cross_attention_frequency=2, max_position_embeddings=64,
                            hidden_act="gelu"),
        text_config=dict(model_type="t5", vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                         num_heads=4, num_layers=2, num_decoder_layers=2,
                         tie_word_embeddings=False, is_gated_act=True,
                         dense_act_fn="gelu_new", feed_forward_proj="gated-gelu",
                         decoder_start_token_id=0, pad_token_id=0),
        num_query_tokens=4)).eval()
    hf.config.image_token_id = 510
    root = tmp_path_factory.mktemp("instructblip")
    path = stage_safetensors(hf.state_dict(), str(root / "ckpt"))
    tok = stage_tokenizer(str(root / "tok"), WORDS, t5=True)
    qtok = stage_tokenizer(str(root / "qtok"), WORDS, t5=True)
    return hf, path, tok, qtok


def test_checkpoint_matches_hf(monkeypatch, hf_dirs):
    from t2v_metrics_tpu_torch.models import blip2_itm as tbitm
    from t2v_metrics_tpu_torch.models.itm_adapter import itm_preprocess

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    hf, path, tok, qtok = hf_dirs
    cfg = tib.INSTRUCTBLIP_MODELS[NAME]["config"]
    s = tt2v.VQAScore("instructblip-flant5-xl", config=cfg, checkpoint=path, tokenizer=tok,
                      qf_tokenizer=qtok, device="cpu", dtype=torch.float32)
    a = s.model
    images = _images(8, 2)
    texts = ["a photo of cat", "two dogs"]
    got = s(images=images, texts=texts)
    nq = cfg.num_query_tokens
    for i, img in enumerate(images):
        flat = itm_preprocess(torch.from_numpy(img).reshape(1, IMG, IMG * 3), IMG)
        px = flat.reshape(1, IMG, IMG, 3).permute(0, 3, 1, 2)
        with torch.no_grad():
            ref_tower = hf.vision_model(px).last_hidden_state
            ours = tbitm.vision_tower(a.params.vision, cfg.vision, flat)
        np.testing.assert_allclose(ours.numpy(), ref_tower.numpy(), atol=3e-5, rtol=0)
        for jt, text in enumerate(texts):
            q = 'Does this figure show "{}"? Please answer yes or no.'.format(text)
            qf_ids, ids = a.qf_tokenizer(q).input_ids, a.tokenizer(q).input_ids
            ans = a.tokenizer("Yes").input_ids
            with torch.no_grad():
                logits = hf(pixel_values=px, qformer_input_ids=torch.tensor([qf_ids]),
                            qformer_attention_mask=torch.ones((1, len(qf_ids)), dtype=torch.long),
                            input_ids=torch.tensor([[510] * nq + ids]),
                            attention_mask=torch.ones((1, nq + len(ids)), dtype=torch.long),
                            decoder_input_ids=torch.tensor([[0] + ans[:-1]])).logits
            logp = torch.log_softmax(logits[0].float(), -1)
            ref = np.mean([float(logp[k, x]) for k, x in enumerate(ans)])
            assert abs(np.log(got[i, jt]) - ref) <= TOL, (i, jt, np.log(got[i, jt]), ref)


def test_missing_qformer_key_is_named(tmp_path, hf_dirs):
    from safetensors.torch import load_file

    _, path, tok, qtok = hf_dirs
    sd = {}
    for f in sorted((p for p in __import__("os").listdir(path) if p.endswith(".safetensors"))):
        sd.update(load_file(f"{path}/{f}"))
    del sd["qformer.embeddings.layernorm.weight"]
    broken = stage_safetensors(sd, str(tmp_path / "broken"))
    with pytest.raises(ckpt.CheckpointError, match="layernorm.weight"):
        tt2v.VQAScore("instructblip-flant5-xl", config=tib.INSTRUCTBLIP_MODELS[NAME]["config"],
                      checkpoint=broken, tokenizer=tok, qf_tokenizer=qtok, device="cpu")


def test_vqascore_list_equals_the_jax_list_but_unported_families():
    """The port's VQAScore list is the JAX package's, in its order: every
    family is ported, the remote API scorers (GPT-4o, Gemini) included, so
    nothing is left out."""
    from t2v_metrics_tpu.remote.gemini import GEMINI_MODELS
    from t2v_metrics_tpu.remote.gpt4v import GPT4V_MODELS

    assert tt2v.list_all_vqascore_models() == jt2v.list_all_vqascore_models()
    assert {*GPT4V_MODELS, *GEMINI_MODELS} <= set(tt2v.list_all_vqascore_models())
    for name in ("paligemma-3b-mix-896", "gemma-4-31b-it", "llava-v1.5-13b",
                 "instructblip-flant5-xxl", "molmo2-8b", "internvl3.5-241b-a28b",
                 "internvl3-test", "qwen3-omni-30b-a3b-captioner", "qwen3-omni-test"):
        assert name in tt2v.list_all_models()
