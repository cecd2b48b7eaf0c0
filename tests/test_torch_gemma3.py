"""Port parity: the Gemma 3 image slice — the SigLIP tower (flat route and the
per-head route past 2048 patches), ``image_features``, the decoder with
sandwich norms, sliding windows and the image-block overlay, and
``VQAScore("gemma-3-test")`` — against the JAX package on the same
parameters (carried over by ``bridge.py``), the same tokenizer instance and
the same seeded uint8 images; the T5 in-kernel bias path against the dense
one; and the device repair (no GPU and no ``device`` raises).

Images are 28 x 28, the test tower's size, where the JAX package's Pillow
resize and the port's device resize are both the identity. At the test
config the window of 8 bites inside the 64-token bucket. Tolerances: 1e-4
nats on mean answer log-probs; relative 1e-4 on features and logits (fp32;
the two CPU BLAS libraries sum in different orders).
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
from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import gemma3 as jg3  # noqa: E402
from t2v_metrics_tpu.models import siglip as jsig  # noqa: E402
from t2v_metrics_tpu.models import t5 as jt5  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import gemma3 as tg3  # noqa: E402
from t2v_metrics_tpu_torch.models import siglip as tsig  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-4
NAME = "gemma-3-test"
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]
_PARAMS = {}


def _params(key=0):
    """Numpy parameters of gemma-3-test in the JAX layout, made once; the
    Gemma norm scales (zero at init) drawn away from zero so that the
    bridge's norm mapping and the (1 + w) offset are exercised."""
    if key not in _PARAMS:
        jp = jg3.init_gemma3(jax.random.PRNGKey(key), jg3.GEMMA3_MODELS[NAME]["config"])
        rng = np.random.default_rng(key)
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                  else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                  for x in leaves]
        _PARAMS[key] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[key]


def _images(seed, n=2, hw=(28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("image_size,heads", [(28, 4), (644, 2)])
def test_siglip_tower_matches_jax(image_size, heads):
    """28 px: 4 patches, the flat route; 644 px: 2116 patches, past
    FLAT_MAX_KEYS, the per-head attention() on views of the projection."""
    jcfg = jsig.SiglipVisionConfig(image_size=image_size, patch_size=14, width=32,
                                   layers=2, heads=heads, mlp_dim=64)
    tcfg = tsig.SiglipVisionConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, jsig.init_siglip(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    px = rng.uniform(-1, 1, (2, image_size, image_size, 3)).astype(np.float32)
    want = jsig.vision_tower(jp, jcfg, jnp.asarray(px))
    tower = bridge._load_siglip(tsig.SiglipVisionTower(tcfg, "cpu", torch.float32), jp)
    with torch.inference_mode():
        got = tsig.vision_tower(tower, tcfg, torch.from_numpy(px.reshape(2, image_size, -1)))
    assert got.shape == (2, tcfg.num_patches, 32)
    assert (tcfg.num_patches > tsig.FLAT_MAX_KEYS) == (image_size == 644)
    _close(got.numpy(), want)


def test_image_features_and_group_ids_match_jax():
    params = _params()
    jcfg = jg3.GEMMA3_MODELS[NAME]["config"]
    # a 4x4-pooled variant: 56 px, 16 patches pooled to 4 soft tokens
    jcfg = dataclasses.replace(jcfg, mm_tokens_per_image=4, vision=dataclasses.replace(
        jcfg.vision, image_size=56))
    tcfg = dataclasses.replace(tg3.GEMMA3_MODELS[NAME]["config"], mm_tokens_per_image=4,
                               vision=tsig.SiglipVisionConfig(**dataclasses.asdict(jcfg.vision)))
    jp = dict(params, vision=jax.tree.map(np.asarray, jsig.init_siglip(
        jax.random.PRNGKey(3), jcfg.vision)))
    px = np.random.default_rng(4).uniform(-1, 1, (3, 56, 56, 3)).astype(np.float32)
    want = jg3.image_features(jp, jcfg, jnp.asarray(px))
    model = bridge.gemma3_from_numpy(jp, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tg3.image_features(model, tcfg, torch.from_numpy(px.reshape(3, 56, -1)))
    assert got.shape == (3, 4, tcfg.text.d_model)
    _close(got.numpy(), want)
    vm = np.zeros((2, 12), bool)
    vm[0, 2:5] = vm[0, 7:9] = vm[1, 0:3] = vm[1, 11] = True
    np.testing.assert_array_equal(tg3.image_group_ids(torch.from_numpy(vm)).numpy(),
                                  np.asarray(jg3.image_group_ids(jnp.asarray(vm))))


@pytest.mark.parametrize("bidir", [False, True])
def test_decoder_sandwich_norms_windows_match_jax(bidir):
    """Three layers (sliding, full, sliding), window 8 over 24 tokens, the
    local and the scaled global RoPE tables, qk-norm with the (1 + w)
    offset, q_scale; with and without an image block."""
    params = _params()
    jcfg = jg3.GEMMA3_MODELS[NAME]["config"].text
    tcfg = tg3.GEMMA3_MODELS[NAME]["config"].text
    rng = np.random.default_rng(5)
    b, s = 2, 24
    embeds = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    mask = np.arange(s)[None] < np.array([[24], [19]])
    ids = np.full((b, s), -1, np.int32)
    if bidir:
        ids[:, 3:15] = 0
    rows = np.array([[23, 10], [18, 4]])
    want, _ = jdec.forward(params["decoder"], jcfg, embeds, pos, mask,
                           bidir_ids=jnp.asarray(ids) if bidir else None,
                           logit_positions=rows)
    model = bridge.gemma3_from_numpy(params, tg3.GEMMA3_MODELS[NAME]["config"], "cpu",
                                     torch.float32)
    with torch.inference_mode():
        got = tdec.forward(model.decoder, tcfg, *map(torch.from_numpy, (embeds, pos, mask)),
                           logit_positions=torch.from_numpy(rows),
                           bidir_ids=torch.from_numpy(ids) if bidir else None)
    assert got.shape == (b, 2, jcfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_score_matrix_matches_jax():
    params = _params()
    tok = SimpleT5Tokenizer(512)
    j = jt2v.VQAScore(NAME, params=params, tokenizer=tok)
    t = tt2v.VQAScore(NAME, params=params, tokenizer=tok, device="cpu")
    images = _images(0, 3)
    want = j(images=images, texts=TEXTS)
    before = launch_counts()
    got = t(images=images, texts=TEXTS)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, 3) and got.dtype == np.float32
    assert np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * TOL          # the pairs differ
    # the bucket (64) is longer than the window (8): the window bites
    ids = t.model._assemble(TEXTS[2])
    assert 8 < len(ids) <= 64


def test_pairwise_forward_and_batch_forward():
    params = _params()
    tok = SimpleT5Tokenizer(512)
    j = jt2v.VQAScore(NAME, params=params, tokenizer=tok)
    t = tt2v.VQAScore(NAME, params=params, tokenizer=tok, device="cpu")
    images = _images(1, 3)
    imgs = [images[0], images[2], images[0]]
    want = j.model.forward(imgs, TEXTS)
    got = t.model.forward(imgs, TEXTS)
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(4)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (4, 1, 3)
    for i in range(4):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 3]], texts=TEXTS)[0],
                                   atol=1e-6, rtol=1e-5)


def test_registry_matches_jax_and_unported_paths_raise(tmp_path, monkeypatch):
    from t2v_metrics_tpu_torch.models.checkpoint import CheckpointError

    assert set(jg3.GEMMA3_MODELS) <= set(tt2v.list_all_vqascore_models())
    assert list(tg3.GEMMA3_MODELS) == list(jg3.GEMMA3_MODELS)
    for name, spec in jg3.GEMMA3_MODELS.items():
        got = tg3.GEMMA3_MODELS[name]
        assert got["hf"] == spec["hf"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(spec["config"]), name
    for var in ("HF_HUB_CACHE", "HF_HOME", "HOME", "T2V_TPU_CACHE"):
        monkeypatch.setenv(var, str(tmp_path / var))         # empty local caches
    with pytest.raises(CheckpointError, match="never downloads"):
        tt2v.VQAScore("gemma-3-4b-it", device="cpu")          # pretrained weights
    s = tt2v.VQAScore(NAME, device="cpu")
    with pytest.raises(OSError, match="cannot open video"):
        s(images=["clip.mp4"], texts=["a"])  # a video the reader cannot open
    # generation is ported: the batched and the per-sequence path give the
    # JAX package's strings on the same parameters
    tok = SimpleT5Tokenizer(512)
    j = jt2v.VQAScore(NAME, params=_params(), tokenizer=tok)
    t = tt2v.VQAScore(NAME, params=_params(), tokenizer=tok, device="cpu")
    for images, texts in ((_images(2, 2), ["a", "two dogs"]), (_images(2, 1), ["a"])):
        want = j.model.generate(images, texts, max_new_tokens=4)
        assert t.model.generate(images, texts, max_new_tokens=4) == want


def test_random_init_gemma_norms():
    cfg = tg3.GEMMA3_MODELS[NAME]["config"]
    m = tg3.init_gemma3(cfg, 0, "cpu")
    blk = m.decoder.blocks[0]
    for norm in (blk.ln1, blk.ln1_post, blk.ln_ff_pre, blk.ln_ff_post, blk.q_norm,
                 m.decoder.ln_final, m.projector.norm):
        assert torch.equal(norm.scale, torch.zeros_like(norm.scale))
    assert torch.equal(m.vision.blocks[0].ln1.scale, torch.ones(32))
    assert abs(m.projector.proj.std().item() * 32 ** 0.5 - 1) < 0.2


def test_entry_points_need_a_gpu_or_cpu_asked_for():
    """``device`` left out means the GPU: without one it raises; the CPU
    runs only when asked for."""
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt2v.VQAScore("clip-flant5-test")
        with pytest.raises(RuntimeError):
            tt2v.VQAScore(NAME, device="cuda")
        assert tt2v.VQAScore(NAME, device="cpu").model.device.type == "cpu"


@pytest.mark.parametrize("variant", [{}, dict(gated=False, act="relu",
                                              tie_word_embeddings=True)])
def test_t5_inkernel_rel_bias_matches_dense(variant, monkeypatch):
    """T5 under INKERNEL_REL_BIAS (per-head attention() on views of the
    packed projection, the (H, num_buckets) table) against the dense-bias
    path and the JAX package, encoder (bidirectional buckets, key mask) and
    decoder (causal buckets)."""
    fields = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_heads=4,
                  enc_layers=2, dec_layers=2, **variant)
    jcfg, tcfg = jt5.T5Config(**fields), tt5.T5Config(**fields)
    jp = jax.tree.map(lambda x: np.asarray(x) * np.float32(2.0),
                      jt5.init_t5(jax.random.PRNGKey(0), jcfg))
    tp = bridge.t5_from_numpy(jp, tcfg, "cpu", torch.float32)
    rng = np.random.default_rng(6)
    embeds = rng.normal(size=(3, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([[40], [33], [12]])
    ans = rng.integers(3, 300, (3, 4))
    ans_mask = np.ones((3, 4), np.float32)
    arrays = (embeds, mask, ans, ans_mask)
    want = jt5.answer_log_probs(jp, jcfg, *map(jnp.asarray, arrays))
    with torch.inference_mode():
        dense = tt5.answer_log_probs(tp, tcfg, *map(torch.from_numpy, arrays))
        monkeypatch.setattr(tt5, "INKERNEL_REL_BIAS", True)
        inkernel = tt5.answer_log_probs(tp, tcfg, *map(torch.from_numpy, arrays))
        assert tt5._position_bias(tp.encoder, tcfg, 40, 40, True)[0] is None
    np.testing.assert_allclose(inkernel.numpy(), dense.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(inkernel.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.ptp(np.asarray(want)) > 100 * TOL
