"""Port parity: the Qwen3-VL image slice end to end — the port's vision
tower with its deepstack levels, the decoder prefill with qk-norm, deepstack
residuals and routed experts, and ``VQAScore("qwen3-vl-test")`` /
``("qwen3-vl-moe-test")`` against the JAX package on the same parameters
(carried over by ``bridge.py``), the same tokenizer instance (its vocabulary
is built on the fly) and the same seeded uint8 images.

Images are on the smart-resize grid of the test config (factor 8: 64x96 and
56x64, both above the 3136-pixel minimum), where the JAX package's host PIL resize and the port's device resize
are both the identity. Tolerances: 1e-4 nats on mean answer log-probs,
relative 1e-4 on tower features and logits (fp32; the two CPU BLAS
libraries sum in different orders).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.bridge import qwen3vl_from_numpy  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl_adapter as tq3a  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-4
NAMES = ("qwen3-vl-test", "qwen3-vl-moe-test")
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa"]


def _jax_normalised(cfg):
    """The port's config with the JAX package's pixel normalisation, CLIP's
    mean and std (the port gives Qwen3-VL its published processor's 0.5)."""
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_mean=CLIP_MEAN, image_std=CLIP_STD))


def _configs(name, dispatch=False):
    j, t = jq3.resolve_config(name), _jax_normalised(tq3.resolve_config(name))
    if dispatch:
        j = dataclasses.replace(j, text=dataclasses.replace(j.text, moe_dispatch=True))
        t = dataclasses.replace(t, text=dataclasses.replace(t.text, moe_dispatch=True))
    return j, t


# the two test configs, and the MoE one with the sorted dispatch
VARIANTS = [(NAMES[0], False), (NAMES[1], False), (NAMES[1], True)]
_PARAMS = {}


def _params(name):
    """Numpy parameters of ``name`` in the JAX layout, made once."""
    if name not in _PARAMS:
        jp = jq3.init_qwen3vl(jax.random.PRNGKey(0), jq3.resolve_config(name))
        # widen the score spread past the near-uniform random-init logits
        leaves, treedef = jax.tree.flatten(jp)
        leaves = [np.asarray(x) * np.float32(3.0) if np.ndim(x) >= 2
                  else np.asarray(x) for x in leaves]
        _PARAMS[name] = jax.tree.unflatten(treedef, leaves)
    return _PARAMS[name]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    name = request.param
    return (name, *_configs(name), _params(name))


def _images(seed, n=2, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def test_vision_tower_and_deepstack_match_jax(case):
    _, jcfg, tcfg, params = case
    v = jcfg.vision
    grid = (1, 16, 24)
    s = grid[1] * grid[2]
    sb = tq3a._bucket(s, tq3a.PATCH_BUCKETS)
    pos_hw = np.concatenate([jq3.vision_geometry(grid, v), np.zeros((sb - s, 2), np.int32)])
    seg = np.concatenate([np.zeros(s, np.int32), np.full(sb - s, -1, np.int32)])
    pe = jq3.pos_embed_interp(grid, v)
    for got, want in zip(tq3.pos_embed_interp(grid, tcfg.vision), pe):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq3.vision_geometry(grid, tcfg.vision),
                                  pos_hw[:s])
    rng = np.random.default_rng(1)
    patches = [np.concatenate([rng.standard_normal((s, v.patch_dim)).astype(np.float32),
                               np.zeros((sb - s, v.patch_dim), np.float32)])
               for _ in range(2)]
    model = qwen3vl_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        main, ds = tq3.vision_tower(
            model.vision, tcfg.vision, torch.from_numpy(np.stack(patches)),
            torch.from_numpy(np.stack([pos_hw, pos_hw])),
            *map(torch.from_numpy, pe), torch.from_numpy(np.stack([seg, seg])))
    assert len(ds) == len(v.deepstack_indexes) == 2
    n = s // v.merge_unit
    for b in range(2):
        want_main, want_ds = jq3.vision_tower(params["vision"], v, patches[b], pos_hw,
                                              *pe, seg, grid_t=1)
        for g, w in zip([main[b], *(d[b] for d in ds)], [want_main, *want_ds]):
            w = np.asarray(w)[:n]
            np.testing.assert_allclose(g.numpy()[:n], w, rtol=TOL,
                                       atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("name,dispatch", VARIANTS)
def test_decoder_forward_qk_norm_deepstack_matches_jax(name, dispatch):
    jcfg, tcfg = _configs(name, dispatch)
    params = _params(name)
    rng = np.random.default_rng(2)
    b, s, d = 3, 20, jcfg.text.d_model
    embeds = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.cumsum(rng.integers(0, 2, (3, b, s)), axis=-1)
    mask = np.arange(s)[None] < np.array([[20], [14], [9]])
    ds = [rng.standard_normal((b, s, d)).astype(np.float32) * (np.arange(s) < 6)[:, None]
          for _ in range(2)]
    rows = np.array([[19, 5], [13, 2], [8, 8]])
    want, _ = jdec.forward(params["decoder"], jcfg.text, embeds, pos, mask,
                           deepstack=ds, logit_positions=rows)
    model = qwen3vl_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tdec.forward(model.decoder, tcfg.text,
                           *map(torch.from_numpy, (embeds, pos, mask)),
                           logit_positions=torch.from_numpy(rows),
                           deepstack=[torch.from_numpy(x) for x in ds])
        plain = tdec.forward(model.decoder, tcfg.text,
                             *map(torch.from_numpy, (embeds, pos, mask)),
                             logit_positions=torch.from_numpy(rows))
    assert got.shape == (b, 2, jcfg.text.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL * np.abs(want).max(), rtol=TOL)
    assert not torch.allclose(got, plain)        # the residuals take effect


@pytest.mark.parametrize("name,dispatch", VARIANTS)
def test_score_matrix_matches_jax(name, dispatch):
    jcfg, tcfg = _configs(name, dispatch)
    params = _params(name)
    tok = SimpleT5Tokenizer(jcfg.text.vocab_size)
    j = jt2v.VQAScore(name, params=params, tokenizer=tok, config=jcfg)
    t = tt2v.VQAScore(name, params=params, tokenizer=tok, config=tcfg, device="cpu")
    images = _images(0) + _images(5, 1, (56, 64))
    want = j(images=images, texts=TEXTS)
    before = launch_counts()
    got = t(images=images, texts=TEXTS)
    assert launch_counts() == before                 # the CPU runs no kernel
    assert got.shape == (3, 3) and got.dtype == np.float32
    assert np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    # the scores do tell pairs apart, so agreement is not trivial
    assert np.ptp(np.log(want)) > 100 * TOL


def test_pairwise_forward_and_batch_forward(case):
    name, jcfg, tcfg, params = case
    tok = SimpleT5Tokenizer(jcfg.text.vocab_size)
    j = jt2v.VQAScore(name, params=params, tokenizer=tok)
    t = tt2v.VQAScore(name, params=params, tokenizer=tok, config=tcfg, device="cpu")
    images = _images(3, 3)
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


def test_qwen35_assistant_suffix_matches_jax():
    """qwen3.5 prompts end with the closed empty thinking block; the ids and
    the scores equal the JAX adapter's (the test config's parameters under
    the qwen3.5-4b name)."""
    jcfg, tcfg = _configs("qwen3-vl-test")
    params = jax.tree.map(np.asarray, jq3.init_qwen3vl(jax.random.PRNGKey(1), jcfg))
    tok = SimpleT5Tokenizer(jcfg.text.vocab_size)
    j = jt2v.VQAScore("qwen3.5-4b", params=params, tokenizer=tok, config=jcfg)
    t = tt2v.VQAScore("qwen3.5-4b", params=params, tokenizer=tok, config=tcfg,
                      device="cpu")
    plain = tt2v.VQAScore("qwen3-vl-test", params=params, tokenizer=tok,
                          device="cpu")
    suffix = tok.encode(tq3a.THINKING_OFF_SUFFIX, add_special_tokens=False)
    ids = t.model._build_ids("is it a cat?", 6)
    assert ids == j.model._build_ids("is it a cat?", 6, False)
    assert ids == plain.model._build_ids("is it a cat?", 6) + suffix
    images = _images(6, 1)
    np.testing.assert_allclose(np.log(t(images=images, texts=TEXTS[:2])),
                               np.log(j(images=images, texts=TEXTS[:2])),
                               atol=TOL, rtol=0)


def test_registry_matches_jax_and_unported_paths_raise(tmp_path, monkeypatch):
    from t2v_metrics_tpu_torch.models.checkpoint import CheckpointError

    names = set(tt2v.list_all_vqascore_models())
    assert set(jq3.QWEN3_VL_MODELS) <= names
    assert list(tq3.QWEN3_VL_MODELS) == list(jq3.QWEN3_VL_MODELS)
    for name in jq3.QWEN3_VL_MODELS:
        got, want = tq3.resolve_config(name), jq3.resolve_config(name)
        # every size the JAX package's; the normalisation the published 0.5
        assert (got.vision.image_mean, got.vision.image_std) == ((0.5,) * 3, (0.5,) * 3)
        assert dataclasses.asdict(_jax_normalised(got)) == dict(
            dataclasses.asdict(want), vision=dict(dataclasses.asdict(want.vision),
                                                  image_mean=CLIP_MEAN, image_std=CLIP_STD)), name
        assert tq3.QWEN3_VL_MODELS[name] == jq3.QWEN3_VL_MODELS[name], name
    for var in ("HF_HUB_CACHE", "HF_HOME", "HOME", "T2V_TPU_CACHE"):
        monkeypatch.setenv(var, str(tmp_path / var))         # empty local caches
    with pytest.raises(CheckpointError, match="never downloads"):
        tt2v.VQAScore("qwen3-vl-30b-a3b", device="cpu")      # pretrained weights
    s = tt2v.VQAScore("qwen3-vl-test", device="cpu")
    with pytest.raises(OSError, match="cannot open video"):
        s(images=["clip.mp4"], texts=["a"])  # a video the reader cannot open


def test_port_scores_qwen3_without_jax():
    """The Qwen3-VL path of the port leaves jax out of sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "import t2v_metrics_tpu_torch as t\n"
        "img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8)\n"
        "for name in ('qwen3-vl-test', 'qwen3-vl-moe-test'):\n"
        "    s = t.VQAScore(name, device='cpu')\n"
        "    out = s(images=[img], texts=['a red cube', 'a dog'])\n"
        "    assert out.shape == (1, 2) and np.isfinite(out).all(), out\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
