"""Port parity: the Qwen2.5-VL image slice end to end — the port's vision
tower (tiled and untiled window layouts), decoder prefill and
``VQAScore("qwen2.5-vl-test")`` against the JAX package on the same
parameters (carried over by ``bridge.py``), the same tokenizer instance (its
vocabulary is built on the fly) and the same seeded uint8 images.

Images are on the smart-resize grid (64x96 and 96x112 at the test config's
factor 8), where the JAX package's host PIL resize and the port's device
resize are both the identity, so the two see the same pixels. Tolerances:
1e-4 on mean answer log-probs and relative 1e-4 on tower features (fp32;
the two CPU BLAS libraries sum in different orders).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl as jq  # noqa: E402
from t2v_metrics_tpu.models.qwen2vl_adapter import \
    _padded_geometry as j_padded_geometry  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.bridge import qwen2vl_from_numpy  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl_adapter as tqa  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 1e-4
NAME = "qwen2.5-vl-test"
JCFG = jq.QWEN2_VL_MODELS[NAME]["config"]
TCFG = tq.QWEN2_VL_MODELS[NAME]["config"]
# a window of 3x3 merged patches: its bin-packed tiles overflow the patch
# bucket at 96x112, so that size takes the untiled (segment-masked) path
WIN24 = {"j": dataclasses.replace(JCFG, vision=dataclasses.replace(JCFG.vision, window_size=24)),
         "t": dataclasses.replace(TCFG, vision=dataclasses.replace(TCFG.vision, window_size=24))}
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


@pytest.fixture(scope="module")
def params():
    jp = jq.init_qwen2vl(jax.random.PRNGKey(0), JCFG)
    # widen the score spread past the near-uniform random-init logits
    leaves, treedef = jax.tree.flatten(jp)
    leaves = [np.asarray(x) * np.float32(3.0) if np.ndim(x) == 2 else np.asarray(x)
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def scorers(params):
    tok = SimpleT5Tokenizer(JCFG.text.vocab_size)
    j = jt2v.VQAScore(NAME, params=params, tokenizer=tok)
    t = tt2v.VQAScore(NAME, params=params, tokenizer=tok, device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (64, 96, 3), dtype=np.uint8) for _ in range(3)]
    return j, t, images


def _tower_inputs(cfg, grid, seed):
    """Patch rows, geometry and the tiled flag of one image of ``grid`` in
    the layout the adapter gives the tower."""
    s = grid[1] * grid[2]
    sb = tqa._bucket(s, tqa.PATCH_BUCKETS)
    geom, pos_hw, win_seg, full_seg, reverse, tiled = j_padded_geometry(
        cfg.vision, grid, s, sb)
    patches = np.random.default_rng(seed).standard_normal(
        (s, cfg.vision.patch_dim)).astype(np.float32)
    rows = patches[geom["perm_tile"]] if tiled else np.concatenate(
        [patches[geom["perm"]], np.zeros((sb - s, patches.shape[1]), np.float32)])
    arrays = [np.stack([a, a]) for a in (rows, pos_hw, win_seg, full_seg, reverse)]
    return arrays, tiled, s // cfg.vision.merge_unit


@pytest.mark.parametrize("window,grid,want_tiled", [(16, (1, 16, 24), True),
                                                   (24, (1, 24, 28), False)])
def test_vision_tower_batch_matches_jax(params, window, grid, want_tiled):
    jcfg = JCFG if window == 16 else WIN24["j"]
    tcfg = TCFG if window == 16 else WIN24["t"]
    arrays, tiled, t = _tower_inputs(jcfg, grid, 1)
    assert tiled == want_tiled
    want = np.asarray(jq.vision_tower_batch(params["vision"], jcfg.vision,
                                            *arrays, tiled=tiled))
    model = qwen2vl_from_numpy(params, tcfg, "cpu", torch.float32)
    with torch.inference_mode():
        got = tq.vision_tower_batch(model.vision, tcfg.vision,
                                    *map(torch.from_numpy, arrays), tiled=tiled)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[:, :t], want[:, :t],
                               atol=TOL * np.abs(want).max(), rtol=TOL)


def test_decoder_forward_logit_positions_matches_jax(params):
    rng = np.random.default_rng(2)
    b, s, d = 3, 20, JCFG.text.d_model
    embeds = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.cumsum(rng.integers(0, 2, (3, b, s)), axis=-1)
    mask = np.arange(s)[None] < np.array([[20], [14], [9]])
    rows = np.array([[19, 5], [13, 2], [8, 8]])
    want, _ = jdec.forward(params["decoder"], JCFG.text, embeds, pos, mask,
                           logit_positions=rows)
    model = qwen2vl_from_numpy(params, TCFG, "cpu", torch.float32)
    with torch.inference_mode():
        got = tdec.forward(model.decoder, TCFG.text,
                           *map(torch.from_numpy, (embeds, pos, mask, rows)))
    assert got.shape == (b, 2, JCFG.text.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL * np.abs(want).max(), rtol=TOL)


def test_score_matrix_matches_jax(scorers):
    j, t, images = scorers
    want = j(images=images, texts=TEXTS)
    got = t(images=images, texts=TEXTS)
    assert got.shape == (3, 4) and got.dtype == np.float32
    assert np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    # the scores do tell pairs apart, so agreement is not trivial
    assert np.ptp(np.log(want)) > 100 * TOL


def test_untiled_slice_matches_jax(params):
    """96x112 under the 3x3-window config: the windowed layers attend over
    the whole patch bucket under window segment ids, in both packages."""
    tok = SimpleT5Tokenizer(JCFG.text.vocab_size)
    j = jt2v.VQAScore(NAME, params=params, tokenizer=tok, config=WIN24["j"])
    t = tt2v.VQAScore(NAME, params=params, tokenizer=tok, config=WIN24["t"],
                      device="cpu")
    images = [np.random.default_rng(3).integers(0, 256, (96, 112, 3), dtype=np.uint8)]
    want = j(images=images, texts=TEXTS[:2])
    got = t(images=images, texts=TEXTS[:2])
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    assert not list(t.model._geometry.values())[0][-1]   # took the untiled path


def test_pairwise_forward_and_batch_forward(scorers):
    j, t, images = scorers
    imgs = [images[0], images[2], images[0]]
    want = j.model.forward(imgs, TEXTS[:3])
    got = t.model.forward(imgs, TEXTS[:3])
    np.testing.assert_allclose(np.log(got), np.log(want), atol=TOL, rtol=0)
    data = [{"images": [images[i % 3]], "texts": TEXTS} for i in range(5)]
    out = t.batch_forward(data, batch_size=2)
    assert out.shape == (5, 1, 4)
    for i in range(5):
        np.testing.assert_allclose(out[i, 0], t(images=[images[i % 3]], texts=TEXTS)[0],
                                   atol=1e-6, rtol=1e-5)


def test_cpu_run_launches_no_kernel(scorers):
    _, t, images = scorers
    before = launch_counts()
    t(images=images[:1], texts=TEXTS[:1])
    assert launch_counts() == before


def test_resized_image_scores_near_jax(scorers):
    """A real resize (100x90 -> 96x88): the JAX package resizes with PIL on
    the host, the port on the device, within one uint8 level of each
    other."""
    j, t, _ = scorers
    img = np.random.default_rng(4).integers(0, 256, (100, 90, 3), dtype=np.uint8)
    want = j(images=[img], texts=TEXTS[:2])
    got = t(images=[img], texts=TEXTS[:2])
    np.testing.assert_allclose(np.log(got), np.log(want), atol=2e-2, rtol=0)


def test_registry_and_unported_paths_raise():
    assert {"qwen2.5-vl-7b", NAME} <= set(tt2v.list_all_vqascore_models())
    with pytest.raises(NotImplementedError):
        tt2v.VQAScore("qwen2.5-vl-7b", device="cpu")          # pretrained weights
    with pytest.raises(NotImplementedError):
        tt2v.VQAScore(NAME, device="cpu", checkpoint="some/dir")
    s = tt2v.VQAScore(NAME, device="cpu")
    with pytest.raises(NotImplementedError):
        s(images=["clip.mp4"], texts=["a"])                    # video
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt2v.VQAScore(NAME, device="cuda")
