"""Port parity: CLIP vision tower (t2v_metrics_tpu_torch/models/clip.py)
against the JAX package on the CPU, with the JAX parameters carried over by
``bridge.py``.

Tolerance 1e-4 in fp32: the two CPU BLAS libraries sum the tower's matmuls
in different orders, and the differences compound over the layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from t2v_metrics_tpu.models import clip as jclip  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import clip as tclip  # noqa: E402

TOL = 1e-4
FIELDS = dict(image_size=56, patch_size=14, width=64, layers=3, heads=4,
              mlp_dim=128, proj_dim=32)


@pytest.fixture(scope="module")
def towers():
    jcfg = jclip.CLIPVisionConfig(**FIELDS)
    tcfg = tclip.CLIPVisionConfig(**FIELDS)
    jp = jclip.init_vision(jax.random.PRNGKey(0), jcfg)
    # random (nonzero) biases and norm parameters, so the bridge's mapping
    # of every leaf is exercised
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.normal(size=np.shape(x)).astype(np.float32) * 0.05
              for x in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    tp = bridge.vision_from_numpy(jp, tcfg, "cpu", torch.float32)
    pixels = np.random.default_rng(2).normal(size=(3, 56, 56 * 3)).astype(np.float32)
    return jcfg, jp, tcfg, tp, pixels


@pytest.mark.parametrize("feature_layer", [None, -2])
def test_vision_tower_matches_jax(towers, feature_layer):
    jcfg, jp, tcfg, tp, pixels = towers
    want = np.asarray(jclip.vision_tower(jp, jcfg, jax.numpy.asarray(pixels),
                                         feature_layer=feature_layer))
    with torch.inference_mode():
        got = tclip.vision_tower(tp, tcfg, torch.from_numpy(pixels),
                                 feature_layer=feature_layer).numpy()
    assert got.shape == want.shape
    if feature_layer == -2:
        assert got.shape == (3, tcfg.num_patches, tcfg.width)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_init_vision_distributions():
    """init_vision draws with the JAX package's scales."""
    cfg = tclip.CLIPVisionConfig(**FIELDS)
    p = tclip.init_vision(tclip.VisionTower(cfg, "cpu", torch.float32),
                          torch.Generator().manual_seed(0))
    blk = p.blocks[0]
    assert torch.equal(blk.ln1.scale, torch.ones(64))
    assert torch.equal(blk.qkv.b, torch.zeros(192))
    for t, std in ((blk.fc1.w, 64 ** -0.5), (blk.fc2.w, 128 ** -0.5),
                   (p.patch_w, 588 ** -0.5), (p.pos_emb, 0.02)):
        assert abs(t.std().item() / std - 1) < 0.15
