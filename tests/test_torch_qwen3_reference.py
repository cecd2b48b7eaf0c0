"""The port's Qwen3-VL against the benchmark's plain float32 reference
(``h100bench/reference/qwen3_vl.py``), on the CPU at ``qwen3-vl-moe-test``'s
widths: the port's model seeded in place by the benchmark's weight rule
(``h100bench/weights.fill_`` with the reference's ``leaf_rule``), scored
through ``VQAScore`` in float32, against the reference's log scores on three
images of different sizes x three prompts. Also the pixel normalisation
itself: Qwen3-VL's published 0.5 / 0.5 (transformers' processor given those
constants), Qwen2.5-VL's and Qwen3-Omni's CLIP mean and std.

Tolerance: 1e-4 nats on log scores. Both sides compute in float32 with the
same weights, tokens and Pillow-exact resize; they differ only in the order
of their sums (the port pads prompts and patch rows to buckets and batches
pairs; the reference runs each image alone and loops over experts), which
moves a log score by ~1e-6. Normalising with CLIP's mean and std instead of
0.5 moves the tower's input by up to ~2 units and the scores by far more
than the tolerance, which the second case shows.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from h100bench.reference import qwen3_vl as ref  # noqa: E402
from h100bench.tokenizer import WordTokenizer  # noqa: E402
from h100bench.weights import fill_  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq2  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl_adapter as tqa  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni as tqo  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402

TOL = 1e-4
SEED = 2**31 + 909
NAME = "qwen3-vl-moe-test"
# qwen3-vl-moe-test's widths as the reference reads them, with the
# published Qwen3-VL processor's normalisation
CFG = {
    "model": NAME, "family": "qwen3_vl", "dtype": "float32",
    "vision": {"hidden": 32, "depth": 3, "heads": 4, "patch_size": 4, "temporal_patch_size": 2,
               "merge_size": 2, "d_ff": 64, "out_hidden": 48, "num_position_embeddings": 16,
               "deepstack_indexes": [0, 1], "act": "gelu_pytorch_tanh", "ln_eps": 1e-06},
    "text": {"vocab_size": 512, "d_model": 48, "layers": 3, "heads": 4, "kv_heads": 2,
             "head_dim": 16, "rms_eps": 1e-06, "rope_theta": 5000000.0,
             "mrope_section": [4, 2, 2], "mrope_interleaved": True, "qkv_bias": False,
             "qk_norm": True, "num_experts": 4, "experts_per_tok": 2, "moe_d_ff": 32,
             "moe_norm_topk": True, "act": "silu", "tie_embeddings": False},
    "image_token_id": 501, "video_token_id": 502, "vision_start_token_id": 503,
    "vision_end_token_id": 504, "tokenizer_vocab": 500,
    "image_resize": {"min_pixels": tqa.IMAGE_MIN_PIXELS, "max_pixels": tqa.IMAGE_MAX_PIXELS},
    "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}
TEXTS = ["a red cube on a wooden table", "two dogs",
         "an old man riding a bicycle through the snow at night"]


def _images():
    """Three seeded colour fields of different sizes: each resizes to its own
    patch grid, and none is an identity resize."""
    rng = np.random.default_rng(5)
    out = []
    for h, w in ((90, 76), (64, 100), (130, 118)):
        field = rng.integers(0, 256, (4, 4, 3)).astype(np.float64)
        ys, xs = np.linspace(0, 3, h), np.linspace(0, 3, w)
        img = field[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
        out.append(np.clip(img + rng.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def reference_logp():
    images = _images()
    pairs = [(m, p) for m in range(len(images)) for p in range(len(TEXTS))]
    return ref.log_scores(CFG, SEED, images, TEXTS, pairs, "cpu").reshape(3, 3)


def _port_logp(dispatch=False, mean=None, std=None):
    cfg = tq3.resolve_config(NAME)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, moe_dispatch=dispatch))
    if mean is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, image_mean=mean, image_std=std))
    model = tq3.Qwen3VLModel(cfg, torch.device("cpu"), torch.float32)
    fill_(model, SEED, ref.leaf_rule(CFG))
    scorer = tt2v.VQAScore(NAME, device="cpu", params=model, config=cfg,
                           tokenizer=WordTokenizer(CFG["tokenizer_vocab"]))
    return np.log(scorer(images=_images(), texts=TEXTS).astype(np.float64))


@pytest.mark.parametrize("dispatch", [False, True], ids=["dense-oracle", "dispatch"])
def test_moe_scores_match_the_plain_reference(reference_logp, dispatch):
    """The registry's Qwen3-VL MoE config (0.5 / 0.5) through ``VQAScore``,
    with the dense expert oracle and with the sorted dispatch and grouped
    GEMM the card runs."""
    got = _port_logp(dispatch)
    np.testing.assert_allclose(got, reference_logp, atol=TOL, rtol=0)
    assert np.ptp(reference_logp) > 100 * TOL      # the scores tell pairs apart


def test_clip_constants_fail_the_reference(reference_logp):
    """CLIP's mean and std, which the port gave every Qwen-VL before, are
    far outside the tolerance: this comparison catches that fault."""
    got = _port_logp(True, CLIP_MEAN, CLIP_STD)
    assert np.abs(got - reference_logp).max() > 10 * TOL


def test_the_normalisation_of_each_family():
    """Every Qwen3-VL entry takes 0.5 / 0.5; Qwen2.5-VL and Qwen3-Omni keep
    CLIP's mean and std (Qwen2.5-VL's published processor; Qwen3-Omni's
    unchanged until its published value is checked)."""
    half = (0.5, 0.5, 0.5)
    for name in tq3.QWEN3_VL_MODELS:
        v = tq3.resolve_config(name).vision
        assert (v.image_mean, v.image_std) == (half, half), name
    for name, spec in tq2.QWEN2_VL_MODELS.items():
        v = spec["config"].vision
        assert (v.image_mean, v.image_std) == (CLIP_MEAN, CLIP_STD), name
    for name in tqo.QWEN3_OMNI_MODELS:
        v = tqo.resolve_config(name).vision
        assert (v.image_mean, v.image_std) == (CLIP_MEAN, CLIP_STD), name


def _levels(rows, cfg):
    """Patch rows back to the [0, 1] pixel levels, by the config's mean and
    std: features are (channel, t, ph, pw)."""
    per = cfg.temporal_patch_size * cfg.patch_size ** 2
    mean = np.repeat(np.asarray(cfg.image_mean, np.float32), per)
    std = np.repeat(np.asarray(cfg.image_std, np.float32), per)
    return rows * std + mean


@pytest.mark.parametrize("family", ["qwen2.5-vl-test", "qwen3-vl-test"])
def test_image_and_video_patches_normalise_by_the_config(family):
    """``image_patches`` and ``video_patches`` (both resizes) give the same
    pixel levels whatever the config's constants, normalised by them: rows
    of the registry's config and of the same config with the other family's
    constants differ, and each maps back to one set of levels."""
    cfg = (tq2.QWEN2_VL_MODELS[family]["config"] if family.startswith("qwen2.5")
           else tq3.resolve_config(family)).vision
    other = ((0.5,) * 3, (0.5,) * 3) if cfg.image_mean == CLIP_MEAN else (CLIP_MEAN, CLIP_STD)
    swapped = dataclasses.replace(cfg, image_mean=other[0], image_std=other[1])
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.integers(0, 256, (2, 50, 70 * 3), dtype=np.uint8))
    clip = torch.from_numpy(rng.integers(0, 256, (1, 2, 50, 70 * 3), dtype=np.uint8))
    for fn, x in ((tq2.image_patches, img),
                  (lambda *a: tq2.video_patches(*a, pillow=True), clip),
                  (tq2.video_patches, clip)):
        a, b = fn(x, cfg, 48, 64).numpy(), fn(x, swapped, 48, 64).numpy()
        assert np.abs(a - b).max() > 0.1
        np.testing.assert_allclose(_levels(a, cfg), _levels(b, swapped), atol=2e-6, rtol=0)
        assert 0.0 <= _levels(a, cfg).min() and _levels(a, cfg).max() <= 1.0 + 1e-6


@pytest.mark.parametrize("hw", [(200, 300), (1024, 1024), (37, 411)])
def test_qwen3_image_patches_equal_the_transformers_processor(hw):
    """Qwen3-VL's patch rows at qwen3-vl-30b-a3b's tower sizes equal
    transformers' ``Qwen2VLImageProcessor`` given the published 0.5 / 0.5,
    patch 16, merge 2 and the port's pixel limits: Pillow's bicubic resize
    (bit for bit on both sides), /255, normalise, the same row order. The
    two round x/255 and the normalisation in float32 in other orders: 1e-6."""
    transformers = pytest.importorskip("transformers")
    from transformers import Qwen2VLImageProcessor

    assert transformers.__version__
    cfg = tq3.resolve_config("qwen3-vl-30b-a3b").vision
    proc = Qwen2VLImageProcessor(image_mean=[0.5] * 3, image_std=[0.5] * 3,
                                 patch_size=cfg.patch_size, merge_size=cfg.merge_size,
                                 temporal_patch_size=cfg.temporal_patch_size,
                                 min_pixels=tqa.IMAGE_MIN_PIXELS,
                                 max_pixels=tqa.IMAGE_MAX_PIXELS)
    h, w = hw
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    out = proc(images=[img], return_tensors="np")
    hb, wb, grid = tqa.Qwen2VLAdapter._visual_grid(
        type("A", (), {"config": tq3.resolve_config("qwen3-vl-30b-a3b")})(), "img", img.shape)
    assert tuple(out["image_grid_thw"][0]) == grid
    rows = tq2.image_patches(torch.from_numpy(img).reshape(1, h, w * 3), cfg, hb, wb)[0]
    np.testing.assert_allclose(rows.numpy(), out["pixel_values"], atol=1e-6, rtol=0)
