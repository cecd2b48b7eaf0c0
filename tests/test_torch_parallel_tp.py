"""Port parity under tensor, data and expert parallelism: four ranks of a
gloo group (``parallel/launch.py``, spawned once for the file, each rank on
one CPU thread) run every case of this file, and each result is held
against the JAX package run here, sharded over the conftest's virtual
8-device mesh as the JAX tests shard it (tests/test_sharding.py), on the
same parameters (carried over by ``bridge.py``), the same tokenizer
vocabulary and the same seeded inputs. Every rank must return the same
result, bit for bit.

Tolerances, fp32 (the two CPU BLAS libraries sum in other orders, and a
row-parallel product sums its ranks' partial products): features and
decoder outputs 2e-4 (the JAX tests' bar); scores 1e-4 nats; the W8A8 mode
the int8 rule of tests/test_torch_slice.py (3/4 of the pairs within 1e-4
nats, all within 5e-3: a rounding flip of one int8 step moves a score).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.parallel import mesh as jmesh  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.models import clip as tclip  # noqa: E402
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402
from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS as T_MODELS  # noqa: E402
from t2v_metrics_tpu_torch.parallel.launch import run_ranks  # noqa: E402

WORLD = 4
FEAT_TOL, SCORE_TOL, INT8_ALL_TOL = 2e-4, 1e-4, 5e-3
TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


def _np_tree(jp, scale=None):
    """Numpy leaves; ``scale`` widens the 2-D ones (the random-init logits
    are near uniform, so the scores would hardly tell pairs apart)."""
    leaves, treedef = jax.tree.flatten(jp)
    leaves = [np.asarray(x) * np.float32(scale) if scale and np.ndim(x) >= 2
              else np.asarray(x) for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


def _images(seed, n, hw):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _jmesh(**kw):
    return jmesh.make_mesh(devices=jax.devices()[:WORLD], **kw)


def _case(name, kind, mesh, **args):
    return {"name": name, "kind": kind, "mesh": mesh, "args": args}


def _features_case():
    cfg = J_MODELS["clip-flant5-test"]["config"]
    jp = jcft5.init_clip_t5(jax.random.PRNGKey(3), cfg)
    px = np.random.default_rng(3).standard_normal((2, 56, 56, 3)).astype(np.float32)
    mesh = _jmesh(dp=1, tp=4)
    with mesh:
        want = jax.jit(lambda p, x: jcft5.image_features(p, cfg, x))(
            jmesh.shard_params(jp, mesh), jnp.asarray(px))
    case = _case("features", "features", ("mesh", {"dp": 1, "tp": 4}),
                 tree=_np_tree(jp), cfg=T_MODELS["clip-flant5-test"]["config"],
                 pixels=px.reshape(2, 56, 168))
    return case, np.asarray(want)


def _vqascore_cases():
    jp = _np_tree(jcft5.init_clip_t5(jax.random.PRNGKey(0),
                                     J_MODELS["clip-flant5-test"]["config"]), 4.0)
    images = _images(0, 3, (30, 38))
    imgs = [images[0], images[2], images[0], images[1], images[2]]
    cases, refs = [], {}
    for quant in (None, "int8"):
        tok = SimpleT5Tokenizer(512)
        j = jt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok, quant=quant,
                          mesh=_jmesh(dp=2, tp=2))
        want = j(images=images, texts=TEXTS)
        want_pairs = j.model.forward(imgs, TEXTS + TEXTS[:1])
        one = tt2v.VQAScore("clip-flant5-test", params=jp, device="cpu", quant=quant,
                            tokenizer=_port_tok(512, tok))
        name = f"vqascore_{quant or 'bf16'}"
        refs[name] = (want, want_pairs, one(images=images, texts=TEXTS))
        cases.append(_case(name, "vqascore", ("mesh", {"dp": 2, "tp": 2}), tree=jp,
                           vocab=dict(tok._vocab), images=images, texts=TEXTS,
                           pair_images=imgs, pair_texts=TEXTS + TEXTS[:1], quant=quant))
    return cases, refs


def _port_tok(vocab_size, jtok):
    from t2v_metrics_tpu_torch.tokenization import SimpleT5Tokenizer as TTok

    tok = TTok(vocab_size)
    tok._vocab = dict(jtok._vocab)
    return tok


def _adapter_cases():
    """qwen3-vl-test and gemma-3-test: tp 2 divides their 2 kv heads."""
    from t2v_metrics_tpu.models import gemma3 as jg3

    cases, refs = [], {}
    for name, jp, images in (
            ("qwen3-vl-test",
             jq3.init_qwen3vl(jax.random.PRNGKey(0), jq3.resolve_config("qwen3-vl-test")),
             _images(0, 2, (64, 96))),
            ("gemma-3-test",
             jg3.init_gemma3(jax.random.PRNGKey(1), jg3.GEMMA3_MODELS["gemma-3-test"]["config"]),
             _images(1, 2, (28, 28)))):
        tree = _np_tree(jp, 3.0)
        vocab_size = 512
        tok = SimpleT5Tokenizer(vocab_size)
        want = jt2v.VQAScore(name, params=tree, tokenizer=tok)(images=images,
                                                               texts=TEXTS[:3])
        refs[name] = want
        # the JAX package's pixel normalisation, CLIP's, where the port gives
        # Qwen3-VL its published processor's 0.5
        config = None
        if name.startswith("qwen3"):
            config = tq3.resolve_config(name)
            config = dataclasses.replace(config, vision=dataclasses.replace(
                config.vision, image_mean=CLIP_MEAN, image_std=CLIP_STD))
        cases.append(_case(name, "adapter_tp", ("mesh", {"dp": 2, "tp": 2}), model=name,
                           tree=tree, vocab=dict(tok._vocab), vocab_size=vocab_size,
                           images=images, texts=TEXTS[:3], config=config))
    return cases, refs


def _moe_cases():
    jcfg = jq3.resolve_config("qwen3-vl-moe-test")
    tcfg = tq3.resolve_config("qwen3-vl-moe-test")
    jp = jq3.init_qwen3vl(jax.random.PRNGKey(7), jcfg)
    ids = np.array([[5, 6, 7, 8], [9, 10, 11, 12]])
    embeds = np.asarray(jp["decoder"]["embed"][jnp.asarray(ids)])
    pos = np.tile(np.arange(4)[None, None], (3, 2, 1))
    mask = np.ones(ids.shape, bool)
    cases, refs = [], {}
    for name, kw in (("moe_ep2_tp2", {"dp": 1, "ep": 2, "tp": 2}),
                     ("moe_tp2", {"dp": 2, "tp": 2})):
        mesh = _jmesh(**kw)
        with mesh:
            out, _ = jax.jit(lambda p, e: jdec.forward(
                p["decoder"], jcfg.text, e, jnp.asarray(pos), jnp.asarray(mask)))(
                jmesh.shard_params(jp, mesh), jnp.asarray(embeds))
        refs[name] = np.asarray(out)
        cases.append(_case(name, "decoder", ("mesh", kw), tree=_np_tree(jp), cfg=tcfg,
                           embeds=embeds, pos=pos, mask=mask))
    return cases, refs


def _multihost_case():
    import __graft_entry__ as ge

    jcfg = ge._small_cfg()
    tcfg = tcft5.CLIPT5Config(t5=tt5.T5Config(**dataclasses.asdict(jcfg.t5)),
                              vision=tclip.CLIPVisionConfig(**dataclasses.asdict(jcfg.vision)),
                              num_image_tokens=jcfg.num_image_tokens)
    jp = jcft5.init_clip_t5(jax.random.PRNGKey(0), jcfg)
    inputs = ge._example_inputs(jcfg, m=4, n=2)

    def step(params, pixels, ids, img_mask, img_slot, enc_mask, ans_ids, ans_mask,
             pair_image, pair_text):
        feats = jcft5.image_features(params, jcfg, pixels)
        return jcft5.score_pairs(params, jcfg, feats, ids, img_mask, img_slot, enc_mask,
                                 ans_ids, ans_mask, pair_image, pair_text)

    mesh3 = jmesh.make_multihost_mesh(dcn=2, dp=1, tp=2, devices=jax.devices()[:WORLD])
    data = NamedSharding(mesh3, P(("dcn", "dp")))
    repl = NamedSharding(mesh3, P())
    placed = ([jax.device_put(inputs[0], data)]
              + [jax.device_put(x, repl) for x in inputs[1:7]]
              + [jax.device_put(x, data) for x in inputs[7:]])
    with mesh3:
        want = jax.jit(step)(jmesh.shard_params(jp, mesh3), *placed)
    host = [np.asarray(x) for x in inputs]
    host[0] = host[0].reshape(*host[0].shape[:2], -1)      # channel-flattened pixels
    case = _case("multihost", "multihost", ("multihost", {"dcn": 2, "dp": 1, "tp": 2}),
                 tree=_np_tree(jp), cfg=tcfg, inputs=host)
    return case, np.asarray(want)


def _clipscore_case():
    from t2v_metrics_tpu.models import clip as jclip
    from t2v_metrics_tpu.models.adapters import _TEST_CLIP_T, _TEST_CLIP_V

    jp = _np_tree(jclip.init_clip(jax.random.PRNGKey(2), _TEST_CLIP_V, _TEST_CLIP_T))
    images = _images(2, 3, (40, 52))
    tok = SimpleT5Tokenizer(256)
    j = jt2v.CLIPScore("clipscore-test", params=jp, tokenizer=tok, mesh=_jmesh(dp=2, tp=2))
    want = j(images=images, texts=TEXTS)
    case = _case("clipscore", "clipscore", ("mesh", {"dp": 2, "tp": 2}), tree=jp,
                 vocab=dict(tok._vocab), images=images, texts=TEXTS)
    return case, np.asarray(want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results by case, the JAX references by case)."""
    feat_case, feat_ref = _features_case()
    vqa_cases, vqa_refs = _vqascore_cases()
    adapter_cases, adapter_refs = _adapter_cases()
    moe_cases, moe_refs = _moe_cases()
    mh_case, mh_ref = _multihost_case()
    cs_case, cs_ref = _clipscore_case()
    cases = [feat_case, *vqa_cases, *adapter_cases, *moe_cases, mh_case, cs_case]
    init = f"file://{tmp_path_factory.mktemp('tp') / 'init'}"
    ranks = run_ranks(__import__("torch_parallel_workers").run_cases, WORLD, (cases,),
                      init_method=init, timeout_s=240)
    refs = {"features": feat_ref, **vqa_refs, **adapter_refs, **moe_refs,
            "multihost": mh_ref, "clipscore": cs_ref}
    return ranks, refs


def _same_on_every_rank(ranks, name, key=None):
    outs = [r[name] if key is None else r[name][key] for r in ranks]
    for r, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out, outs[0], err_msg=f"rank {r} differs from rank 0")
    return outs[0]


def test_image_features_at_tp4_match_jax(runs):
    ranks, refs = runs
    got = _same_on_every_rank(ranks, "features")
    want = refs["features"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=0)


def test_vqascore_at_dp2_tp2_matches_jax_and_one_rank(runs):
    ranks, refs = runs
    want, want_pairs, one = refs["vqascore_bf16"]
    got = _same_on_every_rank(ranks, "vqascore_bf16", "matrix")
    assert got.shape == (3, 4) and np.all(np.isfinite(got))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(np.log(got), np.log(one), atol=SCORE_TOL, rtol=0)
    assert np.ptp(np.log(want)) > 100 * SCORE_TOL       # the pairs differ
    pairs = _same_on_every_rank(ranks, "vqascore_bf16", "pairs")
    np.testing.assert_allclose(np.log(pairs), np.log(want_pairs), atol=SCORE_TOL, rtol=0)


def test_batch_forward_splits_by_image_and_matches_the_matrix(runs):
    ranks, refs = runs
    batch = _same_on_every_rank(ranks, "vqascore_bf16", "batch")
    want = refs["vqascore_bf16"][0]
    assert batch.shape == (5, 1, 4)
    for i in range(5):
        np.testing.assert_allclose(np.log(batch[i, 0]), np.log(want[i % 3]),
                                   atol=SCORE_TOL, rtol=0)


def test_int8_at_dp2_tp2_meets_the_int8_rule(runs):
    ranks, refs = runs
    want, want_pairs, one = refs["vqascore_int8"]
    assert all(r["vqascore_int8"]["quantized"] for r in ranks)
    got = _same_on_every_rank(ranks, "vqascore_int8", "matrix")
    for ref in (want, one):
        gap = np.abs(np.log(got) - np.log(ref)).ravel()
        assert np.mean(gap <= SCORE_TOL) >= 0.75, gap
        assert gap.max() <= INT8_ALL_TOL, gap
    pairs = _same_on_every_rank(ranks, "vqascore_int8", "pairs")
    assert np.abs(np.log(pairs) - np.log(want_pairs)).max() <= INT8_ALL_TOL


@pytest.mark.parametrize("name", ["qwen3-vl-test", "gemma-3-test"])
def test_family_tp2_scores_match_jax(runs, name):
    ranks, refs = runs
    got = _same_on_every_rank(ranks, name)
    want = refs[name]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(np.log(got), np.log(want), atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("name,experts", [("moe_ep2_tp2", 2), ("moe_tp2", 2)])
def test_moe_expert_parallel_decoder_matches_jax(runs, name, experts):
    """qwen3-vl-moe-test's 4 experts split over ep (or tp without an ep
    axis): each rank holds 2 and routes only its rows to them."""
    ranks, refs = runs
    assert [r[name]["experts"] for r in ranks] == [experts] * WORLD
    got = _same_on_every_rank(ranks, name, "logits")
    np.testing.assert_allclose(got, refs[name], atol=FEAT_TOL, rtol=0)


def test_multihost_mesh_dcn2_tp2_matches_jax(runs):
    ranks, refs = runs
    assert all(r["multihost"]["spec"] == (("dcn", "dp"),) for r in ranks)
    assert [r["multihost"]["rows"] for r in ranks] == [(0, 4), (0, 4), (4, 8), (4, 8)]
    got = _same_on_every_rank(ranks, "multihost", "scores")
    np.testing.assert_allclose(got, refs["multihost"], atol=FEAT_TOL, rtol=0)


def test_clipscore_at_dp2_tp2_matches_jax(runs):
    ranks, refs = runs
    got = _same_on_every_rank(ranks, "clipscore", "matrix")
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, refs["clipscore"], atol=SCORE_TOL, rtol=0)
    pairs = _same_on_every_rank(ranks, "clipscore", "pairs")
    np.testing.assert_allclose(pairs, np.diag(refs["clipscore"][:, :3]), atol=SCORE_TOL,
                               rtol=0)
