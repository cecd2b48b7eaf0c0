"""Port parity: the W8A8 mode (t2v_metrics_tpu_torch/ops/quant.py) against
t2v_metrics_tpu/ops/quant.py on the CPU, and the int8 clip-flant5 modes.

Tolerances:
  * the ops (weight quant, row quant, the int8 product, packing): bitwise.
    Both packages quantize in f32 with a correctly rounded division and
    round half to even, the int8 product is exact, and the epilogue is the
    same two f32 products rounded once;
  * the int8 slice against the JAX package: 1e-4 nats on pairs where no
    activation's int8 rounding differs, as for the bf16 slice. The two
    packages' f32 activations differ by ~1e-7 relative (BLAS summation
    order), so an element within that of a rounding tie lands on the
    neighbouring int8 level in one package only: a step of absmax/127 in
    one input, which moves that pair's score by up to a few 1e-3 nats in
    this seeded model (measured 1.6e-3 at most). So at least 3/4 of the
    pairs must agree to 1e-4 and every pair to 5e-3;
  * int8 against f32 scores at true xl widths (2+2 layers) and at one
    xxl-width layer (1+1) on HF-initialised weights: the measured error with
    ~1.5x room (1.04e-3 at xl, just over the BASELINE bar of 1e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.ops import quant as JQ  # noqa: E402
from t2v_metrics_tpu.ops import quant_matmul as JQK  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402
from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS as T_MODELS  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402
from t2v_metrics_tpu_torch.ops import quant as TQ  # noqa: E402

TEXTS = ["a red cube on a table", "two dogs", "a cat sleeping on a warm sofa",
         "an empty street at night"]


def _ties(shape, seed):
    """Values with exact rounding ties: each row (or column) has absmax 127,
    so the scale is 1 and k + 0.5 sits on a tie (half to even gives 2 for
    2.5, -4 for -3.5; floor(x + 0.5) would give 3 and -3)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-126, 126, shape) + 0.5).astype(np.float32)
    return x


def _arrays(kind, shape, seed):
    if kind == "ties":
        x = _ties(shape, seed)
        x[..., 0] = 127.0          # rows: absmax 127
        return x
    return (np.random.default_rng(seed).normal(size=shape) * 3).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the ops, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("normal", (64, 32)), ("normal", (37, 24)),
                                        ("ties", (40, 16)), ("zero_column", (8, 5))])
def test_quantize_weight_matches_jax(kind, shape):
    if kind == "ties":
        w = _ties(shape, 1)
        w[0] = 127.0               # columns: absmax 127
    elif kind == "zero_column":
        w = _arrays("normal", shape, 2)
        w[:, 3] = 0.0              # scale floor 1e-12 / 127
    else:
        w = _arrays(kind, shape, 3) * 0.05
    j = JQ.quantize_weight(jnp.asarray(w))
    w_q, scale = TQ.quantize_weight(torch.from_numpy(w))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(j["w_q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j["scale"]))
    if kind == "ties":   # half to even, not floor(x + 0.5)
        np.testing.assert_array_equal(w_q.numpy()[1:], np.rint(w[1:]).astype(np.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,shape", [("normal", (4, 7, 96)), ("ties", (33, 64)),
                                        ("normal", (1, 10240))])
def test_quantize_rows_matches_jax(kind, shape, dtype):
    x = _arrays(kind, shape, 4)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JQ._quantize_rows(xj)
    tq, ts = TQ.quantize_rows(xt)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.shape == x.shape and ts.shape == (*x.shape[:-1], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,kind", [(37, 96, 40, "normal"), (128, 256, 64, "normal"),
                                        (5, 64, 24, "ties"), (3, 10240, 16, "normal")])
def test_int8_matmul_matches_jax(m, k, n, kind, dtype):
    x = _arrays(kind, (m, k), 5)
    w = _arrays("normal", (k, n), 6) * 0.02
    j = JQ.quantize_weight(jnp.asarray(w))
    jo = JQ.int8_matmul(jnp.asarray(x, getattr(jnp, dtype)), j["w_q"], j["scale"])
    w_q, scale = TQ.quantize_weight(torch.from_numpy(w))
    to = TQ.int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), w_q, scale)
    assert to.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [9, 10])
def test_quant_matmul_plain_matches_interpret_kernel(seed):
    """The plain version against the TPU kernel itself, run in interpret
    mode as tests/test_quant.py runs it (aligned shapes: the Pallas grid
    needs whole blocks), with the wide accumulations |acc| > 2^24 that f32
    rounds."""
    rng = np.random.default_rng(seed)
    m, k, n = 256, 512, 256
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    x_q[0] = 127                    # acc = 127^2 * 512 > 2^24 in row 0
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w_q[:, 0] = 127
    xs = rng.uniform(1e-3, 2e-3, (m, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 2e-3, (n,)).astype(np.float32)
    want = JQK.quant_matmul(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(xs),
                            jnp.asarray(ws), bm=128, bk=256, bn=128, interpret=True)
    got = TQ.quant_matmul(*map(torch.from_numpy, (x_q, w_q, xs, ws)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_quant_matmul_sums_are_one_split(monkeypatch):
    """What a row-parallel int8 product all-reduces: one (1, M, N) int32
    split, however many splits of K the kernel wrote (four here, as it
    picks for a decode step's few rows), summed exactly."""
    rng = np.random.default_rng(11)
    x_q = torch.from_numpy(rng.integers(-127, 128, (4, 1024)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (1024, 24)).astype(np.int8))
    x_q[0], w_q[:, 0] = 127, 127            # |acc| = 127^2 x 1024, past 2^24

    def four_splits(x, w):
        return torch.cat([TQ.quant_matmul_partials_plain(xc, wc)
                          for xc, wc in zip(x.chunk(4, 1), w.chunk(4, 0))])

    monkeypatch.setattr(TQ, "quant_matmul_partials", four_splits)
    assert four_splits(x_q, w_q).shape == (4, 4, 24)
    got = TQ.quant_matmul_sums(x_q, w_q)
    assert got.dtype == torch.int32 and got.shape == (1, 4, 24)
    assert torch.equal(got, TQ.quant_matmul_partials_plain(x_q, w_q))


# ---------------------------------------------------------------------------
# (b) packing int8 leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_pack_int8_equals_separate(bias):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, 5, 32)).astype(np.float32))
    leaves, jleaves = [], []
    for n in (16, 24, 8):
        w = rng.normal(size=(32, n)).astype(np.float32) * 0.1
        b = rng.normal(size=(n,)).astype(np.float32) if bias else None
        w_q, scale = TQ.quantize_weight(torch.from_numpy(w))
        leaves.append(TQ.Linear(b=None if b is None else torch.from_numpy(b),
                                w_q=w_q, scale=scale))
        jleaves.append(dict(JQ.quantize_weight(jnp.asarray(w)),
                            **({} if b is None else {"b": jnp.asarray(b)})))
    sep = torch.cat([TQ.linear(x, p) for p in leaves], dim=-1)
    packed = TQ.pack(leaves)
    assert packed.quantized and packed.w_qt.is_contiguous()
    for got in (TQ.linear(x, packed), TQ.linear_packed(x, leaves)):
        assert torch.equal(got, sep)
    np.testing.assert_array_equal(TQ.mm_packed(x, leaves).numpy(),
                                  np.asarray(JQ.mm_packed(jnp.asarray(x.numpy()), jleaves)))
    np.testing.assert_array_equal(TQ.linear_packed(x, leaves).numpy(),
                                  np.asarray(JQ.linear_packed(jnp.asarray(x.numpy()), jleaves)))


def test_quantize_leaf_in_place_frees_the_dense_weight():
    w = torch.from_numpy(np.random.default_rng(12).normal(size=(16, 8)).astype(np.float32))
    leaf = TQ.Linear(w.clone(), torch.ones(8))
    assert leaf.quantize_() is leaf and leaf.quantized and leaf.w is None
    assert sorted(leaf.state_dict()) == ["b", "scale", "w_qt"]
    w_q, scale = TQ.quantize_weight(w)
    assert torch.equal(leaf.w_q, w_q) and torch.equal(leaf.scale, scale)
    before = leaf.w_qt
    leaf.quantize_()                # an int8 leaf stays as it is
    assert leaf.w_qt is before


# ---------------------------------------------------------------------------
# (c) which leaves quantize, and the bridge of int8 trees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def test_params():
    cfg = J_MODELS["clip-flant5-test"]["config"]
    jp = jcft5.init_clip_t5(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(np.asarray, jp)


def _int8(leaf):
    return leaf.w_q.numpy(), leaf.scale.numpy()


def _cat(jleaves):
    return (np.concatenate([np.asarray(j["w_q"]) for j in jleaves], axis=1),
            np.concatenate([np.asarray(j["scale"]) for j in jleaves]))


def _assert_leaf(leaf, jleaves):
    got, want = _int8(leaf), _cat(jleaves)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_quantize_t5_selects_the_jax_leaves(test_params):
    cfg, jp = test_params
    tcfg = T_MODELS["clip-flant5-test"]["config"].t5
    jq = jax.tree.map(np.asarray, JQ.quantize_t5_params(jax.tree.map(jnp.asarray, jp["t5"])))
    tp = TQ.quantize_t5_(bridge.t5_from_numpy(jp["t5"], tcfg, "cpu", torch.float32))
    for side in ("encoder", "decoder"):
        for blk, jblk in zip(getattr(tp, side).blocks, jq[side]["blocks"], strict=True):
            # the JAX leaves that quantize: q/k/v/o, cross q/k/v/o, wi_0/wi_1/wo
            assert {k for k, v in jblk["attn"].items() if "w_q" in v} == set("qkvo")
            _assert_leaf(blk.attn.qkv, [jblk["attn"][k] for k in "qkv"])
            _assert_leaf(blk.attn.o, [jblk["attn"]["o"]])
            assert {k for k, v in jblk["mlp"].items() if "w_q" in v} == {"wi_0", "wi_1", "wo"}
            _assert_leaf(blk.mlp.wi_01, [jblk["mlp"]["wi_0"], jblk["mlp"]["wi_1"]])
            _assert_leaf(blk.mlp.wo, [jblk["mlp"]["wo"]])
            assert not hasattr(blk.mlp, "wi_0") and not hasattr(blk.mlp, "wi_1")
            if side == "decoder":
                for k in "qkvo":
                    _assert_leaf(getattr(blk.cross, k), [jblk["cross"][k]])
            # what stays dense in JAX stays dense here
            assert blk.ln1.scale.dtype == torch.float32
    assert not isinstance(jq["shared_emb"], dict) and not isinstance(jq["lm_head"], dict)
    assert tp.shared_emb.dtype == torch.float32 and tp.lm_head.dtype == torch.float32
    rel = tp.encoder.blocks[0].attn.rel_bias
    np.testing.assert_array_equal(rel.numpy(), jq["encoder"]["blocks"][0]["attn"]["rel_bias"])
    dense = [n for n, m in tp.named_modules() if isinstance(m, TQ.Linear) and not m.quantized]
    assert dense == []


def test_quantize_clip_vision_selects_the_jax_leaves(test_params):
    cfg, jp = test_params
    tcfg = T_MODELS["clip-flant5-test"]["config"].vision
    jq = jax.tree.map(np.asarray, JQ.quantize_clip_vision_params(
        jax.tree.map(jnp.asarray, jp["vision"])))
    tv = TQ.quantize_clip_vision_(bridge.vision_from_numpy(jp["vision"], tcfg, "cpu",
                                                           torch.float32))
    for blk, jblk in zip(tv.blocks, jq["blocks"], strict=True):
        assert {k for k, v in jblk["attn"].items() if "w_q" in v} == set("qkvo")
        assert {k for k, v in jblk["mlp"].items() if "w_q" in v} == {"fc1", "fc2"}
        _assert_leaf(blk.qkv, [jblk["attn"][k] for k in "qkv"])
        np.testing.assert_array_equal(blk.qkv.b.numpy(), np.concatenate(
            [jblk["attn"][k]["b"] for k in "qkv"]))
        for leaf, j in ((blk.o, jblk["attn"]["o"]), (blk.fc1, jblk["mlp"]["fc1"]),
                        (blk.fc2, jblk["mlp"]["fc2"])):
            _assert_leaf(leaf, [j])
            np.testing.assert_array_equal(leaf.b.numpy(), j["b"])
    for name in ("patch_w", "pos_emb", "class_emb", "proj"):
        assert not isinstance(jq[name], dict)
        assert getattr(tv, name).dtype == torch.float32


def test_bridged_int8_tree_equals_port_quantized(test_params):
    """A JAX int8 tree carried over by the bridge, and a bridged dense tree
    quantized by the port, hold the same weights and give the same scores."""
    cfg, jp = test_params
    tcfg = T_MODELS["clip-flant5-test"]["config"]
    jq = dict(jp)
    jq["t5"] = jax.tree.map(np.asarray, JQ.quantize_t5_params(jax.tree.map(jnp.asarray, jp["t5"])))
    jq["vision"] = jax.tree.map(np.asarray, JQ.quantize_clip_vision_params(
        jax.tree.map(jnp.asarray, jp["vision"])))
    a = bridge.clip_t5_from_numpy(jq, tcfg, "cpu", torch.float32)
    b = bridge.clip_t5_from_numpy(jp, tcfg, "cpu", torch.float32)
    TQ.quantize_t5_(b.t5)
    TQ.quantize_clip_vision_(b.vision)
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    tok = SimpleT5Tokenizer(tcfg.t5.vocab_size)
    img = np.random.default_rng(13).integers(0, 256, (30, 38, 3), dtype=np.uint8)
    got = [tt2v.VQAScore("clip-flant5-test", params=m, tokenizer=tok, device="cpu")(
        images=[img], texts=TEXTS[:2]) for m in (a, b)]
    np.testing.assert_array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# (d) the int8 modes of the slice against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_inputs():
    cfg = J_MODELS["clip-flant5-test"]["config"]
    jp = jcft5.init_clip_t5(jax.random.PRNGKey(1), cfg)
    # widen the score spread past the near-uniform random-init logits
    jp = jax.tree.map(lambda x: np.asarray(x) * np.float32(2.0) if np.ndim(x) == 2
                      else np.asarray(x), jp)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (30, 38, 3), dtype=np.uint8) for _ in range(3)]
    return cfg, jp, images


@pytest.mark.parametrize("quant", ["int8", "int8+vit"])
def test_vqascore_int8_modes_match_jax(slice_inputs, quant):
    cfg, jp, images = slice_inputs
    tok = SimpleT5Tokenizer(cfg.t5.vocab_size)
    j = jt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok, quant=quant)
    t = tt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok, device="cpu",
                      quant=quant)
    want = np.log(j(images=images, texts=TEXTS))
    got = np.log(t(images=images, texts=TEXTS))
    diff = np.abs(got - want)
    assert got.shape == (3, 4) and np.all(np.isfinite(got))
    assert (diff <= 1e-4).mean() >= 0.75, diff
    assert diff.max() <= 5e-3, diff
    # the scores tell pairs apart, and the mode is not the bf16 path
    assert np.ptp(want) > 100 * 1e-4
    dense = tt2v.VQAScore("clip-flant5-test", params=jp, tokenizer=tok, device="cpu")
    assert not np.array_equal(np.log(dense(images=images, texts=TEXTS)), got)
    assert launch_counts()["quant_matmul"] == 0   # the CPU runs the plain versions


def test_quant_mode_from_the_environment(slice_inputs, monkeypatch):
    cfg, jp, _ = slice_inputs
    monkeypatch.setenv("T2V_QUANT", "int8+vit")
    s = tt2v.VQAScore("clip-flant5-test", params=jp, device="cpu")
    params = s.model.engine.params
    assert params.t5.encoder.blocks[0].attn.qkv.quantized
    assert params.vision.blocks[0].fc1.quantized
    assert not params.projector.fc1.quantized
    monkeypatch.setenv("T2V_QUANT", "int4")
    with pytest.raises(ValueError):
        tt2v.VQAScore("clip-flant5-test", params=jp, device="cpu")
    monkeypatch.delenv("T2V_QUANT")
    with pytest.raises(ValueError):
        tt2v.VQAScore("clip-flant5-test", params=jp, device="cpu", quant="fp8")


# ---------------------------------------------------------------------------
# (e) int8 against f32 at true xl widths and at one xxl-width layer
# ---------------------------------------------------------------------------

# measured on HF-initialised weights, these seeds: max |dp| 1.04e-3 / 6.73e-4,
# max |d log p| 9.50e-2 / 6.67e-2 nats (xl 2+2 / xxl 1+1); the limits are ~1.5x
TRUE_WIDTH_LIMITS = {"flan-t5-xl": (1.6e-3, 0.14), "flan-t5-xxl": (1.0e-3, 0.10)}


@pytest.mark.parametrize("size,layers", [("flan-t5-xl", 2), ("flan-t5-xxl", 1)])
def test_int8_scores_near_f32_at_true_widths(size, layers):
    """Scores of a T5 at the published widths, int8 against f32 on the same
    HF-initialised weights: P(answer) of every one-token answer (the softmax
    of the first decoder position) for 4 encoder inputs. HF's T5 init draws
    W_q with std (d_model * d_kv)^-1/2, the attention scale checkpoints
    carry. The lm_head is not quantized, so the vocabulary is cut to 512,
    and it is scaled to std d_model^-1/2 (HF draws an untied head with std
    1, which puts P(answer) below float32's range).

    The max over every one-token answer is 1.04e-3 at xl widths (0.095
    nats) and 6.7e-4 for the xxl layer (0.067): the BASELINE bar of 1e-3 is
    just missed at xl, where the port's plain random init missed it by more
    (1.8e-3 / 3.5e-3, 0.14-0.22 nats). The VQAScore answer "Yes" moves far
    less (tests/test_torch_real_dims.py: |dP| <= 3.1e-5). The test pins the
    error at its measured size so that a regression shows. Real checkpoints
    are not in the repository.
    """
    from transformers import T5Config, T5ForConditionalGeneration

    from t2v_metrics_tpu_torch.models.convert import convert_t5

    dp_max, dlogp_max = TRUE_WIDTH_LIMITS[size]
    cfg = dataclasses.replace(tt5.T5_CONFIGS[size], vocab_size=512,
                              enc_layers=layers, dec_layers=layers)
    torch.manual_seed(14)
    hf = T5ForConditionalGeneration(T5Config(
        vocab_size=512, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
        num_layers=layers, num_decoder_layers=layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        dropout_rate=0.0, feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1))
    with torch.no_grad():
        hf.lm_head.weight.mul_(cfg.d_model ** -0.5)
    model = bridge.t5_from_numpy(convert_t5(hf.state_dict(), layers, layers), cfg, "cpu",
                                 torch.float32)
    del hf
    rng = np.random.default_rng(15)
    b, s = 4, 24
    emb = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(np.float32))
    mask = torch.from_numpy(np.arange(s)[None] < np.array([24, 20, 17, 9])[:, None])
    start = torch.zeros((b, 1), dtype=torch.int32)

    def log_probs():
        with torch.inference_mode():
            enc = tt5.encode(model, cfg, emb, mask)
            logits = tt5.decode(model, cfg, start, enc, mask)[:, 0]
            return torch.log_softmax(logits, -1).numpy()

    ref = log_probs()
    TQ.quantize_t5_(model)
    got = log_probs()
    dp = np.abs(np.exp(got) - np.exp(ref)).max()
    dlogp = np.abs(got - ref).max()
    assert 0 < dp <= dp_max and dlogp <= dlogp_max, (dp, dlogp)
