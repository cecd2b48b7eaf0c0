"""Port parity: T5 (t2v_metrics_tpu_torch/models/t5.py) against the JAX
package on the CPU, with the JAX parameters carried over by ``bridge.py``.

Bucketing is integer-exact. Tolerance 1e-4 in fp32 for hidden states,
logits and mean answer log-probs: the two CPU BLAS libraries sum the
matmuls in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import t5 as jt5  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402

TOL = 1e-4
FIELDS = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_heads=4,
              enc_layers=2, dec_layers=2)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket(bidirectional):
    rel = np.arange(-300, 300)[None, :] - np.arange(0, 40)[:, None]
    want = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128)
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    emb = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tt5.compute_position_bias(torch.from_numpy(emb), 7, 11, bidirectional,
                                  32, 128, q_offset=3).numpy(),
        np.asarray(jt5.compute_position_bias(jnp.asarray(emb), 7, 11,
                                             bidirectional, 32, 128, q_offset=3)))


# FlanT5 (gated gelu_new MLP, untied lm_head) and classic T5 (relu MLP,
# lm_head tied to the embeddings with the d_model**-0.5 rescale)
VARIANTS = {"flan": {}, "tied_relu": dict(gated=False, act="relu",
                                          tie_word_embeddings=True)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    fields = dict(FIELDS, **VARIANTS[request.param])
    jcfg = jt5.T5Config(**fields)
    tcfg = tt5.T5Config(**fields)
    jp = jt5.init_t5(jax.random.PRNGKey(0), jcfg)
    # norm scales away from 1 so that the bridge's norm mapping is exercised
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) * (1 + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
              for x in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    tp = bridge.t5_from_numpy(jp, tcfg, "cpu", torch.float32)

    rng = np.random.default_rng(2)
    B, S, A = 3, 24, 4
    embeds = rng.normal(size=(B, S, 64)).astype(np.float32)
    enc_mask = np.ones((B, S), bool)
    enc_mask[1, 17:] = False
    enc_mask[2, 9:] = False
    ans = rng.integers(3, 300, (B, A)).astype(np.int32)
    ans_mask = np.ones((B, A), np.float32)
    ans_mask[0, 2:] = 0.0
    ans[0, 2:] = 0
    return jcfg, jp, tcfg, tp, (embeds, enc_mask, ans, ans_mask)


def test_encode_decode_match_jax(models):
    jcfg, jp, tcfg, tp, (embeds, enc_mask, ans, _) = models
    want_h = jt5.encode(jp, jcfg, jnp.asarray(embeds), jnp.asarray(enc_mask))
    want_l = jt5.decode(jp, jcfg, jnp.asarray(ans), want_h, jnp.asarray(enc_mask))
    with torch.inference_mode():
        got_h = tt5.encode(tp, tcfg, torch.from_numpy(embeds),
                           torch.from_numpy(enc_mask))
        got_l = tt5.decode(tp, tcfg, torch.from_numpy(ans), got_h,
                           torch.from_numpy(enc_mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=TOL, rtol=TOL)
    assert got_l.dtype == torch.float32
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=TOL, rtol=TOL)


def test_answer_log_probs_match_jax(models):
    jcfg, jp, tcfg, tp, arrays = models
    want = jt5.answer_log_probs(jp, jcfg, *map(jnp.asarray, arrays))
    with torch.inference_mode():
        got = tt5.answer_log_probs(tp, tcfg, *map(torch.from_numpy, arrays))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_init_t5_distributions():
    cfg = tt5.T5Config(**FIELDS)
    p = tt5.init_t5(tt5.T5Model(cfg, "cpu", torch.float32),
                    torch.Generator().manual_seed(0))
    assert torch.equal(p.encoder.blocks[0].ln1.scale, torch.ones(64))
    assert p.encoder.blocks[0].attn.rel_bias.shape == (32, 4)
    assert p.encoder.blocks[1].attn.rel_bias is None
    for t in (p.shared_emb, p.lm_head, p.decoder.blocks[1].cross.k.w,
              p.encoder.blocks[0].attn.qkv.w):
        assert abs(t.std().item() / 0.02 - 1) < 0.15
