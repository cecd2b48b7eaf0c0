"""Port parity: the kernels' plain versions at the Qwen3-VL sites against
the JAX package on the CPU — qk-norm over the q|k heads of a packed row
(``ops/norms.py:rms_norm_heads_plain`` against the JAX decoder's per-head
``rms_norm`` with the q and k scales stacked), the head-dim-72 rotary
embedding and attention with segment ids (against the JAX Pallas kernels in
interpret mode), and LayerNorm at the deepstack mergers' width 4608.

Tolerances: 1e-5 for the rotation and the norms in fp32 (the same
expression; the last bits of rsqrt and of the sums differ between the two
libraries); 2e-5 for attention (fp32, the flash form divides by the row sum
after P.V); bf16 qk-norm within one bf16 ulp (rtol 2^-7).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.ops import layers as JL  # noqa: E402
from t2v_metrics_tpu.ops import rope as JR  # noqa: E402
from t2v_metrics_tpu.ops.attention import flash_attention_flat_packed  # noqa: E402
from t2v_metrics_tpu_torch.ops import attention as TA  # noqa: E402
from t2v_metrics_tpu_torch.ops import layers as TL  # noqa: E402
from t2v_metrics_tpu_torch.ops import norms as TN  # noqa: E402
from t2v_metrics_tpu_torch.ops import rope as TR  # noqa: E402


def _jax_qk_norm(packed, q_scale, k_scale, h, kvh, d, dtype=jnp.float32):
    """The JAX decoder's qk-norm (models/decoder.py, prefill branch)."""
    b, s, _ = packed.shape
    qk = jnp.asarray(packed[..., :(h + kvh) * d], dtype).reshape(b, s, h + kvh, d)
    sc = jnp.concatenate([jnp.broadcast_to(jnp.asarray(q_scale, dtype), (h, d)),
                          jnp.broadcast_to(jnp.asarray(k_scale, dtype), (kvh, d))])
    return np.asarray(JL.rms_norm(qk, sc, 1e-6).astype(jnp.float32)).reshape(b, s, -1)


@pytest.mark.parametrize("h,kvh,d", [(32, 4, 128), (4, 2, 16)])
def test_qk_norm_heads_matches_jax(h, kvh, d):
    rng = np.random.default_rng(0)
    packed = (rng.standard_normal((2, 7, (h + 2 * kvh) * d)) * 3).astype(np.float32)
    qs, ks = rng.standard_normal(d).astype(np.float32), rng.standard_normal(d).astype(np.float32)
    got = TL.rms_norm_heads(*map(torch.from_numpy, (packed, qs, ks)), h, kvh, d)
    want = _jax_qk_norm(packed, qs, ks, h, kvh, d)
    np.testing.assert_allclose(got.numpy()[..., :(h + kvh) * d], want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[..., (h + kvh) * d:],
                                  packed[..., (h + kvh) * d:])


def test_qk_norm_heads_bf16_within_one_ulp_of_jax():
    rng = np.random.default_rng(1)
    h, kvh, d = 8, 2, 128
    packed = (rng.standard_normal((1, 5, (h + 2 * kvh) * d)) * 3).astype(np.float32)
    qs, ks = rng.standard_normal(d).astype(np.float32), rng.standard_normal(d).astype(np.float32)
    got = TN.rms_norm_heads_plain(*(torch.from_numpy(a).bfloat16() for a in (packed, qs, ks)),
                                  h, kvh, d)
    assert got.dtype == torch.bfloat16
    want = _jax_qk_norm(np.asarray(torch.from_numpy(packed).bfloat16().float()),
                        np.asarray(torch.from_numpy(qs).bfloat16().float()),
                        np.asarray(torch.from_numpy(ks).bfloat16().float()),
                        h, kvh, d, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy()[..., :(h + kvh) * d], want,
                               rtol=2 ** -7, atol=1e-6)


def test_rope_pack_d72_matches_jax_kernel_and_chain():
    """The Qwen3 ViT's rotation: 16 q + 16 k heads of 72 (half 36), against
    the JAX Pallas kernel and the jnp chain the JAX Qwen3 tower runs."""
    rng = np.random.default_rng(2)
    b, s, h, d = 2, 128, 16, 72
    pk = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    ang = rng.integers(0, 48, (b, s, 1)) * rng.random(d).astype(np.float32)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    got = TR.rope_pack(*map(torch.from_numpy, (pk, cos, sin)), 2 * h, d)
    want = JR.rope_pack(jnp.asarray(pk), jnp.asarray(cos), jnp.asarray(sin),
                        2 * h, d, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    chain = jdec.apply_rope_bshd(jnp.asarray(pk[..., :2 * h * d]).reshape(b, s, 2 * h, d),
                                 jnp.asarray(cos), jnp.asarray(sin))
    np.testing.assert_allclose(got.numpy()[..., :2 * h * d],
                               np.asarray(chain).reshape(b, s, -1), atol=1e-5)


def test_segment_attention_d72_matches_jax_flat_kernel():
    """The Qwen3 ViT's attention: one image of real rows, then -1 pads (16
    heads, as the JAX kernel's 128-lane head groups need at d=72)."""
    rng = np.random.default_rng(3)
    h, d = 16, 72
    qkv = rng.standard_normal((2, 160, 3 * h * d)).astype(np.float32)
    seg = np.zeros((2, 160), np.int32)
    seg[0, 130:] = -1
    seg[1, 97:] = -1
    got = TA.attention_flat_packed(torch.from_numpy(qkv), h,
                                   segment_ids=torch.from_numpy(seg)).numpy()
    want = flash_attention_flat_packed(jnp.asarray(qkv), h,
                                       segment_ids=jnp.asarray(seg),
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_layer_norm_4608_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 4608)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(4608).astype(np.float32), rng.standard_normal(4608).astype(np.float32)
    got = TL.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6).numpy()
    want = JL.layer_norm_xla(*map(jnp.asarray, (x, w, b)), 1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
