"""Port parity: per-head attention (t2v_metrics_tpu_torch/ops/attention.py
``attention_reference`` / ``attention``, the plain version of the CUDA
``flash_attention``) against the JAX package's ``flash_attention`` in
interpret mode, and the flat path's local window and bidir overlay against
the JAX ``flash_attention_flat`` in interpret mode, on the CPU.

Inputs come from a numpy seed. Tolerance 2e-5: fp32 on both sides; the
flash form divides by the row sum after P.V over KV blocks where the plain
version normalizes once. The T5 bucket table is held exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import t5 as jt5  # noqa: E402
from t2v_metrics_tpu.ops.attention import (flash_attention,  # noqa: E402
                                           flash_attention_flat)
from t2v_metrics_tpu_torch.ops import position  # noqa: E402
from t2v_metrics_tpu_torch.ops import attention as TA  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

TOL = 2e-5


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _blocks(b, s, spans):
    ids = np.full((b, s), -1, np.int32)
    for i, (start, n) in enumerate(spans):
        ids[:, start:start + n] = i
    return ids


# name: (B, H, Sq, Sk, D, kwargs); every case streams sk > block_k = 128
CASES = {
    "multi_block_kv": (2, 2, 130, 300, 16, {}),
    "kv_mask": (2, 3, 200, 200, 16, dict(kv_mask=True)),
    "causal_sq_lt_sk": (2, 2, 100, 260, 16, dict(causal=True, kv_mask=True)),
    "segment_ids": (2, 2, 256, 256, 16, dict(segment_ids=True)),
    "window_bidir": (2, 2, 256, 256, 32, dict(local_window=48,
                                              bidir=((40, 32), (150, 70)))),
    "batch_bias": (2, 2, 140, 140, 16, dict(bias=(2, 1))),
    "head_bias_causal": (2, 3, 140, 140, 16, dict(bias=(1, 3), causal=True)),
    "rel_bidirectional": (2, 3, 200, 200, 16, dict(rel=True, kv_mask=True)),
    "rel_causal": (2, 3, 150, 150, 16, dict(rel=False, causal=True)),
}


def _inputs(name):
    b, h, sq, sk, d, kw = CASES[name]
    q, k, v = _qkv(b, h, sq, sk, d, sorted(CASES).index(name))
    rng = np.random.default_rng(99)
    args = {"causal": kw.get("causal", False)}
    if kw.get("kv_mask"):
        m = rng.random((b, sk)) > 0.2
        m[:, -1] = True
        args["kv_mask"] = m
    if "bias" in kw:
        args["bias"] = rng.normal(size=(*kw["bias"], sq, sk)).astype(np.float32)
    if kw.get("segment_ids"):
        args["segment_ids"] = np.broadcast_to(np.arange(sq) // 50, (b, sq)).astype(np.int32)
    if "local_window" in kw:
        args["local_window"] = kw["local_window"]
        args["bidir_ids"] = _blocks(b, sq, kw["bidir"])
        args["causal"] = True
    if "rel" in kw:
        args["rel_bias"] = rng.normal(size=(h, 32)).astype(np.float32)
        args["rel_cfg"] = (kw["rel"], 32, 128, 0)
        args["scale"] = 1.0
    return (q, k, v), args


def _conv(args, fn):
    return {n: (a if n in ("causal", "local_window", "rel_cfg", "scale") else fn(a))
            for n, a in args.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_matches_jax_flash_kernel(name):
    (q, k, v), args = _inputs(name)
    want = flash_attention(*map(_j, (q, k, v)), **_conv(args, _j), interpret=True)
    before = launch_counts()
    got = TA.attention(*map(_t, (q, k, v)), **_conv(args, _t))
    ref = TA.attention_reference(*map(_t, (q, k, v)), **_conv(args, _t))
    assert launch_counts() == before               # the CPU runs no kernel
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("sq,sk,q_offset", [(40, 40, 0), (7, 300, 0), (24, 24, 3)])
def test_rel_bucket_table_equals_position_bias(bidirectional, sq, sk, q_offset):
    """The kernel's bias, gathered through the bucket table at
    ``col - row + Sq - 1``, is ``compute_position_bias`` exactly (and the
    JAX package's)."""
    h, nb, md = 3, 32, 128
    rel = torch.from_numpy(np.random.default_rng(5).normal(size=(h, nb)).astype(np.float32))
    table = TA.rel_bucket_table(sq, sk, bidirectional, nb, md, q_offset,
                                torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (sq + sk - 1,)
    j = (torch.arange(sk)[None, :] - torch.arange(sq)[:, None]) + sq - 1
    got = rel[:, table[j].long()][None]                       # (1, H, Sq, Sk)
    want = position.compute_position_bias(rel.T, sq, sk, bidirectional, nb, md, q_offset)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jt5.compute_position_bias(
            jnp.asarray(rel.numpy().T), sq, sk, bidirectional, nb, md, q_offset)))


def test_fully_masked_rows_give_zero():
    """The kernels' rule, as the JAX flash kernel's."""
    (q, k, v), _ = _inputs("kv_mask")
    m = np.ones((2, 200), bool)
    m[1] = False
    got = TA.attention(*map(_t, (q, k, v)), kv_mask=_t(m)).numpy()
    assert np.all(got[1] == 0.0)
    want = flash_attention(*map(_j, (q, k, v)), kv_mask=_j(m), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_packed_views_and_merge():
    """``packed_heads`` views of a packed projection give the per-head
    inputs, and the merged output is the flat path's."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3 * 4 * 16)).astype(np.float32))
    q, k, v = TA.packed_heads(qkv, 4)
    assert q.shape == (2, 4, 50, 16) and q.data_ptr() == qkv.data_ptr()
    got = TA.merge_heads(TA.attention(q, k, v))
    np.testing.assert_allclose(got.numpy(), TA.attention_flat_packed(qkv, 4).numpy(),
                               atol=TOL, rtol=TOL)


# name: (B, S, H, KvH, D, window, bidir spans)
FLAT_CASES = {
    "window_bidir_d32": (2, 160, 4, 4, 32, 48, ((40, 32),)),
    "bidir_gqa_d256": (2, 144, 4, 2, 256, None, ((10, 60),)),
    "window_bidir_gqa_d256": (1, 200, 4, 2, 256, 64, ((20, 100),)),
}


@pytest.mark.parametrize("name", sorted(FLAT_CASES))
def test_flat_window_bidir_match_jax_flat_kernel(name):
    b, s, h, kvh, d, window, spans = FLAT_CASES[name]
    rng = np.random.default_rng(sorted(FLAT_CASES).index(name) + 20)
    q = rng.normal(size=(b, s, h * d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh * d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh * d)).astype(np.float32)
    mask = np.arange(s)[None] < np.array([[s], [s - 30]])[:b]
    bid = _blocks(b, s, spans)
    kw = dict(kv_heads=kvh, causal=True, local_window=window)
    want = flash_attention_flat(*map(_j, (q, k, v)), h, kv_mask=_j(mask),
                                bidir_ids=_j(bid), interpret=True, **kw)
    got = TA.attention_flat(*map(_t, (q, k, v)), h, kv_mask=_t(mask),
                            bidir_ids=_t(bid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    packed = np.concatenate([q, k, v], axis=-1)
    got_p = TA.attention_flat_packed(_t(packed), h, kv_mask=_t(mask),
                                     bidir_ids=_t(bid), **kw)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
