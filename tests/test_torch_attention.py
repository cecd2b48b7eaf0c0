"""Port parity: flat attention (t2v_metrics_tpu_torch/ops/attention.py)
against the JAX package on the CPU.

The port's CPU route is its plain version, ``attention_flat_reference``; it
is held against the JAX flat flash kernel in interpret mode (H=4, d=32, so
the JAX head-group plan accepts the packed case) and, for the T5 decoder's
sq=4 shapes and the terms the flat kernel skips, against
``attention_reference``. Tolerance 2e-5: fp32 on both sides, and the flash
form divides by the row sum after P.V where the reference normalizes first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.ops.attention import (attention_reference,  # noqa: E402
                                           flash_attention_flat,
                                           flash_attention_flat_packed)
from t2v_metrics_tpu_torch.ops import attention as TA  # noqa: E402

TOL = 2e-5


def _heads(x, n):
    b, s, hd = x.shape
    return jnp.asarray(x).reshape(b, s, n, hd // n).transpose(0, 2, 1, 3)


def _flat(x):
    b, h, s, d = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(b, s, h * d)


def _case(B, S, Sk, H, D, seed, bias, kv_mask, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or H
    q = rng.normal(size=(B, S, H * D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, kvh * D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, kvh * D)).astype(np.float32)
    b = rng.normal(size=(1, H, S, Sk)).astype(np.float32) if bias else None
    m = None
    if kv_mask:
        m = rng.random((B, Sk)) > 0.2
        m[:, 0] = True
    return q, k, v, b, m


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = {  # name: (bias, kv_mask, causal)
    "plain": (False, False, False),
    "bias": (True, False, False),
    "kv_mask": (False, True, False),
    "causal_bias_mask": (True, True, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_matches_jax_flat_kernel(name):
    bias, mask, causal = CASES[name]
    q, k, v, b, m = _case(2, 160, 160, 4, 32, 0, bias, mask)
    got = TA.attention_flat(_t(q), _t(k), _t(v), 4, bias=_t(b), kv_mask=_t(m),
                            causal=causal).numpy()
    want = flash_attention_flat(_j(q), _j(k), _j(v), 4, bias=_j(b),
                                kv_mask=_j(m), causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_matches_jax_flat_packed_kernel(name):
    bias, mask, causal = CASES[name]
    q, k, v, b, m = _case(2, 137, 137, 4, 32, 1, bias, mask)
    qkv = np.concatenate([q, k, v], axis=-1)
    got = TA.attention_flat_packed(_t(qkv), 4, bias=_t(b), kv_mask=_t(m),
                                   causal=causal, scale=1.0).numpy()
    want = flash_attention_flat_packed(_j(qkv), 4, bias=_j(b), kv_mask=_j(m),
                                       causal=causal, scale=1.0, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_t5_decoder_self_attention_sq4():
    """Packed causal self-attention with the rel-pos bias at sq = sk = 4."""
    q, k, v, b, _ = _case(3, 4, 4, 4, 16, 2, True, False)
    qkv = np.concatenate([q, k, v], axis=-1)
    got = TA.attention_flat_packed(_t(qkv), 4, bias=_t(b), causal=True,
                                   scale=1.0).numpy()
    want = attention_reference(_heads(q, 4), _heads(k, 4), _heads(v, 4),
                               bias=_j(b), causal=True, scale=1.0)
    np.testing.assert_allclose(got, _flat(want), atol=TOL, rtol=TOL)


def test_t5_cross_attention_sq4():
    """Unpacked cross-attention, 4 queries over 40 masked keys."""
    q, k, v, _, m = _case(3, 4, 40, 4, 16, 3, False, True)
    got = TA.attention_flat(_t(q), _t(k), _t(v), 4, kv_mask=_t(m),
                            scale=1.0).numpy()
    want = attention_reference(_heads(q, 4), _heads(k, 4), _heads(v, 4),
                               kv_mask=_j(m), scale=1.0)
    np.testing.assert_allclose(got, _flat(want), atol=TOL, rtol=TOL)


def test_end_aligned_causal_sq_lt_sk():
    q, k, v, _, _ = _case(2, 5, 12, 4, 16, 4, False, False)
    got = TA.attention_flat(_t(q), _t(k), _t(v), 4, causal=True).numpy()
    want = attention_reference(_heads(q, 4), _heads(k, 4), _heads(v, 4),
                               causal=True)
    np.testing.assert_allclose(got, _flat(want), atol=TOL, rtol=TOL)


def test_gqa_matches_repeated_heads():
    q, k, v, _, m = _case(2, 24, 24, 8, 16, 5, False, True, kvh=2)
    got = TA.attention_flat(_t(q), _t(k), _t(v), 8, kv_heads=2,
                            kv_mask=_t(m)).numpy()
    kh = jnp.repeat(_heads(k, 2), 4, axis=1)
    vh = jnp.repeat(_heads(v, 2), 4, axis=1)
    want = attention_reference(_heads(q, 8), kh, vh, kv_mask=_j(m))
    np.testing.assert_allclose(got, _flat(want), atol=TOL, rtol=TOL)


def test_fully_masked_rows_give_zero():
    """The flat kernel's rule (attention_reference gives the mean of v)."""
    q, k, v, _, m = _case(2, 6, 6, 4, 16, 6, False, True)
    m[1] = False
    got = TA.attention_flat(_t(q), _t(k), _t(v), 4, kv_mask=_t(m)).numpy()
    assert np.all(got[1] == 0.0)
    want = flash_attention_flat(_j(q), _j(k), _j(v), 4, kv_mask=_j(m),
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("term", ["segment_ids", "local_window", "bidir_ids"])
def test_cpu_only_terms_match_reference(term):
    q, k, v, _, _ = _case(2, 16, 16, 4, 16, 7, False, False)
    rng = np.random.default_rng(8)
    kw, causal = {}, False
    if term == "segment_ids":
        kw["segment_ids"] = np.sort(rng.integers(0, 3, (2, 16)), axis=1)
    elif term == "local_window":
        kw["local_window"], causal = 5, True
    else:
        ids = np.full((2, 16), -1)
        ids[:, 3:9] = 0
        kw["bidir_ids"], causal = ids, True
    got = TA.attention_flat(_t(q), _t(k), _t(v), 4, causal=causal,
                            **{n: (a if n == "local_window" else _t(a))
                               for n, a in kw.items()}).numpy()
    want = attention_reference(_heads(q, 4), _heads(k, 4), _heads(v, 4),
                               causal=causal,
                               **{n: (a if n == "local_window" else _j(a))
                                  for n, a in kw.items()})
    np.testing.assert_allclose(got, _flat(want), atol=TOL, rtol=TOL)


def test_bf16_rounds_p_before_pv():
    """In bf16 the plain version rounds P to bf16 before P.V, as the kernel
    does; held against an fp32 evaluation of that recipe."""
    q, k, v, _, _ = _case(1, 8, 8, 4, 16, 9, False, False)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = TA.attention_flat(qb, kb, vb, 4).float().numpy()
    s = np.einsum("bhqd,bhkd->bhqk", *(np.asarray(_heads(a.float().numpy(), 4))
                                      for a in (qb, kb))) * 16 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    pb = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
    o = np.einsum("bhqk,bhkd->bhqd", pb, np.asarray(_heads(vb.float().numpy(), 4)))
    o = o / p.sum(-1, keepdims=True)
    want = torch.from_numpy(_flat(o)).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
