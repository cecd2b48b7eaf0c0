"""Port parity: LayerNorm / RMSNorm (t2v_metrics_tpu_torch/ops/norms.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Tolerances: 2e-5 in fp32 (same expression, different summation order);
1 bf16 ulp in bf16 (both sides round one fp32 value, whose last bits may
differ, to bf16 — RMSNorm with cast_weight_dtype rounds the normalized value
before the scale, and the test pins that rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.ops.norms import layer_norm_fused, rms_norm_fused  # noqa: E402
from t2v_metrics_tpu_torch.ops import layers as TL  # noqa: E402

TOL = 2e-5


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0 + 0.5).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    return x, w, b


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between two bf16 arrays in units of the last place."""
    ai = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).view(torch.int16)
    bi = torch.from_numpy(np.ascontiguousarray(b)).to(torch.bfloat16).view(torch.int16)
    return int((ai.int() - bi.int()).abs().max())


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(4, 16, 256), (2, 24, 1024)])
def test_layer_norm_fp32(shape, with_bias):
    x, w, b = _inputs(shape, 0)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b) if with_bias else None).numpy()
    want = layer_norm_fused(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(b) if with_bias else None,
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_layer_norm_bf16_within_one_ulp():
    x, w, b = _inputs((8, 16, 512), 1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt, bt = torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    got = TL.layer_norm(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    want = layer_norm_fused(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                            jnp.asarray(wt.float().numpy(), jnp.bfloat16),
                            jnp.asarray(bt.float().numpy(), jnp.bfloat16),
                            interpret=True)
    assert _bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= 1


@pytest.mark.parametrize("cast_wd", [True, False])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_fp32(cast_wd, offset):
    x, w, _ = _inputs((4, 16, 256), 2)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, offset,
                      cast_wd).numpy()
    want = rms_norm_fused(jnp.asarray(x), jnp.asarray(w), 1e-6, offset, cast_wd,
                          interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cast_wd", [True, False])
def test_rms_norm_bf16_cast_before_scale(cast_wd):
    x, w, _ = _inputs((8, 16, 2048), 3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = TL.rms_norm(xt, wt, 1e-6, 0.0, cast_wd)
    want = rms_norm_fused(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                          jnp.asarray(wt.float().numpy(), jnp.bfloat16), 1e-6,
                          0.0, cast_wd, interpret=True)
    assert _bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= 1
    if cast_wd:
        # the rounding is really there: scaling the unrounded value differs
        unrounded = TL.rms_norm(xt, wt, 1e-6, 0.0, False)
        assert not torch.equal(got, unrounded)


def _add_inputs(d, seed):
    x, w, b = _inputs((2, 8, d), seed)
    r = np.random.default_rng(seed + 100).normal(size=x.shape).astype(np.float32) * 2.0
    return x, r, w, b


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("d", [1024, 1152, 4608])
def test_add_layer_norm_fp32(d, with_bias):
    """The residual add folded into the LayerNorm: (x + r, LN(x + r)) against
    the JAX package's add and its Pallas LayerNorm."""
    x, r, w, b = _add_inputs(d, 4)
    s, y = TL.add_layer_norm(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(w),
                             torch.from_numpy(b) if with_bias else None)
    js = jnp.asarray(x) + jnp.asarray(r)
    jy = layer_norm_fused(js, jnp.asarray(w), jnp.asarray(b) if with_bias else None,
                          interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("d", [1024, 1152, 4608])
def test_add_layer_norm_bf16(d, with_bias):
    """bf16: the sum rounded once, bitwise the JAX add; the LayerNorm of it
    within one bf16 ulp."""
    x, r, w, b = _add_inputs(d, 5)
    xt, rt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r))
    wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, b))
    s, y = TL.add_layer_norm(xt, rt, wt, bt if with_bias else None)
    assert s.dtype == y.dtype == torch.bfloat16

    def jbf(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    js = jbf(xt) + jbf(rt)
    jy = layer_norm_fused(js, jbf(wt), jbf(bt) if with_bias else None, interpret=True)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
    assert _bf16_ulps(y.float().numpy(), np.asarray(jy, np.float32)) <= 1


def test_add_layer_norm_without_r_is_the_layer_norm():
    x, _, w, b = _add_inputs(1152, 6)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    s, y = TL.add_layer_norm(xt, None, wt, bt)
    assert s is xt
    assert torch.equal(y, TL.layer_norm(xt, wt, bt))
