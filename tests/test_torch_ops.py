"""Port parity: layer primitives and weight leaves (t2v_metrics_tpu_torch.ops)
against the JAX package on the CPU.

Tolerance 2e-5 for fp32 ops: both sides compute the same fp32 expression,
and the two CPU math libraries differ only in the last bits (exp/tanh/erf
implementations, summation order).
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.ops import layers as JL  # noqa: E402
from t2v_metrics_tpu.ops import quant as JQ  # noqa: E402
from t2v_metrics_tpu_torch.ops import layers as TL  # noqa: E402
from t2v_metrics_tpu_torch.ops import quant as TQ  # noqa: E402

TOL = 2e-5


def _x(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", sorted(TL.ACT_FNS))
def test_activations_match_jax(name):
    x = _x((4, 33, 48))
    got = TL.ACT_FNS[name](torch.from_numpy(x)).numpy()
    want = np.asarray(JL.ACT_FNS[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_linear_and_softmax_match_jax():
    x, w, b = _x((3, 5, 16)), _x((16, 24), 1), _x((24,), 2)
    got = TL.linear(*map(torch.from_numpy, (x, w, b))).numpy()
    want = np.asarray(JL.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    logits = _x((6, 50), 3, 5.0)
    np.testing.assert_allclose(
        TL.softmax_fp32(torch.from_numpy(logits)).numpy(),
        np.asarray(JL.softmax_fp32(jnp.asarray(logits))), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        TL.log_softmax_fp32(torch.from_numpy(logits)).numpy(),
        np.asarray(JL.log_softmax_fp32(jnp.asarray(logits))), atol=TOL, rtol=TOL)


def _leaves(bias, seed=0):
    rng = np.random.default_rng(seed)
    leaves = []
    for _ in range(3):
        w = rng.normal(size=(16, 8)).astype(np.float32)
        b = rng.normal(size=(8,)).astype(np.float32) if bias else None
        leaves.append((w, b))
    jax_leaves = [{"w": jnp.asarray(w), "b": None if b is None else jnp.asarray(b)}
                  for w, b in leaves]
    torch_leaves = [TQ.Linear(torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b))
                    for w, b in leaves]
    return jax_leaves, torch_leaves


@pytest.mark.parametrize("bias", [False, True])
def test_quant_bf16_branches_match_jax(bias):
    x = _x((2, 7, 16), 5)
    jl, tl = _leaves(bias)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (TQ.mm(xt, tl[0]), JQ.mm(xj, jl[0])),
        (TQ.linear(xt, tl[1]), JQ.linear(xj, jl[1])),
        (TQ.mm_packed(xt, tl), JQ.mm_packed(xj, jl)),
        (TQ.linear_packed(xt, tl), JQ.linear_packed(xj, jl)),
        # the load-time pack is the same q|k|v column order as mm_packed
        (TQ.linear(xt, TQ.pack(tl)), JQ.linear_packed(xj, jl)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_int8_leaf_raises():
    class Int8Leaf:
        w_q = torch.zeros((4, 4), dtype=torch.int8)
        scale = torch.ones(4)

    with pytest.raises(NotImplementedError):
        TQ.mm(torch.zeros(2, 4), Int8Leaf())
    with pytest.raises(NotImplementedError):
        TQ.mm_packed(torch.zeros(2, 4), [Int8Leaf(), Int8Leaf()])


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the kernel wrappers run their plain versions and count
    no launch."""
    from t2v_metrics_tpu_torch.ops import (attention, launch_counts, norms,
                                           reset_launch_counts, rope)

    reset_launch_counts()
    x = torch.from_numpy(_x((4, 64)))
    w = torch.ones(64)
    assert torch.equal(norms.layer_norm_fused(x, w, None),
                       norms.layer_norm_plain(x, w, None))
    assert torch.equal(norms.rms_norm_fused(x, w), norms.rms_norm_plain(x, w))
    qkv = torch.from_numpy(_x((2, 5, 3 * 4 * 64)))
    q, k, v = qkv.split(4 * 64, dim=-1)
    assert torch.equal(attention.flash_attention_flat_packed(qkv, 4),
                       attention.attention_flat_reference(q, k, v, 4))
    cos, sin = torch.ones(2, 5, 64), torch.zeros(2, 5, 64)
    assert torch.equal(rope.rope_pack(qkv, cos, sin, 8, 64),
                       rope.rope_pack_plain(qkv, cos, sin, 8, 64))
    assert launch_counts() == {"flash_attention_flat": 0, "layer_norm": 0,
                               "rms_norm": 0, "rope_pack": 0}


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        TL.layer_norm(x, torch.ones(8, device="meta"), None)
    with pytest.raises(ValueError):
        TL.rms_norm(x, torch.ones(8, device="meta"))
    from t2v_metrics_tpu_torch.ops.rope import rope_pack

    pk = torch.zeros(1, 2, 24, device="meta")
    with pytest.raises(ValueError):
        rope_pack(pk, torch.ones(1, 2, 8, device="meta"),
                  torch.ones(1, 2, 8, device="meta"), 2, 8)


def test_port_imports_no_jax():
    """Importing the port and scoring the test configs leaves jax out of
    sys.modules (the GPU machine has no jax)."""
    code = (
        "import sys, numpy as np\n"
        "import t2v_metrics_tpu_torch as t\n"
        "img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8)\n"
        "for name in ('clip-flant5-test', 'qwen2.5-vl-test'):\n"
        "    s = t.VQAScore(name, device='cpu')\n"
        "    out = s(images=[img], texts=['a red cube', 'a dog'])\n"
        "    assert out.shape == (1, 2) and np.isfinite(out).all(), out\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
