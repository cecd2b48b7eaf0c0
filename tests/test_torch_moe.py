"""Port parity: the MoE expert dispatch (``ops/moe.py``) and the decoder's
dense ``_moe_mlp`` against the JAX package on the CPU.

The plan (order, dest, block_expert, P) must be identical. The grouped GEMM
(the port's plain version on CPU tensors) is held against the JAX Pallas
kernel in interpret mode and against its XLA reference at rtol/atol 1e-5
(fp32; the JAX test suite's tolerance for the same comparison). The MoE MLP
is held against the JAX dense einsum ``_moe_mlp`` and the JAX dispatch at
rtol and atol 2e-5 (fp32; the JAX suite holds its dispatch against its
dense path at rtol 2e-5, atol 2e-6, and across the two libraries the router
softmax differs in the last bits: ~3.5e-6 on outputs of ~0.3 under the
skewed router's logits of ~50).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.ops import moe as jmoe  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402
from t2v_metrics_tpu_torch.ops import moe as tmoe  # noqa: E402

RTOL = ATOL = 2e-5


def _cfgs(experts=6, topk=2, dispatch=False):
    j = dataclasses.replace(
        jdec.DecoderConfig(vocab_size=64, d_model=32, layers=1, heads=4,
                           kv_heads=2, head_dim=8, d_ff=0, mrope_section=None,
                           qkv_bias=False),
        num_experts=experts, experts_per_tok=topk, moe_d_ff=16,
        moe_dispatch=dispatch)
    return j, tdec.DecoderConfig(**dataclasses.asdict(j))


def _moe_params(cfg, seed=0, router_bias=None):
    rng = np.random.default_rng(seed)
    e, d, i = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    if router_bias is not None:
        router += np.asarray(router_bias, np.float32)
    gate_up = (rng.standard_normal((e, d, 2 * i)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((e, i, d)) * 0.1).astype(np.float32)
    jp = {"router": {"w": jnp.asarray(router)}, "gate_up": jnp.asarray(gate_up),
          "down": jnp.asarray(down)}
    tp = tdec.MoE(tdec.DecoderConfig(**dataclasses.asdict(cfg)), "cpu",
                  torch.float32)
    with torch.no_grad():
        tp.router.w.copy_(torch.from_numpy(router))
        tp.gate_up.copy_(torch.from_numpy(gate_up))
        tp.down.copy_(torch.from_numpy(down))
    return jp, tp


@pytest.mark.parametrize("e,bm,tk", [(7, 8, 50), (128, 128, 9 * 8), (3, 4, 1)])
def test_plan_groups_equals_jax(e, bm, tk):
    ids = np.random.default_rng(e).integers(0, e, (tk,))
    got = tmoe.plan_groups(torch.from_numpy(ids), e, bm)
    want = jmoe.plan_groups(jnp.asarray(ids), e, bm)
    assert got[3] == want[3]
    for g, w, name in zip(got[:3], want[:3], ("order", "dest", "block_expert")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].dtype == torch.int32
    # every assignment has its own slot, in a block of its expert
    order, dest, be = (t.numpy() for t in got[:3])
    assert len(set(dest.tolist())) == tk
    np.testing.assert_array_equal(be[dest // bm], ids[order])


@pytest.mark.parametrize("shape", [(4, 32, 24, 16), (8, 64, 40, 128),
                                   (5, 32, 128, 128)])
def test_grouped_matmul_matches_jax_kernel_and_reference(shape):
    e, h, i, bm = shape
    rng = np.random.default_rng(1)
    nb = 6
    xg = rng.standard_normal((nb * bm, h)).astype(np.float32)
    w = rng.standard_normal((e, h, i)).astype(np.float32)
    be = rng.integers(0, e, (nb,)).astype(np.int32)
    be[2] = be[1]                                     # a run of two blocks
    got = tmoe.grouped_matmul(*map(torch.from_numpy, (xg, w, be)), bm).numpy()
    ref = jmoe.grouped_matmul_reference(*map(jnp.asarray, (xg, w, be)), bm)
    kern = jmoe.grouped_matmul(*map(jnp.asarray, (xg, w, be)), block_m=bm,
                               block_i=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-5)


def test_moe_dispatch_matches_jax_dense_and_dispatch():
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    got = tmoe.moe_mlp_dispatch(tp, tcfg, torch.from_numpy(x), block_m=8).numpy()
    dense = jdec._moe_mlp(jp, jcfg, jnp.asarray(x))
    disp = jmoe.moe_mlp_dispatch(jp, jcfg, jnp.asarray(x), block_m=8)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(disp), rtol=RTOL, atol=ATOL)


def test_moe_skewed_routing_drops_nothing():
    """Every token routes to experts 3 and 4: the block-aligned plan drops
    no token (capacity-factor dispatch would), and the empty experts get no
    block."""
    jcfg, tcfg = _cfgs()
    bias = np.zeros(jcfg.num_experts)
    bias[3], bias[4] = 50.0, 49.0
    jp, tp = _moe_params(jcfg, router_bias=bias)
    x = np.random.default_rng(3).standard_normal((1, 33, jcfg.d_model)).astype(np.float32)
    got = tmoe.moe_mlp_dispatch(tp, tcfg, torch.from_numpy(x), block_m=8).numpy()
    dense = jdec._moe_mlp(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(dense), rtol=RTOL, atol=ATOL)
    ids = torch.tensor([3, 4] * 33)
    _, _, be, p = tmoe.plan_groups(ids, jcfg.num_experts, 8)
    assert p == 72 + 6 * 8 and set(be.tolist()) == {0, 3, 4}


@pytest.mark.parametrize("norm_topk", [True, False])
def test_dense_moe_mlp_matches_jax(norm_topk):
    jcfg, tcfg = _cfgs(experts=5, topk=3)
    jcfg = dataclasses.replace(jcfg, moe_norm_topk=norm_topk)
    tcfg = dataclasses.replace(tcfg, moe_norm_topk=norm_topk)
    jp, tp = _moe_params(jcfg, seed=4)
    x = np.random.default_rng(5).standard_normal((3, 4, jcfg.d_model)).astype(np.float32)
    got = tdec._moe_mlp(tp, tcfg, torch.from_numpy(x)).numpy()
    want = jdec._moe_mlp(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decoder_dispatch_flag_equals_dense_path():
    """``forward`` with moe_dispatch=True equals the dense path on the same
    random decoder, and the CPU run launches no kernel."""
    _, tcfg = _cfgs()
    model = tdec.init_decoder(tdec.Decoder(tcfg, "cpu", torch.float32),
                              torch.Generator().manual_seed(5))
    embeds = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 7, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(7)[None].expand(2, -1)
    mask = torch.ones((2, 7), dtype=torch.bool)
    before = launch_counts()
    with torch.inference_mode():
        ref = tdec.forward(model, tcfg, embeds, pos, mask)
        out = tdec.forward(model, dataclasses.replace(tcfg, moe_dispatch=True),
                           embeds, pos, mask)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert launch_counts() == before


def test_grouped_matmul_refuses_other_devices_and_ragged_rows():
    x = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError):
        tmoe.grouped_matmul(x, torch.zeros(2, 4, 4, device="meta"),
                            torch.zeros(1, dtype=torch.int32, device="meta"), 8)
    with pytest.raises(ValueError):
        tmoe.grouped_matmul(torch.zeros(12, 4), torch.zeros(2, 4, 4),
                            torch.zeros(2, dtype=torch.int32), 8)
