"""Port parity of the fused norm entries (t2v_metrics_tpu_torch/ops/norms.py,
ops/rope.py) against the JAX package on the CPU, and their launch plans.

- ``add_rms_norm_plain``, the plain version of the CUDA RMSNorm's add entry,
  against the JAX ``ops/layers.py:rms_norm`` of the JAX sum x + r: fp32 to
  1e-5 (the same expression; rsqrt and the sums' order differ in their last
  bits); bf16 with s bitwise the JAX add and y within one bf16 ulp (both
  sides round one fp32 value); with T5's cast and Gemma's offset.
- ``rms_norm_rope_pack_plain``, the plain version of the fused qk-norm and
  rotation, against the JAX decoder's prefill branch (``L.rms_norm`` over
  each q|k head with the q and k scales stacked, then ``apply_rope_bshd``):
  fp32 to 1e-5, bf16 within one bf16 ulp, the v lanes bitwise.
- ``layer_norm_plan``, which both CUDA norms share, at every norm width of
  the port's registry configs; ``rope_plan``'s grid covers every (row, head)
  once and spreads a decode step's rows over many programs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.ops import layers as JL  # noqa: E402
from t2v_metrics_tpu_torch.ops import layers as TL  # noqa: E402
from t2v_metrics_tpu_torch.ops import norms as TN  # noqa: E402
from t2v_metrics_tpu_torch.ops import rope as TR  # noqa: E402

TOL = 1e-5
SMS = 132


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """Largest distance between a bf16 tensor and a bf16-valued array, in
    units of the last place."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    bb = torch.from_numpy(np.array(b, np.float32)).to(torch.bfloat16)
    return int((ordered(a) - ordered(bb)).abs().max())


def _bf16(a: np.ndarray) -> np.ndarray:
    """The array rounded to bf16, as fp32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# add + RMSNorm
# ---------------------------------------------------------------------------

def _add_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0 + 0.5).astype(np.float32)
    r = (rng.normal(size=shape) * 2.0).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    return x, r, w


NORM_CASES = [(0.0, True), (0.0, False), (1.0, False), (1.0, True)]   # (offset, cast)


@pytest.mark.parametrize("offset,cast", NORM_CASES)
@pytest.mark.parametrize("d", [256, 2048, 3584])
def test_add_rms_norm_plain_fp32_matches_jax(d, offset, cast):
    x, r, w = _add_inputs((2, 8, d), d)
    s, y = TN.add_rms_norm_plain(*map(torch.from_numpy, (x, r, w)), 1e-6, offset, cast)
    js = jnp.asarray(x) + jnp.asarray(r)
    jy = JL.rms_norm(js, jnp.asarray(w), 1e-6, offset=offset, cast_weight_dtype=cast)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("offset,cast", NORM_CASES)
@pytest.mark.parametrize("d", [1024, 2048, 3200])
def test_add_rms_norm_plain_bf16_matches_jax(d, offset, cast):
    """bf16: the sum rounded once, bitwise the JAX add; the RMSNorm of it
    within one bf16 ulp (T5's cast rounds twice on both sides)."""
    x, r, w = (_bf16(a) for a in _add_inputs((2, 8, d), d + 1))
    xt, rt, wt = (torch.from_numpy(a).bfloat16() for a in (x, r, w))
    s, y = TL.add_rms_norm(xt, rt, wt, 1e-6, offset, cast)
    assert s.dtype == y.dtype == torch.bfloat16
    js = jnp.asarray(x, jnp.bfloat16) + jnp.asarray(r, jnp.bfloat16)
    jy = JL.rms_norm(js, jnp.asarray(w, jnp.bfloat16), 1e-6, offset=offset,
                     cast_weight_dtype=cast)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
    assert _bf16_ulps(y, np.asarray(jy, np.float32)) <= 1


def test_add_rms_norm_without_r_is_the_rms_norm():
    x, _, w = _add_inputs((3, 5, 1280), 7)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    s, y = TL.add_rms_norm(xt, None, wt, 1e-6, 1.0, False)
    assert s is xt
    assert torch.equal(y, TL.rms_norm(xt, wt, 1e-6, 1.0, False))


def test_the_add_entry_counts_one_norm_on_the_cpu_route(monkeypatch):
    """The add entry's plain version is the eager add and one
    ``rms_norm_plain`` call: a run that counts the plain calls as the
    kernel's launches counts it as one, as the card counts its launch."""
    calls = []
    plain = TN.rms_norm_plain
    monkeypatch.setattr(TN, "rms_norm_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    x, r, w = (torch.from_numpy(a) for a in _add_inputs((4, 64), 8))
    s, y = TN.add_rms_norm_fused(x, r, w)
    assert len(calls) == 1 and torch.equal(s, x + r)
    assert torch.equal(y, plain(x + r, w))


def test_other_devices_raise():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="add_rms_norm: no kernel"):
        TN.add_rms_norm_fused(x, x, torch.zeros(8, device="meta"))
    pk = torch.zeros(1, 2, 4 * 16, device="meta")
    w = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="rms_norm_rope_pack"):
        TN.rms_norm_heads_fused(pk, w, w, 2, 1, 16)
    cs = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="rms_norm_rope_pack: no kernel"):
        TR.rms_norm_rope_pack(pk, w, w, cs, cs, 2, 1, 16)


# ---------------------------------------------------------------------------
# qk-norm + rope
# ---------------------------------------------------------------------------

def _qk_inputs(h, kvh, d, seed, b=2, s=7):
    rng = np.random.default_rng(seed)
    packed = (rng.standard_normal((b, s, (h + 2 * kvh) * d)) * 3).astype(np.float32)
    qs = rng.standard_normal(d).astype(np.float32)
    ks = rng.standard_normal(d).astype(np.float32)
    ang = rng.integers(0, 4096, (b, s, 1)) * rng.random(d).astype(np.float32)
    return packed, qs, ks, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _jax_norm_rope(packed, qs, ks, cos, sin, h, kvh, d, offset, cast, dtype):
    """The JAX decoder's prefill branch (models/decoder.py): the qk-norm of
    the (B, S, H + KvH, D) q|k view with the scales stacked, then
    apply_rope_bshd; the v lanes concatenated after."""
    b, s, _ = packed.shape
    pk = jnp.asarray(packed, dtype)
    qk = pk[..., :(h + kvh) * d].reshape(b, s, h + kvh, d)
    sc = jnp.concatenate([jnp.broadcast_to(jnp.asarray(qs, dtype), (h, d)),
                          jnp.broadcast_to(jnp.asarray(ks, dtype), (kvh, d))])
    qk = JL.rms_norm(qk, sc, 1e-6, offset=offset, cast_weight_dtype=cast)
    qk = jdec.apply_rope_bshd(qk, jnp.asarray(cos), jnp.asarray(sin))
    out = jnp.concatenate([qk.reshape(b, s, -1), pk[..., (h + kvh) * d:]], axis=-1)
    return np.asarray(out.astype(jnp.float32))


QK_CASES = [(32, 4, 128, 0.0, True), (8, 4, 256, 1.0, False), (16, 2, 64, 0.0, True),
            (4, 2, 16, 0.0, False)]


@pytest.mark.parametrize("h,kvh,d,offset,cast", QK_CASES)
def test_rms_norm_rope_pack_plain_fp32_matches_jax(h, kvh, d, offset, cast):
    packed, qs, ks, cos, sin = _qk_inputs(h, kvh, d, d)
    got = TR.rms_norm_rope_pack(*map(torch.from_numpy, (packed, qs, ks, cos, sin)),
                                h, kvh, d, 1e-6, offset, cast)
    want = _jax_norm_rope(packed, qs, ks, cos, sin, h, kvh, d, offset, cast, jnp.float32)
    qk = (h + kvh) * d
    np.testing.assert_allclose(got.numpy()[..., :qk], want[..., :qk], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.numpy()[..., qk:], packed[..., qk:])


@pytest.mark.parametrize("h,kvh,d,offset,cast", QK_CASES)
def test_rms_norm_rope_pack_plain_bf16_matches_jax(h, kvh, d, offset, cast):
    """bf16: the normalized head rounded to bf16 before the rotation on both
    sides (JAX's rms_norm returns the activation dtype), the rotation in f32
    and rounded once: within one bf16 ulp; the v lanes bitwise."""
    packed, qs, ks, cos, sin = _qk_inputs(h, kvh, d, d + 1)
    packed, qs, ks = _bf16(packed), _bf16(qs), _bf16(ks)
    got = TR.rms_norm_rope_pack(
        *(torch.from_numpy(a).bfloat16() for a in (packed, qs, ks)),
        torch.from_numpy(cos), torch.from_numpy(sin), h, kvh, d, 1e-6, offset, cast)
    assert got.dtype == torch.bfloat16
    want = _jax_norm_rope(packed, qs, ks, cos, sin, h, kvh, d, offset, cast, jnp.bfloat16)
    qk = (h + kvh) * d
    assert _bf16_ulps(got[..., :qk], want[..., :qk]) <= 1
    np.testing.assert_array_equal(got.float().numpy()[..., qk:], packed[..., qk:])


def test_the_fused_plain_version_is_the_norm_then_the_rotation():
    """rms_norm_rope_pack_plain is rope_pack_plain of rms_norm_heads_plain,
    bitwise: what the kernel's check on the card holds it to."""
    packed, qs, ks, cos, sin = (torch.from_numpy(a) for a in _qk_inputs(8, 2, 64, 3))
    fused = TR.rms_norm_rope_pack_plain(packed, qs, ks, cos, sin, 8, 2, 64)
    two = TR.rope_pack_plain(TN.rms_norm_heads_plain(packed, qs, ks, 8, 2, 64),
                             cos, sin, 10, 64)
    assert torch.equal(fused, two)


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

def _registry_configs():
    """Every model configuration of the port's registries (test configs
    left out), the Qwen3-Omni thinker's and its talker's included."""
    from t2v_metrics_tpu_torch.models import adapters, gemma3, gemma4, instructblip
    from t2v_metrics_tpu_torch.models import internvl, llava, molmo2, paligemma
    from t2v_metrics_tpu_torch.models import qwen2vl, qwen3omni, qwen3vl

    regs = (adapters.CLIP_T5_MODELS, qwen2vl.QWEN2_VL_MODELS, qwen3vl.QWEN3_VL_MODELS,
            gemma3.GEMMA3_MODELS, gemma4.GEMMA4_MODELS, paligemma.PALIGEMMA_MODELS,
            molmo2.MOLMO2_MODELS, internvl.INTERNVL_MODELS, llava.LLAVA_MODELS,
            instructblip.INSTRUCTBLIP_MODELS)
    cfgs = [spec["config"] for reg in regs for name, spec in reg.items()
            if "test" not in name and dataclasses.is_dataclass(spec.get("config"))]
    cfgs += [qwen3omni.resolve_config(n) for n in qwen3omni.QWEN3_OMNI_MODELS if "test" not in n]
    return cfgs + [qwen3omni.resolve_talker_config()]


def _rms_widths():
    """The widths the port's RMSNorms run at, from the configs: every
    decoder's and T5's d_model (the block and final norms), the Qwen2.5
    ViT's hidden (its blocks and the merger's ln_q), InternViT-6B's width
    (blocks and the flattened q / k norm), the Code2Wav transformer's
    hidden_size and Gemma's projector norm at its SigLIP width."""
    from t2v_metrics_tpu_torch.models import decoder, gemma3, internvl, qwen2vl, t5
    from t2v_metrics_tpu_torch.models import qwen3omni_talker as tk

    widths = set()

    def walk(c):
        if isinstance(c, (decoder.DecoderConfig, t5.T5Config)):
            widths.add(c.d_model)
        elif isinstance(c, qwen2vl.QwenVisionConfig):
            widths.add(c.hidden)
        elif isinstance(c, internvl.InternVisionConfig) and c.norm_type == "rms":
            widths.add(c.width)
        elif isinstance(c, tk.Code2WavConfig):
            widths.add(c.hidden_size)
        elif isinstance(c, gemma3.Gemma3Config):
            widths.add(c.vision.width)
        if dataclasses.is_dataclass(c):
            for f in dataclasses.fields(c):
                walk(getattr(c, f.name))

    for cfg in _registry_configs():
        walk(cfg)
    return sorted(widths)


RMS_WIDTHS = _rms_widths()


def test_the_registry_widths_include_the_known_ones():
    assert {896, 1024, 1280, 1536, 2048, 2560, 3200, 3584, 3840, 4096, 5120,
            5376} <= set(RMS_WIDTHS)
    assert max(RMS_WIDTHS) <= TN._MAX_COLS


def _occupancy(vec, nv_cap, block_warps):
    return 16 // block_warps + (nv_cap * vec <= 20)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_layer_norm_plan_covers_every_registry_rms_width(d, dtype):
    """Both CUDA norms run this plan: every column of a row once, no lane
    over its limit, the instantiation one the library has, every row once
    in one wave."""
    size = torch.empty((), dtype=dtype).element_size()
    rows = 2 * SMS * 8 + 3
    plan = TN.layer_norm_plan(rows, d, size, SMS, _occupancy)
    assert d % plan.vec == 0 and plan.nv_cap in TN.LN_NV[size][plan.vec]
    assert plan.nv <= plan.nv_cap and plan.nv * plan.vec <= TN.LN_MAX_PER_LANE
    w = np.arange(plan.warps_per_row)[:, None, None, None]
    lane = np.arange(32)[None, :, None, None]
    i = np.arange(plan.nv_cap)[None, None, :, None]
    k = np.arange(plan.vec)[None, None, None, :]
    q = (w * plan.nv + i) * 32 + lane
    cols = np.where((i < plan.nv) & (q < d // plan.vec), q * plan.vec + k, -1)
    np.testing.assert_array_equal(np.bincount(cols[cols >= 0], minlength=d), np.ones(d, int))
    step = plan.grid * plan.rows_per_block
    covered = (np.arange(plan.grid)[:, None, None] * plan.rows_per_block
               + np.arange(-(-rows // step))[None, :, None] * step
               + np.arange(plan.rows_per_block)[None, None, :]).ravel()
    covered = covered[covered < rows]
    np.testing.assert_array_equal(np.bincount(covered, minlength=rows), np.ones(rows, int))
    assert plan.grid <= SMS * _occupancy(plan.vec, plan.nv_cap, plan.block_warps)


@pytest.mark.parametrize("d,wpr,vec,nv", [
    (3584, 4, 4, 7),     # qwen2.5-vl-7b: 8-byte vectors, no lane idle
    (2048, 2, 8, 4),     # T5-xl, qwen2.5-vl-3b: 16-byte vectors, no lane idle
    (4096, 4, 8, 4),     # T5-xxl
    (1024, 1, 8, 4),     # the talker: one warp a row
    (3840, 4, 2, 15),    # gemma-3-12b: 4-byte vectors, no lane idle
    (3200, 4, 8, 4),     # InternViT-6B: 16-byte vectors, 400 of 512 slots
    (5376, 8, 8, 3),     # gemma-3-27b: 16-byte vectors, 672 of 768 slots
])
def test_the_rms_widths_plans(d, wpr, vec, nv):
    """At the registry's widths the widest vectors: evenly over the lanes
    where a vector of 4 bytes or more does that, else 16 bytes with the
    tail predicated off, never one 2-byte value a load (the Triton kernel's
    power-of-two block masked 12.5% of its lanes at 3584 and 22% at 3200)."""
    plan = TN.layer_norm_plan(4, d, 2, SMS, _occupancy)
    assert (plan.warps_per_row, plan.vec, plan.nv) == (wpr, vec, nv)


ROPE_SITES = [(4, 32, 128), (4, 36, 128), (1, 18, 64), (2, 24, 128), (1184, 18, 64),
              (325, 32, 64), (43008, 40, 128), (20480, 32, 128), (20480, 32, 80),
              (16384, 36, 128), (7, 3, 16)]


@pytest.mark.parametrize("rows,heads,d", ROPE_SITES)
def test_rope_plan_covers_every_row_and_head_once(rows, heads, d):
    p = TR.rope_plan(rows, heads, d, SMS)
    assert p.block_r & (p.block_r - 1) == 0 and 2 <= p.block_r <= TR.ROPE_BLOCK_R
    assert 1 <= p.heads_per_prog <= TR.ROPE_MAX_HEADS
    groups, row_blocks = p.grid
    g = np.arange(groups)[:, None, None, None]
    rb = np.arange(row_blocks)[None, :, None, None]
    j = np.arange(p.heads_per_prog)[None, None, :, None]
    r = np.arange(p.block_r)[None, None, None, :]
    head = np.broadcast_to(g * p.heads_per_prog + j, (groups, row_blocks, p.heads_per_prog,
                                                      p.block_r))
    row = np.broadcast_to(rb * p.block_r + r, head.shape)
    live = (head < heads) & (row < rows)
    cells = row[live] * heads + head[live]
    np.testing.assert_array_equal(np.bincount(cells, minlength=rows * heads),
                                  np.ones(rows * heads, int))
    assert 1 <= p.num_warps <= 4


@pytest.mark.parametrize("rows,heads", [(4, 32), (4, 36), (16, 32), (2, 24), (1, 18)])
def test_a_decode_step_runs_a_program_a_head(rows, heads):
    """A decode step's few rows spread over one program a head, each on its
    own SM, where one program once walked every head."""
    p = TR.rope_plan(rows, heads, 128, SMS)
    assert p.heads_per_prog == 1 and p.grid == (heads, 1)


def test_rope_plan_refuses_what_the_kernel_lacks():
    with pytest.raises(ValueError):
        TR.rope_plan(4, 32, 127, SMS)
    with pytest.raises(ValueError):
        TR.rope_plan(0, 32, 128, SMS)
