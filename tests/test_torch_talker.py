"""Port parity: Qwen3-Omni's talker (t2v_metrics_tpu_torch/models/
qwen3omni_talker.py, the decoder's shared expert and captures, the MoE
dispatch with ``moe_norm_topk`` off, the interleaved M-RoPE repair) against
the JAX package on the CPU, and against Hugging Face's tiny
Qwen3OmniMoe talker / Code2Wav modules where ``transformers`` is installed.

Weights: seeded tensors in HF's layout (``qwen3omni_talker.SeededState``
over ``hf_talker_layout`` / ``hf_code2wav_layout``, whose keys and shapes
are held to HF's state dicts), read by both packages' converters, at the
JAX suite's tiny configs (``tests/test_talker_parity.py``).

Tolerances (fp32): rope 1.2e-7 against JAX (one fp32 ulp of cos / sin near
1; the frequency layout bitwise); the MoE MLP 2e-5 (the MoE suite's bar);
decoder logits and hiddens 1e-5; codec tokens and converted trees exactly;
the waveform 1e-6 against HF and 3e-4 against JAX (the JAX suite's bar
against HF: XLA's fp32 convolutions on the CPU), on waveforms of rms ~0.1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import qwen3omni as jqo  # noqa: E402
from t2v_metrics_tpu.models import qwen3omni_talker as jtk  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni as tqo  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni_talker as ttk  # noqa: E402
from t2v_metrics_tpu_torch.ops import moe as tmoe  # noqa: E402

HID = 1e-5
WAV_HF, WAV_JAX = 1e-6, 3e-4


# ---------------------------------------------------------------------------
# Tiny configs (the JAX suite's) and seeded weights
# ---------------------------------------------------------------------------

def jax_talker_cfg(**over):
    text = dataclasses.replace(
        jdec.DecoderConfig(vocab_size=64, d_model=32, layers=2, heads=4, kv_heads=2,
                           head_dim=8, d_ff=0, rope_theta=10000.0, mrope_section=(2, 1, 1),
                           mrope_interleaved=True, qkv_bias=False, qk_norm=True),
        num_experts=4, experts_per_tok=2, moe_d_ff=16, moe_norm_topk=False, moe_shared_ff=24)
    pred = jdec.DecoderConfig(vocab_size=48, d_model=32, layers=2, heads=4, kv_heads=2,
                              head_dim=8, d_ff=64, rope_theta=10000.0, mrope_section=None,
                              qkv_bias=False, qk_norm=True)
    cfg = dict(text=text, predictor=pred, code2wav=None, num_code_groups=4,
               thinker_hidden_size=40, accept_hidden_layer=1, codec_eos_token_id=60,
               codec_nothink_id=54, codec_think_bos_id=55, codec_think_eos_id=56,
               codec_pad_id=52, codec_bos_id=53, speaker_id=(("ethan", 57),), suppress_band=12)
    return jtk.TalkerConfig(**{**cfg, **over})


def jax_c2w_cfg(num_quantizers=3, codebook=32):
    return jtk.Code2WavConfig(
        codebook_size=codebook, num_quantizers=num_quantizers, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=64, sliding_window=8, rope_theta=10000.0,
        upsampling_ratios=(2,), upsample_rates=(2, 2), decoder_dim=16)


def port_cfg(j):
    """The port's config with the JAX config's values."""
    if isinstance(j, jtk.Code2WavConfig):
        return ttk.Code2WavConfig(**dataclasses.asdict(j))
    d = dataclasses.asdict(j)
    return ttk.TalkerConfig(
        text=tdec.DecoderConfig(**d["text"]), predictor=tdec.DecoderConfig(**d["predictor"]),
        code2wav=None if j.code2wav is None else port_cfg(j.code2wav),
        **{k: v for k, v in d.items() if k not in ("text", "predictor", "code2wav")})


def talker_sd(cfg, seed=0, proj_ff=64):
    return dict(ttk.SeededState(ttk.hf_talker_layout(port_cfg(cfg), proj_ff), seed, "cpu",
                                torch.float32, "talker."))


def c2w_sd(cfg, seed=0):
    return dict(ttk.SeededState(ttk.hf_code2wav_layout(port_cfg(cfg)), seed, "cpu",
                                torch.float32, "code2wav."))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def talker():
    """(JAX config, JAX params, port config, port model) on one seeded HF
    state dict."""
    jcfg = jax_talker_cfg()
    sd = talker_sd(jcfg)
    jp = jtk.convert_talker(sd, jcfg)
    tcfg = port_cfg(jcfg)
    return jcfg, jp, tcfg, bridge.talker_from_numpy(np_tree(jp), tcfg, "cpu", torch.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_talker_configs_equal_jax():
    """``resolve_talker_config`` is the JAX one but for ``moe_dispatch`` (the
    port routes the talker's experts through the grouped GEMM); the
    dataclass defaults are JAX's."""
    t, j = tqo.resolve_talker_config(), jqo.resolve_talker_config()
    got, want = dataclasses.asdict(t), dataclasses.asdict(j)
    assert got["text"].pop("moe_dispatch") is True
    assert want["text"].pop("moe_dispatch") is False
    assert got == want
    assert dataclasses.asdict(ttk.Code2WavConfig()) == dataclasses.asdict(jtk.Code2WavConfig())
    assert ttk.Code2WavConfig().total_upsample == jtk.Code2WavConfig().total_upsample == 480


# ---------------------------------------------------------------------------
# Step 0: the interleaved M-RoPE index repair
# ---------------------------------------------------------------------------

def _layout_cos_sin(head_dim, sections, pos):
    """cos / sin from a frequency table built column by column: stream 1 at
    columns 1, 4, .. and stream 2 at 2, 5, .. while below 3 x their section
    AND the half width, stream 0 elsewhere (JAX's scatter drops the rest)."""
    half = head_dim // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32) / half))
    stream = np.zeros(half, np.int64)
    for dim in (1, 2):
        for c in range(dim, sections[dim] * 3, 3):
            if c < half:
                stream[c] = dim
    p = torch.from_numpy(pos).float()
    freqs = torch.stack([p[stream[c]] * inv[c] for c in range(half)], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


@pytest.mark.parametrize("head_dim,sections", [(64, (24, 20, 20)), (8, (2, 1, 1)),
                                               (128, (24, 20, 20)), (16, (4, 2, 2))],
                         ids=["talker", "tiny-talker", "thinker-30b", "omni-test"])
def test_interleaved_rope_matches_jax(head_dim, sections):
    """The talker's sections reach past the half width (H to 3 x 24 = 72 >
    32): the port sets H/W only below it, as JAX (dropped scatter) and HF
    (a slice) do; it raised IndexError before. Positions whose three streams
    differ."""
    cfg = tdec.DecoderConfig(head_dim=head_dim, mrope_section=sections, mrope_interleaved=True,
                             rope_theta=10000.0)
    jcfg = jdec.DecoderConfig(**dataclasses.asdict(cfg))
    pos = np.random.default_rng(head_dim).integers(0, 900, (3, 2, 11))
    got = tdec.rope_cos_sin(cfg, torch.from_numpy(pos))
    want = jdec.rope_cos_sin(jcfg, jnp.asarray(pos))
    for g, w, e in zip(got, want, _layout_cos_sin(head_dim, sections, pos)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1.2e-7, rtol=0)
        assert torch.equal(g, e)


def test_thinker_rope_unchanged_by_the_repair():
    """Where 3 x each section fits the half width (every Qwen3-VL / Omni
    thinker), the repair changes no value: the unclipped index gives the
    same table."""
    cfg = tdec.DecoderConfig(head_dim=128, mrope_section=(24, 20, 20), mrope_interleaved=True)
    pos = torch.from_numpy(np.random.default_rng(1).integers(0, 5000, (3, 3, 17)))
    half = 64
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32) / half))
    freqs = pos.float()[..., None] * inv
    out = freqs[0].clone()
    for dim, offset in ((1, 1), (2, 2)):
        idx = torch.arange(offset, cfg.mrope_section[dim] * 3, 3)
        out[..., idx] = freqs[dim][..., idx]
    emb = torch.cat([out, out], dim=-1)
    got = tdec.rope_cos_sin(cfg, pos)
    assert torch.equal(got[0], torch.cos(emb)) and torch.equal(got[1], torch.sin(emb))


# ---------------------------------------------------------------------------
# The MoE MLP with the shared expert
# ---------------------------------------------------------------------------

def _moe_pair(shared: bool, norm_topk: bool, seed=0):
    j = dataclasses.replace(
        jdec.DecoderConfig(vocab_size=64, d_model=32, layers=1, heads=4, kv_heads=2,
                           head_dim=8, d_ff=0, mrope_section=None, qkv_bias=False),
        num_experts=6, experts_per_tok=2, moe_d_ff=16, moe_norm_topk=norm_topk,
        moe_shared_ff=24 if shared else 0)
    t = tdec.DecoderConfig(**dataclasses.asdict(j))
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)

    jp = {"router": {"w": w(32, 6)}, "gate_up": w(6, 32, 32), "down": w(6, 16, 32)}
    if shared:
        jp["shared"] = {"gate": {"w": w(32, 24)}, "up": {"w": w(32, 24)},
                        "down": {"w": w(24, 32)}}
        jp["shared_gate"] = {"w": w(32, 1)}
    tp = tdec.Decoder(dataclasses.replace(t, layers=1), "cpu", torch.float32).blocks[0].moe
    with torch.no_grad():
        bridge._leaf(tp.router, jp["router"])
        tp.gate_up.copy_(torch.from_numpy(jp["gate_up"]))
        tp.down.copy_(torch.from_numpy(jp["down"]))
        if shared:
            for name in ("gate", "up", "down"):
                getattr(tp.shared, name).w.copy_(torch.from_numpy(jp["shared"][name]["w"]))
            tp.shared_gate.w.copy_(torch.from_numpy(jp["shared_gate"]["w"]))
    return j, jax.tree.map(jnp.asarray, jp), t, tp


@pytest.mark.parametrize("shared,norm_topk", [(True, False), (True, True), (False, False)],
                         ids=["talker", "shared-renormalised", "no-shared-not-renormalised"])
def test_moe_mlp_and_dispatch_match_jax_dense(shared, norm_topk):
    """The dense ``_moe_mlp`` and ``moe_mlp_dispatch`` (the plain grouped
    matmul on the CPU) against the JAX dense ``_moe_mlp``, the oracle: the
    talker's MoE has a shared expert and does not renormalise its top-k.
    And the shared expert moves the output, and renormalising would."""
    jcfg, jp, tcfg, tp = _moe_pair(shared, norm_topk)
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    want = np.asarray(jdec._moe_mlp(jp, jcfg, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    dense = tdec._moe_mlp(tp, tcfg, xt).numpy()
    disp = tmoe.moe_mlp_dispatch(tp, tcfg, xt, block_m=8).numpy()
    np.testing.assert_allclose(dense, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(disp, want, rtol=2e-5, atol=2e-5)
    other = dataclasses.replace(tcfg, moe_norm_topk=not norm_topk)
    assert np.abs(tmoe.moe_mlp_dispatch(tp, other, xt, block_m=8).numpy() - disp).max() > 1e-3
    if shared:
        jp_ns = {k: v for k, v in jp.items() if k not in ("shared", "shared_gate")}
        assert np.abs(np.asarray(jdec._moe_mlp(jp_ns, jcfg, jnp.asarray(x))) - want).max() > 1e-3


# ---------------------------------------------------------------------------
# The decoder's want_hidden / capture_layer, uncached and cached
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capture", [0, 1, 2])
def test_forward_hidden_and_capture_match_jax(talker, capture):
    """The talker decoder (MoE + shared expert, interleaved M-RoPE) with a
    deepstack residual after layer 0: logits, the post-norm hidden and
    ``hidden_states[capture]`` against JAX, teacher-forced and through the
    cache (a 5-row prefill, then single steps over pad slots)."""
    jcfg, jp, tcfg, tp = talker
    rng = np.random.default_rng(capture)
    b, s, d = 2, 9, tcfg.text.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    ds = [rng.standard_normal((b, s, d)).astype(np.float32)]
    pos = rng.integers(0, 30, (3, b, s))
    mask = np.ones((b, s), bool)
    want = jdec.forward(jp["decoder"], jcfg.text, jnp.asarray(x), jnp.asarray(pos),
                        jnp.asarray(mask), deepstack=[jnp.asarray(ds[0])], want_hidden=True,
                        capture_layer=capture)
    got = tdec.forward(tp.decoder, tcfg.text, torch.from_numpy(x), torch.from_numpy(pos),
                       torch.from_numpy(mask), deepstack=[torch.from_numpy(ds[0])],
                       want_hidden=True, capture_layer=capture)
    assert len(got) == 3
    for g, w in zip(got, [want[0], *want[2:]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=HID, rtol=HID)
    if capture == 0:
        np.testing.assert_array_equal(got[2].numpy(), x)

    # cached: prefill rows [0, 5) of a 12-slot cache, slots 5-6 left as pads,
    # then steps at slots 7, 8
    max_len, n = 12, 5
    jc = jdec.init_cache(jcfg.text, b, max_len, dtype=jnp.float32)
    tc = tdec.init_cache(tcfg.text, b, max_len, dtype=torch.float32)
    valid = np.zeros((b, max_len), bool)
    valid[:, :n] = True
    chunks = [(0, slice(0, n), True)] + [(7 + i, slice(n + i, n + i + 1), False) for i in range(2)]
    for cpos, rows, first in chunks:
        valid[:, cpos:cpos + rows.stop - rows.start] = True
        jds = [jnp.asarray(ds[0][:, rows])] if first else None
        tds = [torch.from_numpy(ds[0][:, rows])] if first else None
        want = jdec.forward(jp["decoder"], jcfg.text, jnp.asarray(x[:, rows]),
                            jnp.asarray(pos[:, :, rows]), jnp.asarray(valid), cache=jc,
                            cache_pos=cpos, deepstack=jds, want_hidden=True,
                            capture_layer=capture)
        jc = want[1]
        got = tdec.forward(tp.decoder, tcfg.text, torch.from_numpy(x[:, rows]),
                           torch.from_numpy(pos[:, :, rows]), torch.from_numpy(valid),
                           cache=tc, cache_pos=cpos, deepstack=tds, want_hidden=True,
                           capture_layer=capture)
        assert len(got) == 4 and got[1] is tc
        for g, w in zip([got[0], got[2], got[3]], [want[0], want[2], want[3]]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=HID, rtol=HID)


def test_forward_returns_logits_alone_without_extras(talker):
    _, _, tcfg, tp = talker
    x = torch.randn(1, 4, tcfg.text.d_model, generator=torch.Generator().manual_seed(0))
    out = tdec.forward(tp.decoder, tcfg.text, x, torch.zeros(3, 1, 4, dtype=torch.long))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 4, tcfg.text.vocab_size)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _assert_same_tree(got, want, path="tree"):
    """The same nesting (dicts, lists, ``_LazyLayers``) and equal leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_port_converters_give_the_jax_trees():
    """The port's ``convert_talker`` (layers converted as read) and
    ``convert_code2wav`` give the JAX converters' trees, leaf for leaf, and
    the bridge makes the same modules from either."""
    jcfg, ccfg = jax_talker_cfg(), jax_c2w_cfg()
    sd, csd = talker_sd(jcfg, 3), c2w_sd(ccfg, 3)
    pairs = [(ttk.convert_talker(sd, port_cfg(jcfg)), jtk.convert_talker(sd, jcfg)),
             (ttk.convert_code2wav(csd, port_cfg(ccfg)), jtk.convert_code2wav(csd, ccfg))]
    for got, want in pairs:
        _assert_same_tree(got, want)
    a = bridge.talker_from_numpy(ttk.convert_talker(sd, port_cfg(jcfg)), port_cfg(jcfg),
                                 "cpu", torch.float32)
    b = bridge.talker_from_numpy(np_tree(jtk.convert_talker(sd, jcfg)), port_cfg(jcfg),
                                 "cpu", torch.float32)
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na


def test_init_talker_is_seeded_and_lazy():
    """``init_talker`` draws each tensor from the seed and its key: the same
    seed gives the same model, another seed another; a layer is converted
    only when it is read."""
    cfg = port_cfg(jax_talker_cfg())
    a, b = (ttk.init_talker(cfg, 7, "cpu", proj_ff=64) for _ in range(2))
    c = ttk.init_talker(cfg, 8, "cpu", proj_ff=64)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not torch.equal(a.decoder.blocks[1].moe.gate_up, c.decoder.blocks[1].moe.gate_up)
    seen = []
    sd = ttk.SeededState(ttk.hf_talker_layout(cfg, 64), 0, "cpu", torch.float32, "talker.")

    class Spy(dict):
        def __getitem__(self, k):
            seen.append(k)
            return sd[k]

    tree = ttk.convert_talker(Spy(), cfg)
    assert not any(".experts." in k for k in seen)
    tree["decoder"]["blocks"][1]
    assert any(k.startswith("talker.model.layers.1.mlp.experts.") for k in seen)
    assert not any(k.startswith("talker.model.layers.0.mlp.experts.") for k in seen)


def test_hf_layouts_equal_hf_state_dicts():
    """``hf_talker_layout`` / ``hf_code2wav_layout`` name every tensor of HF's
    tiny talker and Code2Wav (keys and shapes), and nothing else."""
    C = pytest.importorskip("transformers.models.qwen3_omni_moe.configuration_qwen3_omni_moe")
    from test_talker_parity import _tiny_c2w_cfgs, _tiny_talker

    hf, jcfg, _ = _tiny_talker()
    sd = hf.state_dict()
    lay = ttk.hf_talker_layout(port_cfg(jcfg), hf.config.text_config.intermediate_size)
    assert set(lay) == set(sd)
    assert all(tuple(sd[k].shape) == lay[k][0] for k in lay)
    hf_cfg, ccfg = _tiny_c2w_cfgs()
    from transformers.models.qwen3_omni_moe.modeling_qwen3_omni_moe import Qwen3OmniMoeCode2Wav

    csd = Qwen3OmniMoeCode2Wav(hf_cfg).state_dict()
    lay = ttk.hf_code2wav_layout(port_cfg(ccfg))
    assert set(lay) == set(csd)
    assert all(tuple(csd[k].shape) == lay[k][0] for k in lay)
    assert C.Qwen3OmniMoeCode2WavConfig().num_quantizers == 16


# ---------------------------------------------------------------------------
# Code2Wav
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def c2w():
    ccfg = jax_c2w_cfg()
    sd = c2w_sd(ccfg, 1)
    jp = jtk.convert_code2wav(sd, ccfg)
    tcfg = port_cfg(ccfg)
    return ccfg, jp, tcfg, bridge.code2wav_from_numpy(np_tree(jp), tcfg, "cpu", torch.float32), sd


def flip_transposed_kernels(tree):
    """The JAX Code2Wav tree with every transposed convolution's kernel
    reversed in time: what the JAX ``_causal_trans_conv1d`` (``lax.
    conv_transpose`` without ``transpose_kernel``) needs to compute HF's
    ``ConvTranspose1d``."""
    out = dict(tree)
    for key in ("upsample", "dec_blocks"):
        out[key] = [dict(u, tconv=dict(u["tconv"], w=u["tconv"]["w"][..., ::-1]))
                    for u in tree[key]]
    return out


def test_code2wav_matches_jax(c2w):
    """One decode of 12 frames (the 8-slot window bites) and a chunked one of
    23 frames in chunks of 10 with 3 of context, against JAX on the tree
    with its transposed kernels reversed (3e-4; the port computes HF's
    ConvTranspose1d, see ``test_quirk_transposed_conv_kernel``)."""
    ccfg, jp, tcfg, tp, _ = c2w
    jp = flip_transposed_kernels(jp)
    codes = np.random.default_rng(0).integers(0, 32, (1, 3, 12))
    got = ttk.code2wav(tp, tcfg, codes).numpy()
    want = np.asarray(jtk.code2wav(jp, ccfg, jnp.asarray(codes)))
    assert got.shape == want.shape and 0.05 < float(np.sqrt((got ** 2).mean())) < 0.9
    np.testing.assert_allclose(got, want, atol=WAV_JAX, rtol=0)
    codes = np.random.default_rng(1).integers(0, 32, (1, 3, 23))
    got = ttk.chunked_decode(tp, tcfg, codes, chunk_size=10, left_context_size=3)
    want = jtk.chunked_decode(jp, ccfg, codes, chunk_size=10, left_context_size=3)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=WAV_JAX, rtol=0)


def test_quirk_transposed_conv_kernel(c2w):
    """The JAX ``_causal_trans_conv1d`` runs ``lax.conv_transpose`` on HF's
    (C_in, C_out, K) weight without reversing its kernel, so it is not HF's
    ``ConvTranspose1d``; its parity test against HF passes only because HF's
    default init gives a ~5e-5 waveform under its 3e-4 bar. The port
    computes HF's function: on weights that give a waveform of rms ~0.3 the
    JAX package lands far from it, and on the reversed kernels within 3e-4."""
    ccfg, jp, tcfg, tp, _ = c2w
    codes = np.random.default_rng(0).integers(0, 32, (1, 3, 12))
    got = ttk.code2wav(tp, tcfg, codes).numpy()
    off = np.asarray(jtk.code2wav(jp, ccfg, jnp.asarray(codes)))
    assert np.abs(got - off).max() > 0.1
    x = np.random.default_rng(1).standard_normal((1, 3, 6)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((3, 2, 4)).astype(np.float32)
    b = np.zeros(2, np.float32)
    port = ttk._causal_trans_conv1d(*map(torch.from_numpy, (x, w, b)), 2).numpy()
    flipped = np.asarray(jtk._causal_trans_conv1d(jnp.asarray(x), jnp.asarray(w[..., ::-1]),
                                                  jnp.asarray(b), 2))
    np.testing.assert_allclose(port, flipped, atol=1e-6, rtol=0)
    hf = torch.nn.ConvTranspose1d(3, 2, 4, stride=2)
    with torch.no_grad():
        hf.weight.copy_(torch.from_numpy(w))
        hf.bias.zero_()
        np.testing.assert_allclose(port, hf(torch.from_numpy(x)).numpy()[..., 2:-2], atol=1e-6,
                                   rtol=0)


def test_code2wav_matches_hf(c2w):
    """The same weights in HF's Qwen3OmniMoeCode2Wav: ``forward`` and
    ``chunked_decode`` within 1e-6."""
    M = pytest.importorskip("transformers.models.qwen3_omni_moe.modeling_qwen3_omni_moe")
    from test_talker_parity import _tiny_c2w_cfgs

    _, _, tcfg, tp, sd = c2w
    hf = M.Qwen3OmniMoeCode2Wav(_tiny_c2w_cfgs()[0]).eval()
    hf.load_state_dict({k[len("code2wav."):]: v for k, v in sd.items()})
    codes = np.random.default_rng(2).integers(0, 32, (2, 3, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(codes)).numpy()
        want_c = hf.chunked_decode(torch.from_numpy(codes), chunk_size=5,
                                   left_context_size=2).numpy()
    np.testing.assert_allclose(ttk.code2wav(tp, tcfg, codes).numpy(), want, atol=WAV_HF, rtol=0)
    np.testing.assert_allclose(ttk.chunked_decode(tp, tcfg, codes, chunk_size=5,
                                                  left_context_size=2),
                               want_c, atol=WAV_HF, rtol=0)


# ---------------------------------------------------------------------------
# The talker and the code predictor
# ---------------------------------------------------------------------------

def test_talker_and_predictor_match_hf():
    """HF's tiny talker (HF's own random init): the talker decoder and codec
    head teacher-forced, dense and through the dispatch, and the code
    predictor's prefill and one cached step with the per-group embedding
    and head (mirroring the JAX suite's HF checks), within 3e-5."""
    pytest.importorskip("transformers")
    from test_talker_parity import _tiny_talker

    hf, jcfg, _ = _tiny_talker()
    cfg = port_cfg(jcfg)
    sd = {f"talker.{k}": v for k, v in hf.state_dict().items()}
    tp = bridge.talker_from_numpy(ttk.convert_talker(sd, cfg), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    s = 7
    x = torch.from_numpy(rng.standard_normal((1, s, 32)).astype(np.float32))
    pos3 = torch.arange(s).view(1, 1, -1).expand(3, 1, -1)
    with torch.no_grad():
        want = hf.codec_head(hf.model(inputs_embeds=x, position_ids=pos3).last_hidden_state)
        for text in (cfg.text, dataclasses.replace(cfg.text, moe_dispatch=True)):
            got = tdec.forward(tp.decoder, text, x, pos3, torch.ones(1, s, dtype=torch.bool))
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-4)
        pair = torch.from_numpy(rng.standard_normal((1, 2, 32)).astype(np.float32))
        ref0 = hf.code_predictor(inputs_embeds=pair).logits.numpy()
        tok = 7
        ref1 = hf.code_predictor(inputs_embeds=torch.cat(
            [pair, hf.code_predictor.model.codec_embedding[0](torch.tensor([[tok]]))],
            dim=1)).logits.numpy()[:, -1]
    sess = ttk.TalkerSession(cfg, tp)
    cache = tdec.init_cache(cfg.predictor, 1, 4, dtype=torch.float32)
    valid = torch.zeros((1, 4), dtype=torch.bool)
    valid[0, :2] = True
    with torch.no_grad():
        lg0, cache = sess.predictor_prefill(pair, valid, cache)
        emb = tp.predictor.group_embeds[0][torch.tensor([[tok]])]
        lg1, _ = sess.predictor_step(emb, 1, valid, cache)
    np.testing.assert_allclose(lg0.numpy(), ref0[0, -1], atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(lg1.numpy(), ref1[0], atol=3e-5, rtol=1e-4)


def _speech_inputs(cfg_over=None):
    """The JAX suite's crafted thinker sequence: system, user (two
    multimodal rows) and assistant turns."""
    over = dict(im_start_token_id=40, system_token_id=41, user_token_id=42,
                assistant_token_id=43, tts_bos_token_id=10, tts_eos_token_id=11,
                tts_pad_token_id=12, **(cfg_over or {}))
    rng = np.random.default_rng(0)
    ids = np.array([40, 41, 5, 6, 40, 42, 7, 8, 9, 40, 43, 3, 14, 15, 16, 17])
    t = len(ids)
    te = rng.standard_normal((1, t, 40)).astype(np.float32)
    th = rng.standard_normal((1, t, 40)).astype(np.float32)
    mm = np.zeros(t, bool)
    mm[6:8] = True
    table = rng.standard_normal((64, 40)).astype(np.float32)
    return over, (ids, te, th, mm, table)


def test_build_talker_inputs_and_codes_match_jax(talker):
    """``build_talker_inputs`` (1e-6) and ``generate_codes`` against JAX:
    greedy and sampled from one numpy seed, token for token, on the dense
    MoE and through the dispatch."""
    jcfg, jp, tcfg, tp = talker
    over, (ids, te, th, mm, table) = _speech_inputs()
    jcfg, tcfg = dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)
    want = jtk.build_talker_inputs(jcfg, jp, ids, jnp.asarray(te), jnp.asarray(th), mm,
                                   jnp.asarray(table), "Ethan", 13)
    with torch.no_grad():
        got = ttk.build_talker_inputs(tcfg, tp, ids, torch.from_numpy(te), torch.from_numpy(th),
                                      mm, torch.from_numpy(table), "Ethan", 13)
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    e, _, tr, pad = want
    pos = np.broadcast_to(np.arange(e.shape[1])[None, None], (3, 1, e.shape[1])).copy()
    for kw in (dict(do_sample=False, predictor_do_sample=False), dict(seed=3), dict(seed=4)):
        seed = kw.pop("seed", None)
        jc = jtk.TalkerSession(jcfg, jp).generate_codes(
            e, jnp.asarray(pos), tr, pad, max_new_tokens=6,
            rng=None if seed is None else np.random.default_rng(seed), **kw)
        for text in (tcfg.text, dataclasses.replace(tcfg.text, moe_dispatch=True)):
            tc = ttk.TalkerSession(dataclasses.replace(tcfg, text=text), tp).generate_codes(
                got[0], pos, got[2], got[3], max_new_tokens=6,
                rng=None if seed is None else np.random.default_rng(seed), **kw)
            np.testing.assert_array_equal(tc, jc)
            assert tc.shape[0] == 4 and tc.shape[1] >= 1


def test_sample_logits_equals_jax():
    """The copied sampler draws the JAX one's tokens from one seed, over the
    repetition penalty, suppression, temperature, top-k and top-p."""
    rng = np.random.default_rng(0)
    for i in range(20):
        lg = (rng.standard_normal(64) * 3).astype(np.float32)
        kw = dict(do_sample=i % 4 != 0, top_k=[50, 5, 0, 64][i % 4],
                  top_p=[1.0, 0.8, 0.5, 0.95][i % 3], temperature=[1.0, 0.9, 1.3][i % 3],
                  prev_ids=list(rng.integers(0, 64, i % 5)), repetition_penalty=1.05,
                  suppress=list(range(52, 64)) if i % 2 else ())
        assert (ttk.sample_logits(lg, np.random.default_rng(i), **kw)
                == jtk.sample_logits(lg, np.random.default_rng(i), **kw))


# ---------------------------------------------------------------------------
# The reference's quirks: the JAX behaviour beside the port's
# ---------------------------------------------------------------------------

def test_quirk_codebook_count_mismatch(c2w):
    """The default TalkerConfig has 32 code groups and Code2Wav 16
    quantizers (JAX's and HF's defaults, kept). Codes of the wrong group
    count: JAX fails to broadcast ``codes + offset``, HF raises, the port
    raises a ValueError naming the count."""
    assert jtk.TalkerConfig(None, None, None).num_code_groups == 32
    assert ttk.TalkerConfig(None, None, None).num_code_groups == 32
    assert ttk.Code2WavConfig().num_quantizers == jtk.Code2WavConfig().num_quantizers == 16
    ccfg, jp, tcfg, tp, _ = c2w
    codes = np.zeros((1, 4, 6), np.int64)           # 4 groups against 3 quantizers
    with pytest.raises((TypeError, ValueError)):
        jtk.code2wav(jp, ccfg, jnp.asarray(codes))
    with pytest.raises(ValueError, match="num_quantizers 3"):
        ttk.code2wav(tp, tcfg, codes)
    with pytest.raises(ValueError, match="num_quantizers 3"):
        ttk.chunked_decode(tp, tcfg, codes)


def test_quirk_codec_ids_past_the_table(talker, c2w):
    """The default codec special ids (4196-4205) lie past the 3072-row codec
    table; the JAX gathers clamp such an id to the last row without a word,
    the port raises a ValueError naming the id and the table. Here: a
    64-row table and a pad id of 70, and a code of 32 against a codebook of
    32."""
    jcfg, jp, tcfg, tp = talker
    assert min(dict(jtk.TalkerConfig(None, None, None).speaker_id).values()) > 3072
    over, (ids, te, th, mm, table) = _speech_inputs(dict(codec_pad_id=70))
    jcfg, tcfg = dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)
    e = jtk.build_talker_inputs(jcfg, jp, ids, jnp.asarray(te), jnp.asarray(th), mm,
                                jnp.asarray(table), "Ethan", 13)[0]
    clamped = jtk.build_talker_inputs(dataclasses.replace(jcfg, codec_pad_id=63), jp, ids,
                                      jnp.asarray(te), jnp.asarray(th), mm,
                                      jnp.asarray(table), "Ethan", 13)[0]
    np.testing.assert_array_equal(np.asarray(e), np.asarray(clamped))   # row 63 = the last
    with pytest.raises(ValueError, match="id 70 is outside the table of 64 rows"):
        ttk.build_talker_inputs(tcfg, tp, ids, torch.from_numpy(te), torch.from_numpy(th), mm,
                                torch.from_numpy(table), "Ethan", 13)
    ccfg, cjp, ctcfg, ctp, _ = c2w
    codes = np.zeros((1, 3, 5), np.int64)
    codes[0, 2, 4] = 32
    assert np.isfinite(np.asarray(jtk.code2wav(cjp, ccfg, jnp.asarray(codes)))).all()
    with pytest.raises(ValueError, match="codec id 32 is outside the codebook of 32"):
        ttk.code2wav(ctp, ctcfg, codes)


def test_quirk_upsample_rates():
    """JAX's Code2WavConfig upsamples (5, 4, 3, 2) x (2, 2) = 480 samples a
    frame; HF's default is (8, 5, 4, 3), 1920 (12.5 frames/s at 24 kHz).
    The port keeps JAX's default; a caller sets HF's."""
    assert jtk.Code2WavConfig().total_upsample == ttk.Code2WavConfig().total_upsample
    assert int(np.prod((5, 4, 3, 2, 2, 2))) == 480 != 1920
    C = pytest.importorskip("transformers.models.qwen3_omni_moe.configuration_qwen3_omni_moe")
    hf = C.Qwen3OmniMoeCode2WavConfig()
    assert tuple(hf.upsample_rates) == (8, 5, 4, 3)
    assert dataclasses.replace(ttk.Code2WavConfig(),
                               upsample_rates=tuple(hf.upsample_rates)).total_upsample == 1920
