"""Port parity: KV-cached generation — the decoder's cached path, T5's decode
step and greedy decode, ``CachedLM`` and the pure-Python rollout helpers —
against the JAX package on the same parameters (carried over by
``bridge.py``) and the same seeded numpy inputs, on the CPU in fp32.

Tolerances: cached-decode logits within 1e-5 relative (to the largest
|logit| of the step; the two CPU BLAS libraries sum in different orders);
greedy tokens and lengths equal; distributions and gathered probabilities
within 1e-5; the pure-Python helpers identical. The decoder cases put rows
of different prompt lengths in one batch, so that pad slots sit between a
short row's prompt and its first generated token, and at ``gemma-3-test``
the window of 8 bites over 16 + 6 cache slots beside an image block.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from t2v_metrics_tpu.models import decoder as jdec  # noqa: E402
from t2v_metrics_tpu.models import gemma3 as jg3  # noqa: E402
from t2v_metrics_tpu.models import generation as jgen  # noqa: E402
from t2v_metrics_tpu.models import qwen2vl as jq  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.models import t5 as jt5  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.models import decoder as tdec  # noqa: E402
from t2v_metrics_tpu_torch.models import gemma3 as tg3  # noqa: E402
from t2v_metrics_tpu_torch.models import generation as tgen  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402
from t2v_metrics_tpu_torch.ops import launch_counts  # noqa: E402

RTOL = 1e-5
DECODERS = ("qwen2.5-vl-test", "qwen3-vl-test", "qwen3-vl-moe-test", "gemma-3-test")
_MODELS = {}


def _decoder(name, dispatch=False):
    """(JAX decoder params, JAX config, port decoder, port config, embed
    scale) of a test model's language model, made once."""
    key = (name, dispatch)
    if key not in _MODELS:
        if name == "gemma-3-test":
            jcfg = jg3.GEMMA3_MODELS[name]["config"]
            jp = jg3.init_gemma3(jax.random.PRNGKey(0), jcfg)
            rng = np.random.default_rng(0)
            leaves, treedef = jax.tree.flatten(jp)
            # matrices x2 and the Gemma norm scales (zero at init) drawn away
            # from zero, as the Gemma image tests
            leaves = [np.asarray(x) * np.float32(2.0) if np.ndim(x) >= 2
                      else (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32)
                      for x in leaves]
            jp = jax.tree.unflatten(treedef, leaves)
            model = bridge.gemma3_from_numpy(jp, tg3.GEMMA3_MODELS[name]["config"], "cpu",
                                             torch.float32)
            scale = jcfg.text.d_model ** 0.5
        else:
            qwen2 = name.startswith("qwen2.5")
            jcfg = (jq.QWEN2_VL_MODELS[name]["config"] if qwen2 else jq3.resolve_config(name))
            tcfg = (tq.QWEN2_VL_MODELS[name]["config"] if qwen2 else tq3.resolve_config(name))
            if dispatch:
                tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
                    tcfg.text, moe_dispatch=True))
            init = jq.init_qwen2vl if qwen2 else jq3.init_qwen3vl
            leaves, treedef = jax.tree.flatten(init(jax.random.PRNGKey(0), jcfg))
            # matrices x3: wider logits than the near-uniform random init
            leaves = [np.asarray(x) * np.float32(3.0) if np.ndim(x) == 2 else np.asarray(x)
                      for x in leaves]
            jp = jax.tree.unflatten(treedef, leaves)
            model = (bridge.qwen2vl_from_numpy if qwen2 else bridge.qwen3vl_from_numpy)(
                jp, tcfg, "cpu", torch.float32)
            scale = None
        _MODELS[key] = (jp["decoder"], jcfg.text, model.decoder,
                        _text_cfg(name, dispatch), scale)
    return _MODELS[key]


def _text_cfg(name, dispatch=False):
    if name == "gemma-3-test":
        return tg3.GEMMA3_MODELS[name]["config"].text
    cfg = (tq.QWEN2_VL_MODELS[name]["config"] if name.startswith("qwen2.5")
           else tq3.resolve_config(name)).text
    return dataclasses.replace(cfg, moe_dispatch=True) if dispatch else cfg


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _prompts(cfg, b=2, s=16, k=6, lengths=(16, 11), seed=1):
    """Seeded prompt embeddings (B, S, D), the K embeddings fed at the steps
    (B, K, D), rope positions (B, S) or (3, B, S) (M-RoPE: the h and w
    streams differ from t over the prompt), and each row's prompt length."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    embeds = rng.normal(size=(b, s, d)).astype(np.float32)
    steps = rng.normal(size=(b, k, d)).astype(np.float32)
    if cfg.mrope_section is not None:
        pos = np.stack([np.broadcast_to(np.arange(s), (b, s)),
                        np.broadcast_to(np.arange(s) // 2, (b, s)),
                        np.broadcast_to(np.arange(s) % 5, (b, s))]).astype(np.int64)
    else:
        pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int64).copy()
    return embeds, steps, pos, np.asarray(lengths)


def _step_pos(pos, lengths, i):
    """Rope position of step i (0-based): one past the last prompt token's
    largest stream, as CachedLM gives it."""
    b = len(lengths)
    last = (pos[np.arange(b), lengths - 1] if pos.ndim == 2
            else pos[:, np.arange(b), lengths - 1].max(axis=0))
    p = (last + 1 + i)[:, None].astype(np.int64)
    return p if pos.ndim == 2 else np.broadcast_to(p[None], (3, b, 1)).copy()


@pytest.mark.parametrize("name,dispatch", [(n, False) for n in DECODERS]
                         + [("qwen3-vl-moe-test", True)])
def test_cached_decoder_matches_jax(name, dispatch):
    """Prefill + 6 single-token steps through the cache, each step's logits
    against JAX ``dec.forward(cache=...)``; then the port's cached logits
    against its own teacher-forced forward over the same slots."""
    jp, jcfg, tp, tcfg, _ = _decoder(name, dispatch)
    b, s, k = 2, 16, 6
    max_len = s + k
    embeds, steps, pos, lengths = _prompts(jcfg, b, s, k)
    valid = np.zeros((b, max_len), bool)
    for j, n in enumerate(lengths):
        valid[j, :n] = True
    bidir = deepstack = None
    if name == "gemma-3-test":
        bidir = np.full((b, max_len), -1, np.int32)
        bidir[:, 2:7] = 0                                # an image block in the prompt
    if name.startswith("qwen3"):
        rng = np.random.default_rng(2)
        deepstack = [rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
                     * (np.arange(s) < 9)[None, :, None] for _ in range(2)]

    jcache = jdec.init_cache(jcfg, b, max_len, jnp.float32)
    want, jcache = jdec.forward(jp, jcfg, jnp.asarray(embeds), jnp.asarray(pos),
                                jnp.asarray(valid), cache=jcache, cache_pos=0,
                                bidir_ids=None if bidir is None else jnp.asarray(bidir),
                                deepstack=None if deepstack is None
                                else [jnp.asarray(x) for x in deepstack])
    tcache = tdec.init_cache(tcfg, b, max_len, torch.float32)
    before = launch_counts()
    with torch.inference_mode():
        got, tcache = tdec.forward(
            tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(pos),
            torch.from_numpy(valid), cache=tcache, cache_pos=0,
            bidir_ids=None if bidir is None else torch.from_numpy(bidir),
            deepstack=None if deepstack is None else [torch.from_numpy(x) for x in deepstack])
    _close(got.numpy(), want)
    cached = [got.numpy()]
    for i in range(k):
        cpos = s + i
        valid[:, cpos] = True
        p1 = _step_pos(pos, lengths, i)
        want, jcache = jdec.forward(jp, jcfg, jnp.asarray(steps[:, i:i + 1]),
                                    jnp.asarray(p1), jnp.asarray(valid), cache=jcache,
                                    cache_pos=cpos,
                                    bidir_ids=None if bidir is None else jnp.asarray(bidir))
        with torch.inference_mode():
            got, tcache = tdec.forward(
                tp, tcfg, torch.from_numpy(steps[:, i:i + 1]), torch.from_numpy(p1),
                torch.from_numpy(valid), cache=tcache, cache_pos=cpos,
                bidir_ids=None if bidir is None else torch.from_numpy(bidir))
        _close(got.numpy(), want)
        cached.append(got.numpy())
    assert launch_counts() == before                 # the CPU runs no kernel
    # the k / v written in place at every slot of the prefill and the steps
    for layer, jl in zip(tcache, jcache):
        _close(layer["k"].numpy(), jl["k"])
        _close(layer["v"].numpy(), jl["v"])

    # the same slots teacher-forced in one pass: prompt pads stay invalid, the
    # generated rows sit at slots S.., their rope positions run on
    seq = np.concatenate([embeds, steps], axis=1)
    steps_pos = np.concatenate([_step_pos(pos, lengths, i) for i in range(k)], axis=-1)
    seq_pos = np.concatenate([pos, steps_pos], axis=-1)
    ds = None if deepstack is None else [torch.from_numpy(np.concatenate(
        [x, np.zeros_like(steps)], axis=1)) for x in deepstack]
    with torch.inference_mode():
        tf = tdec.forward(tp, tcfg, torch.from_numpy(seq), torch.from_numpy(seq_pos),
                          torch.from_numpy(valid), deepstack=ds,
                          bidir_ids=None if bidir is None else torch.from_numpy(bidir))
    _close(np.concatenate(cached, axis=1), tf.numpy())


def test_cached_decoder_overlay_past_the_prefill():
    """Past the prefill the overlay must be inert: a live group on a chunk's
    rows, or a device-side id array there (which the host cannot check),
    raises rather than being dropped."""
    _, jcfg, tp, tcfg, _ = _decoder("gemma-3-test")
    b, s = 1, 8
    cache = tdec.init_cache(tcfg, b, s + 2, torch.float32)
    embeds = torch.zeros((b, 1, tcfg.d_model))
    valid = torch.ones((b, s + 2), dtype=torch.bool)
    bidir = torch.full((b, s + 2), -1, dtype=torch.int32)
    bidir[0, s] = 0
    with torch.inference_mode(), pytest.raises(NotImplementedError, match="overlay"):
        tdec.forward(tp, tcfg, embeds, torch.full((b, 1), s), valid, cache=cache,
                     cache_pos=s, bidir_ids=bidir)
    meta = torch.full((b, s + 2), -1, dtype=torch.int32, device="meta")
    with torch.inference_mode(), pytest.raises(ValueError, match="host array"):
        tdec.forward(tp, tcfg, embeds, torch.full((b, 1), s), valid, cache=cache,
                     cache_pos=s, bidir_ids=meta)
    with pytest.raises(ValueError, match="validity mask"):
        tdec.forward(tp, tcfg, embeds, torch.full((b, 1), s), cache=cache, cache_pos=s)


# ---------------------------------------------------------------------------
# T5: the decode step and greedy decode
# ---------------------------------------------------------------------------

T5_VARIANTS = [{}, dict(gated=False, act="relu", tie_word_embeddings=True)]


def _t5(variant):
    fields = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_heads=4,
                  enc_layers=2, dec_layers=2, **variant)
    jcfg, tcfg = jt5.T5Config(**fields), tt5.T5Config(**fields)
    jp = jax.tree.map(lambda x: np.asarray(x) * np.float32(2.0),
                      jt5.init_t5(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(3, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([[40], [33], [12]])
    return jp, jcfg, bridge.t5_from_numpy(jp, tcfg, "cpu", torch.float32), tcfg, enc, mask


@pytest.mark.parametrize("inkernel", [False, True], ids=["dense", "inkernel"])
@pytest.mark.parametrize("variant", T5_VARIANTS, ids=["gated", "relu-tied"])
def test_t5_decode_step_matches_jax(variant, inkernel, monkeypatch):
    """decode_step over 6 steps (fed the same seeded tokens) against JAX's:
    logits and the self-attention cache; the bias row is offset to the
    cache slot (dense in the flat attention, or in the per-head one)."""
    jp, jcfg, tp, tcfg, enc, mask = _t5(variant)
    monkeypatch.setattr(tt5, "INKERNEL_REL_BIAS", inkernel)
    k = 6
    toks = np.random.default_rng(7).integers(0, 300, (3, k))
    toks[:, 0] = jcfg.decoder_start_token_id
    jckv = jt5.cross_kv(jp, jcfg, jnp.asarray(enc))
    jcache = jt5.init_dec_cache(jp, jcfg, 3, k + 2)
    with torch.inference_mode():
        tckv = tt5.cross_kv(tp, tcfg, torch.from_numpy(enc))
        tcache = tt5.init_dec_cache(tp, tcfg, 3, k + 2)
        for step in range(k):
            want, jcache = jt5.decode_step(jp, jcfg, jnp.asarray(toks[:, step:step + 1]),
                                           jcache, step, jckv, jnp.asarray(mask))
            got, tcache = tt5.decode_step(tp, tcfg, torch.from_numpy(toks[:, step:step + 1]),
                                          tcache, step, tckv, torch.from_numpy(mask))
            assert got.shape == (3, 300) and got.dtype == torch.float32
            _close(got.numpy(), want)
    for layer, jl in zip(tcache, jcache):
        _close(layer["k"].numpy(), jl["k"])
        _close(layer["v"].numpy(), jl["v"])


@pytest.mark.parametrize("variant", T5_VARIANTS, ids=["gated", "relu-tied"])
def test_t5_greedy_decode_matches_jax(variant):
    """Tokens equal, pad after EOS and EOS never emitted; with the EOS id
    set to a token the rollout meets, so rows stop at different steps."""
    jp, jcfg, tp, tcfg, enc, mask = _t5(variant)
    jp = jax.tree.map(jnp.asarray, jp)
    free = np.asarray(jt5.greedy_decode(jp, jcfg, jnp.asarray(enc), jnp.asarray(mask), 8))
    eos = int(free[1, 2])                            # met by row 1 at step 2
    want = np.asarray(jt5.greedy_decode(jp, jcfg, jnp.asarray(enc), jnp.asarray(mask),
                                        8, eos_id=eos))
    got = tt5.greedy_decode(tp, tcfg, torch.from_numpy(enc), torch.from_numpy(mask), 8,
                            eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == eos).any() and (got[1, 2:] == 0).all()
    assert len(np.unique(free)) > 2                  # the rollout is not one token


# ---------------------------------------------------------------------------
# CachedLM
# ---------------------------------------------------------------------------

def _lm_inputs(name, b=3, s=16, lengths=(16, 11, 13), max_new=6):
    jp, jcfg, tp, tcfg, scale = _decoder(name)
    embeds, _, pos, lengths = _prompts(jcfg, b, s, 1, lengths)
    bidir = None
    if name == "gemma-3-test":
        bidir = np.full((b, s + max_new), -1, np.int32)
        bidir[:, 3:9] = 0
    return jp, jcfg, tp, tcfg, scale, embeds, pos, lengths, bidir


@pytest.mark.parametrize("name", ["qwen2.5-vl-test", "qwen3-vl-moe-test", "gemma-3-test"])
def test_greedy_batch_matches_jax(name):
    """Tokens, lengths and the gathered probabilities at every step equal
    JAX's; the eos id is one the rollout meets, so one row stops early and
    repeats it."""
    jp, jcfg, tp, tcfg, scale, embeds, pos, lengths, bidir = _lm_inputs(name)
    jlm, tlm = jgen.CachedLM(jcfg, embed_scale=scale), tgen.CachedLM(tcfg, embed_scale=scale)
    free, _ = jlm.greedy_batch(jp, jnp.asarray(embeds), pos, lengths, 6, bidir_full=bidir)
    eos = int(free[0, 2])
    gather = np.stack([np.arange(4) * 7 + j for j in range(3)])
    want = jlm.greedy_batch(jp, jnp.asarray(embeds), pos, lengths, 6, eos_id=eos,
                            bidir_full=bidir, gather_ids=gather, temperature=0.7)
    got = tlm.greedy_batch(tp, torch.from_numpy(embeds), pos, lengths, 6, eos_id=eos,
                           bidir_full=bidir, gather_ids=gather, temperature=0.7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    hit = int(np.flatnonzero(free[0] == eos)[0])
    assert got[1][0] == hit + 1 and (got[0][0, hit:] == eos).all()
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=RTOL * want[2].max())
    assert got[0].dtype == np.int32 and got[2].shape == (3, 6, 4)
    assert len(np.unique(free)) > 2


@pytest.mark.parametrize("name", ["qwen2.5-vl-test", "qwen3-vl-test", "gemma-3-test"])
def test_greedy_matches_jax(name):
    """One sequence: tokens equal and each step's distribution within 1e-5,
    greedy and (one numpy seed) nucleus-sampled; the deepstack residuals at
    the prefill for Qwen3-VL."""
    jp, jcfg, tp, tcfg, scale, embeds, pos, lengths, bidir = _lm_inputs(name)
    e1 = embeds[1:2]
    p1 = pos[1:2] if pos.ndim == 2 else pos[:, 1:2]
    b1 = None if bidir is None else bidir[1:2]
    deepstack = None
    if name.startswith("qwen3"):
        rng = np.random.default_rng(3)
        deepstack = [rng.normal(size=(1, 16, jcfg.d_model)).astype(np.float32)]
    jlm, tlm = jgen.CachedLM(jcfg, embed_scale=scale), tgen.CachedLM(tcfg, embed_scale=scale)
    for sample in (False, True):
        kw = dict(eos_ids=(), bidir_full=b1, sample=sample, temperature=1.3, top_p=0.8)
        want = jlm.greedy(jp, jnp.asarray(e1), p1, 11, 6,
                          deepstack=None if deepstack is None else [jnp.asarray(deepstack[0])],
                          rng=np.random.default_rng(5), **kw)
        got = tlm.greedy(tp, torch.from_numpy(e1), p1, 11, 6,
                         deepstack=None if deepstack is None
                         else [torch.from_numpy(deepstack[0])],
                         rng=np.random.default_rng(5), **kw)
        assert got[0] == want[0] and len(got[1]) == len(want[1]) == 6
        for g, w in zip(got[1], want[1]):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * w.max())
    # an eos the greedy rollout meets ends it, that token included
    greedy = jlm.greedy(jp, jnp.asarray(e1), p1, 11, 6, bidir_full=b1,
                        deepstack=None if deepstack is None else [jnp.asarray(deepstack[0])])
    eos = greedy[0][2]
    got = tlm.greedy(tp, torch.from_numpy(e1), p1, 11, 6, eos_ids={eos, None},
                     bidir_full=b1, deepstack=None if deepstack is None
                     else [torch.from_numpy(deepstack[0])])
    assert got[0][-1] == eos and len(got[0]) == len(got[1]) <= 3


def test_embed_scale_rounds_as_jax():
    """The scale is cast to the embedding dtype before the multiply: in bf16
    sqrt(2560) rounds to 50.5, not 50.596."""
    tcfg = tg3.GEMMA3_MODELS["gemma-3-test"]["config"].text
    lm = tgen.CachedLM(tcfg, embed_scale=2560 ** 0.5)

    class P:
        embed = torch.ones((4, 2), dtype=torch.bfloat16)

    got = lm._embed(P, torch.tensor([[1]]))
    assert got.dtype == torch.bfloat16 and float(got[0, 0, 0]) == 50.5
    want = jnp.ones((1,), jnp.bfloat16) * jnp.asarray(2560 ** 0.5, jnp.bfloat16)
    assert float(got[0, 0, 0]) == float(want[0])


# ---------------------------------------------------------------------------
# The pure-Python helpers (copied from the JAX package)
# ---------------------------------------------------------------------------

def _dists(n, v=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, v)).astype(np.float32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return list((e / e.sum(-1, keepdims=True)).astype(np.float32))


def test_nucleus_sample_matches_jax():
    d = _dists(1, 50)[0]
    for top_p in (0.1, 0.5, 0.9, 1.0):
        rj, rt = np.random.default_rng(11), np.random.default_rng(11)
        want = [jgen._nucleus_sample(d, top_p, rj) for _ in range(20)]
        assert [tgen._nucleus_sample(d, top_p, rt) for _ in range(20)] == want


@pytest.mark.parametrize("position", ["start", "end"])
@pytest.mark.parametrize("gen", [[4, 7, 2], [4, 7, 1], [1], []])
def test_trace_from_rollout_matches_jax(gen, position):
    """Identical traces, with and without a trailing special token (1)."""
    dists = _dists(max(len(gen), 1))[:len(gen)] or _dists(1)[:0]
    decode = lambda ids: " ".join(f"t{i}" for i in ids)  # noqa: E731
    for answer in ([7], [7, 2], [3, 5, 9, 9]):
        want = jgen.trace_from_rollout(gen, dists, answer, {1}, decode, position)
        got = tgen.trace_from_rollout(gen, dists, answer, {1}, decode, position)
        assert got == want


def test_score_rollout_and_decode_text_match_jax():
    dists = _dists(4)
    warned = []
    for gen, ans in (([5, 6, 7, 1], [6, 7]), ([5, 6, 7, 8], [6, 7]),
                     ([5, 1], [3, 4, 5]), ([5, 6], [1, 2, 3, 4, 5])):
        want = jgen.score_rollout(dists[:len(gen)], gen, ans, {1}, warn=warned.append)
        got = tgen.score_rollout(dists[:len(gen)], gen, ans, {1}, warn=warned.append)
        assert got == want
    assert len(warned) == 2                          # the last case, in both
    for mod in (jgen, tgen):
        with pytest.raises(ValueError, match="No content tokens"):
            mod.score_rollout(dists[:1], [1], [3], {1})

    class Tok:
        def decode(self, ids, skip_special_tokens=False):
            return " " + "-".join(map(str, ids)) + ("!" if skip_special_tokens else "") + " "

    class Plain:
        def decode(self, ids):
            return " " + "+".join(map(str, ids)) + " "

    for tok in (Tok(), Plain()):
        for eos in ((), (1, None), {1, 3}):
            assert (tgen.decode_text(tok, [4, 1, 3, 5], eos)
                    == jgen.decode_text(tok, [4, 1, 3, 5], eos))
