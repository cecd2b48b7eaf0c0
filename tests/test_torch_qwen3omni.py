"""Port parity: the Qwen3-Omni thinker's scoring path
(t2v_metrics_tpu_torch/models/qwen3omni_audio.py, qwen3omni.py,
qwen3omni_adapter.py) against the JAX package on the CPU, on the same
parameters (carried over by ``bridge.py``), the same tokenizer instance and
the same seeded media (uint8 images, ``vid.mp4``, 16 kHz ``.wav`` files
written with the stdlib ``wave`` module).

Tolerances (fp32): the audio geometry exactly; the mel filterbank 1e-7
against ``transformers.audio_utils.mel_filter_bank``; the log-mel 1e-4
against the JAX package's ``log_mel_device`` (fp32 at HIGHEST precision;
the port computes in float64) and 5e-4 against WhisperFeatureExtractor (the
JAX package's bar); the audio tower 1e-5 relative to its output's scale
against the JAX package's ``encode_audio``; against Hugging Face's
Qwen3OmniMoe towers loaded through ``checkpoint=`` 2e-4 (audio, the JAX
suite's bar) and 3e-5 (vision); scores 1e-5 on their logs (nats).

Generation and traces (``generate``, ``forward_with_trace``,
``generate(return_audio=True)``) against the JAX adapter on the same
parameters and tokenizer: generated strings equal (equal tokens), trace
probabilities 1e-5 nats, the thinker's captured hiddens 1e-5 of their
largest magnitude, codec codes
equal, waveforms 3e-4 (the JAX Code2Wav run on its transposed kernels
reversed, as ``tests/test_torch_talker.py`` explains).
"""

import dataclasses
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import t2v_metrics_tpu as jt2v  # noqa: E402
import t2v_metrics_tpu_torch as tt2v  # noqa: E402
from t2v_metrics_tpu.models import qwen3omni as jqo  # noqa: E402
from t2v_metrics_tpu.models import qwen3omni_audio as jqa  # noqa: E402
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer  # noqa: E402
from t2v_metrics_tpu_torch import bridge  # noqa: E402
from t2v_metrics_tpu_torch.constants import CLIP_MEAN, CLIP_STD  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen2vl as tq2  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni as tqo  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni_adapter as tqoa  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni_audio as tqa  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3omni_talker as ttk  # noqa: E402

NAME = "qwen3-omni-test"
JCFG = jqo.resolve_config(NAME)
TCFG = tqo.resolve_config(NAME)
VID = "_test_assets/vid.mp4"
TEXTS = ["a tone playing", "two dogs on grass"]
NATS = 1e-5


def _params():
    """Numpy parameters in the JAX layout, matrices x3 (as the Qwen suites)."""
    leaves, treedef = jax.tree.flatten(jqo.init_qwen3omni(jax.random.PRNGKey(0), JCFG))
    return jax.tree.unflatten(treedef, [np.asarray(x) * np.float32(3.0) if np.ndim(x) == 2
                                        else np.asarray(x) for x in leaves])


def write_wav(path, seconds: float, seed: int, sr: int = 16000, channels: int = 1) -> str:
    """A seeded 16-bit PCM clip: a tone plus noise."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    x = 0.2 * np.sin(2 * np.pi * (220 + 110 * seed) * t) + rng.normal(0, 0.01, n)
    pcm = np.repeat((x * 32767).astype(np.int16)[:, None], channels, axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(autouse=True)
def _no_native_reader(monkeypatch):
    """The JAX adapter as it runs without its libav reader (the port's
    model): audio through the stdlib ``wave`` path, no video audio track. A
    checkout may hold the built library, so it is switched off here."""
    from t2v_metrics_tpu.media import native_loader

    monkeypatch.setattr(native_loader, "decode_audio", lambda *a, **k: None)
    monkeypatch.setattr(native_loader, "has_audio", lambda *a, **k: False)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def scorers(params):
    tok = SimpleT5Tokenizer(JCFG.text.vocab_size)
    return (jt2v.VQAScore(NAME, params=params, tokenizer=tok),
            tt2v.VQAScore(NAME, params=params, tokenizer=tok, device="cpu"))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("omni")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)    # resized to 32x48
    return {"img": img, "img2": img2, "wav": write_wav(d / "a.wav", 1.3, 0),
            "wav2": write_wav(d / "b.wav", 0.7, 1, sr=22050, channels=2),
            "dir": d}


def _close(got, want):
    np.testing.assert_allclose(np.log(got), np.log(want), atol=NATS, rtol=0)


# ---------------------------------------------------------------------------
# Config and registry
# ---------------------------------------------------------------------------

def _clip_normalised(vision: dict) -> dict:
    """A JAX vision config's fields as the port holds them: the port's also
    names the pixel normalisation, CLIP's for Qwen3-Omni as in the JAX
    package."""
    return dict(vision, image_mean=CLIP_MEAN, image_std=CLIP_STD)


def test_test_config_and_registry_equal_jax():
    want = dataclasses.asdict(JCFG)
    assert dataclasses.asdict(TCFG) == dict(want, vision=_clip_normalised(want["vision"]))
    assert list(tqo.QWEN3_OMNI_MODELS) == list(jqo.QWEN3_OMNI_MODELS)
    for name, spec in tqo.QWEN3_OMNI_MODELS.items():
        assert spec["hf"] == jqo.QWEN3_OMNI_MODELS[name]["hf"]
        assert name in tt2v.list_all_vqascore_models()


def test_30b_audio_width_is_the_thinker_width():
    """The 30b names' audio tower writes rows of the thinker's width; the
    JAX config's AudioEncoderConfig() default (3584, Qwen2.5-Omni's) does
    not fit its 2048-wide thinker, so a random full-width JAX model cannot
    splice audio. Every other width is the JAX config's."""
    for name in ("qwen3-omni-30b-a3b", "qwen3-omni-30b-a3b-thinking",
                 "qwen3-omni-30b-a3b-captioner"):
        t, j = tqo.resolve_config(name), jqo.resolve_config(name)
        assert t.audio.output_dim == t.text.d_model == t.vision.out_hidden == 2048
        assert j.audio.output_dim == 3584 != j.text.d_model == 2048
        assert dataclasses.replace(t.audio, output_dim=3584) == tqa.AudioEncoderConfig(
            **dataclasses.asdict(j.audio))
        assert dataclasses.asdict(t.vision) == _clip_normalised(dataclasses.asdict(j.vision))
        assert dataclasses.asdict(t.text) == dataclasses.asdict(j.text)


# ---------------------------------------------------------------------------
# Audio front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_mel", [16, 37, 40, 3000])
@pytest.mark.parametrize("full", [False, True])
def test_audio_geometry_equals_jax(t_mel, full):
    tc = tqa.AudioEncoderConfig() if full else TCFG.audio
    jc = jqa.AudioEncoderConfig() if full else JCFG.audio
    got, want = tqa.audio_geometry(t_mel, tc), jqa.audio_geometry(t_mel, jc)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (tc.chunk_tokens, tc.freq_after) == (jc.chunk_tokens, jc.freq_after)


@pytest.mark.parametrize("n_mels", [128, 80, 32])
def test_mel_filters_equal_transformers(n_mels):
    from transformers.audio_utils import mel_filter_bank

    want = mel_filter_bank(num_frequency_bins=201, num_mel_filters=n_mels,
                           min_frequency=0.0, max_frequency=8000.0, sampling_rate=16000,
                           norm="slaney", mel_scale="slaney")
    np.testing.assert_allclose(tqa.mel_filters(400, n_mels, 16000), want, atol=1e-7, rtol=0)


def _whisper(audio, n_mels):
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=n_mels, sampling_rate=16000, hop_length=160,
                                 chunk_length=30, n_fft=400)
    return fe(audio, sampling_rate=16000, padding="do_not_pad", return_tensors="np",
              do_normalize=False)["input_features"][0]


@pytest.mark.parametrize("n_sec", [0.5, 2.3])
def test_log_mel_matches_jax_and_whisper(n_sec):
    audio = (np.random.default_rng(7).standard_normal(int(16000 * n_sec)) * 0.1
             ).astype(np.float32)
    got = tqa.log_mel_device(audio, n_mels=128).numpy()
    want = jqa.log_mel_device(audio, n_mels=128)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, _whisper(audio, 128), atol=5e-4, rtol=0)


@pytest.mark.parametrize("n", [150, 201, 399])
def test_short_audio_mel_matches_whisper(n):
    """Under 400 samples the JAX adapter computes the mel with
    WhisperFeatureExtractor on the host; the port's device mel gives the
    same numbers, and where Whisper refuses the clip (no reflect pad for 200
    samples or fewer) raises as it does."""
    audio = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    if n <= 200:
        with pytest.raises(RuntimeError):
            _whisper(audio, 32)
        with pytest.raises(ValueError, match="too few"):
            tqa.log_mel_device(audio, n_mels=32)
        return
    want = _whisper(audio, 32)
    got = tqa.log_mel_device(audio, n_mels=32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_wav_reader_equals_jax(media, monkeypatch):
    """Mono 16 kHz and a stereo 22.05 kHz clip (channels averaged, linear
    resample) read to the JAX adapter's samples (its ``load_audio_mel``
    without its native reader, the mel caught) and mel."""
    from t2v_metrics_tpu.models import qwen3omni_adapter as jqoa

    mel = jqa.log_mel_device
    for key in ("wav", "wav2"):
        seen = []
        monkeypatch.setattr(jqa, "log_mel_device", lambda audio, **kw: seen.append(audio))
        jqoa.load_audio_mel(media[key], JCFG.audio)
        monkeypatch.setattr(jqa, "log_mel_device", mel)
        np.testing.assert_array_equal(tqoa.read_wav_16k(media[key]), seen[0])
        np.testing.assert_allclose(tqoa.load_audio_mel(media[key], TCFG.audio).numpy(),
                                   mel(seen[0], n_mels=32), atol=1e-4, rtol=0)


def test_non_wav_audio_raises(media, tmp_path):
    """No libav here or in the JAX package without its native reader: any
    other container fails in ``wave.open``."""
    from PIL import Image

    path = str(tmp_path / "x.png")
    Image.fromarray(media["img"]).save(path)
    with pytest.raises(wave.Error):
        tqoa.load_audio_mel(path, TCFG.audio)


# ---------------------------------------------------------------------------
# Audio tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(params):
    return bridge.qwen3omni_from_numpy(params, TCFG, "cpu", torch.float32)


@pytest.mark.parametrize("t_mel", [16, 37, 40, 250])
def test_audio_encoder_matches_jax(params, port_model, t_mel):
    mel = np.random.default_rng(t_mel).standard_normal((32, t_mel)).astype(np.float32)
    want = np.asarray(jqa.encode_audio(params["audio"], JCFG.audio, mel))
    got = tqa.encode_audio(port_model.audio, TCFG.audio, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_encode_audios_one_call_equals_each_alone(port_model):
    """The distinct audios of a call share one tower call, block-diagonal
    over each audio's windows: each gets the rows it gets alone."""
    rng = np.random.default_rng(3)
    mels = [torch.from_numpy(rng.standard_normal((32, t)).astype(np.float32))
            for t in (40, 7, 97)]
    together = tqa.encode_audios(port_model.audio, TCFG.audio, mels)
    for mel, got in zip(mels, together):
        np.testing.assert_allclose(got.numpy(),
                                   tqa.encode_audio(port_model.audio, TCFG.audio, mel).numpy(),
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Splice and scores
# ---------------------------------------------------------------------------

def _splice_inputs(seed=0):
    """Two sequences of 24 slots: vision rows, then audio rows, then text;
    the deepstack level nonzero on every row, the audio rows included."""
    rng = np.random.default_rng(seed)
    b, s, t, d = 2, 24, 10, TCFG.text.d_model
    ids = rng.integers(0, 400, (b, s))
    splice_mask = np.zeros((b, s), bool)
    vis_mask = np.zeros((b, s), bool)
    splice_slot = np.zeros((b, s), np.int64)
    splice_mask[:, 3:13] = True
    vis_mask[0, 3:9] = True            # 6 vision + 4 audio rows
    vis_mask[1, 3:7] = True            # 4 vision + 6 audio rows
    ids[splice_mask] = TCFG.audio_token_id
    ids[vis_mask] = TCFG.image_token_id
    splice_slot[:, 3:13] = np.arange(10)
    pos = np.broadcast_to(np.arange(s), (3, b, s)).copy()
    attn = np.ones((b, s), bool)
    attn[1, 20:] = False
    ans_ids = rng.integers(0, 400, (b, 2))
    ans_pos = np.array([[18, 19], [17, 18]])
    ans_mask = np.ones((b, 2), np.float32)
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    ds = rng.standard_normal((1, b, t, d)).astype(np.float32)
    return (ids, feats, splice_mask, splice_slot, pos, attn, ans_ids, ans_pos, ans_mask), ds, vis_mask


def test_splice_and_score_matches_jax_and_keeps_deepstack_off_audio_rows(params, port_model):
    import jax.numpy as jnp

    arrays, ds, vis_mask = _splice_inputs()
    want = np.asarray(jqo.splice_and_score(params, JCFG, *map(jnp.asarray, arrays),
                                           deepstack_feats=jnp.asarray(ds),
                                           vis_mask=jnp.asarray(vis_mask)))
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]

    def port(levels, mask):
        return tqo.splice_and_score(port_model, TCFG, *t, deepstack_feats=list(levels),
                                    vis_mask=torch.from_numpy(mask)).numpy()

    levels = torch.from_numpy(ds)
    got = port(levels, vis_mask)
    np.testing.assert_allclose(got, want, atol=NATS, rtol=0)
    # the audio rows' levels never reach the decoder: zeroing them changes
    # nothing, while letting them in (Qwen3-VL's splice) does
    zeroed = levels.clone()
    audio_rows = arrays[2] & ~vis_mask
    for j in range(2):
        zeroed[:, j, torch.from_numpy(arrays[3][j][audio_rows[j]])] = 0.0
    np.testing.assert_array_equal(port(zeroed, vis_mask), got)
    assert np.abs(port(levels, arrays[2]) - got).max() > 1e-4


def test_image_scores_match_jax(scorers, media):
    j, t = scorers
    imgs = [media["img"], media["img2"]]
    _close(t(images=imgs, texts=TEXTS), j(images=imgs, texts=TEXTS))


def test_image_and_audio_scores_match_jax(scorers, media):
    """score_matrix with an audio per image, one of them resampled from
    22.05 kHz stereo; and audio changes the score."""
    j, t = scorers
    imgs, auds = [media["img"], media["img2"]], [media["wav"], media["wav2"]]
    got = t(images=imgs, texts=TEXTS, audio_paths=auds)
    _close(got, j(images=imgs, texts=TEXTS, audio_paths=auds))
    assert np.abs(np.log(got) - np.log(t(images=imgs, texts=TEXTS))).min() > 1e-6


def test_audio_only_scores_match_jax(scorers, media):
    j, t = scorers
    auds = [media["wav"], media["wav2"], media["wav"]]
    got = t.model.forward([None] * 3, TEXTS + TEXTS[:1], audio_paths=auds)
    assert got.shape == (3,)
    _close(got, j.model.forward([None] * 3, TEXTS + TEXTS[:1], audio_paths=auds))
    _close(t(images=[None], texts=TEXTS, audio_paths=[media["wav"]]),
           j(images=[None], texts=TEXTS, audio_paths=[media["wav"]]))


def test_video_scores_match_jax(scorers, media):
    """vid.mp4 at the default 8 fps, alone and with an audio clip; a video's
    own audio track is not scored (neither package can read it here)."""
    j, t = scorers
    _close(t(images=[VID], texts=TEXTS), j(images=[VID], texts=TEXTS))
    _close(t(images=[VID], texts=TEXTS, audio_paths=[media["wav"]]),
           j(images=[VID], texts=TEXTS, audio_paths=[media["wav"]]))


def test_mixed_batch_matches_jax(scorers, media):
    """One forward over image, image + audio, audio-only and video pairs."""
    j, t = scorers
    imgs = [media["img"], media["img"], None, VID]
    auds = [None, media["wav"], media["wav2"], None]
    texts = TEXTS + TEXTS
    _close(t.model.forward(imgs, texts, audio_paths=auds),
           j.model.forward(imgs, texts, audio_paths=auds))


def test_adapter_contract(scorers, media):
    """The contract's flags; ``generate`` and ``forward_with_trace`` run (an
    audio-only pair); teacher forcing raises, as the JAX adapter does on
    this family (``test_teacher_forcing_raises_where_jax_raises``)."""
    _, t = scorers
    m = t.model
    assert m.allows_audio and m.allows_image and m.allows_video
    assert m.video_mode == "direct" and m.fps_default == 8.0 and m.use_audio_in_video
    out = m.generate([None], TEXTS[:1], audio_paths=[media["wav"]], max_new_tokens=2)
    assert isinstance(out, list) and len(out) == 1 and isinstance(out[0], str)
    probs, traces = m.forward_with_trace([None], TEXTS[:1], audio_paths=[media["wav"]])
    assert probs.shape == (1,) and 0.0 <= float(probs[0]) <= 1.0 and len(traces) == 1
    with pytest.raises(NotImplementedError, match="AttributeError"):
        m.forward_with_trace_teacher_forcing([None], TEXTS[:1])


# ---------------------------------------------------------------------------
# Generation and traces
# ---------------------------------------------------------------------------

GEN_TEXTS = ["Describe this.", "What sound is this?", "Any cats here?"]


def test_generate_batched_and_per_sequence_match_jax(scorers, media):
    """Three pairs (image + audio, image, audio only) decoded in one batch
    and one at a time: the port's batch equals its per-sequence strings and
    the JAX adapter's, in both of its paths."""
    j, t = scorers
    imgs, auds = [media["img"], media["img2"], None], [media["wav"], None, media["wav2"]]
    want_b = j.model.generate(imgs, GEN_TEXTS, audio_paths=auds, max_new_tokens=5)
    got_b = t.model.generate(imgs, GEN_TEXTS, audio_paths=auds, max_new_tokens=5)
    assert got_b == want_b
    for i, a, text, b in zip(imgs, auds, GEN_TEXTS, got_b):
        want = j.model.generate([i], [text], audio_paths=[a], max_new_tokens=5)
        assert t.model.generate([i], [text], audio_paths=[a], max_new_tokens=5) == want == [b]


def test_generate_video_matches_jax(scorers, media):
    """vid.mp4 alone (per sequence) and beside an image with audio (batched)."""
    j, t = scorers
    for imgs, auds in (([VID], None), ([VID, media["img"]], [None, media["wav"]])):
        texts = GEN_TEXTS[:len(imgs)]
        assert (t.model.generate(imgs, texts, audio_paths=auds, max_new_tokens=4)
                == j.model.generate(imgs, texts, audio_paths=auds, max_new_tokens=4))


@pytest.mark.parametrize("max_new,where", [(1, "end"), (3, "start"), (3, "end")])
def test_forward_with_trace_matches_jax(scorers, media, max_new, where):
    """The rollout trace of image + audio, image-only and audio-only pairs:
    probabilities 1e-5 nats, the trace's ids, texts and indices equal."""
    j, t = scorers
    imgs, auds = [media["img"], media["img2"], None], [media["wav"], None, media["wav2"]]
    kw = dict(audio_paths=auds, max_new_tokens=max_new, score_position=where)
    got_p, got = t.model.forward_with_trace(imgs, TEXTS + TEXTS[:1], **kw)
    want_p, want = j.model.forward_with_trace(imgs, TEXTS + TEXTS[:1], **kw)
    _close(got_p, want_p)
    for g, w in zip(got, want):
        for key in ("generated_text", "generated_length", "score_position",
                    "score_start_idx", "scored_indices", "scored_tokens_text"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(np.log(g["probability"]), np.log(w["probability"]),
                                   atol=NATS, rtol=0)
        for gd, wd in zip(g["token_details"], w["token_details"]):
            assert gd["expected_token_id"] == wd["expected_token_id"]
            assert ([a["token_id"] for a in gd["top_alternatives"]]
                    == [a["token_id"] for a in wd["top_alternatives"]])


def test_teacher_forcing_raises_where_jax_raises(scorers, media):
    """The JAX adapter inherits Qwen2.5-VL's teacher-forced trace, which
    fails on this family's vision config; the port raises
    NotImplementedError naming that, and points to forward_with_trace."""
    j, t = scorers
    with pytest.raises(AttributeError, match="window_size"):
        j.model.forward_with_trace_teacher_forcing([media["img"]], TEXTS[:1])
    with pytest.raises(NotImplementedError, match="forward_with_trace"):
        t.model.forward_with_trace_teacher_forcing([media["img"]], TEXTS[:1])


# ---------------------------------------------------------------------------
# Speech output: generate(return_audio=True)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def speech(params):
    """The thinker (qwen3-omni-test) with a chat-preserving tokenizer, the
    JAX suite's tiny talker at the thinker's width (48), accept layer 1, and
    a 4-quantizer Code2Wav whose groups match the talker's, in both
    packages, on seeded HF-layout weights."""
    import jax

    from t2v_metrics_tpu.models import qwen3omni_talker as jtk
    from test_talker_parity import _ChatT5Tokenizer
    from test_torch_talker import (c2w_sd, flip_transposed_kernels, jax_c2w_cfg,
                                   jax_talker_cfg, port_cfg, talker_sd)

    tok = _ChatT5Tokenizer(512)
    ccfg = jax_c2w_cfg(num_quantizers=4, codebook=64)
    jcfg = jax_talker_cfg(**dict(
        code2wav=ccfg, thinker_hidden_size=48, accept_hidden_layer=1,
        im_start_token_id=tok._t._id("<|im_start|>"), system_token_id=tok._t._id("system"),
        user_token_id=tok._t._id("user"), assistant_token_id=tok._t._id("assistant"),
        tts_bos_token_id=8, tts_eos_token_id=9, tts_pad_token_id=10))
    jtp = jtk.convert_talker(talker_sd(jcfg, 5), jcfg)
    jcp = jtk.convert_code2wav(c2w_sd(ccfg, 6), ccfg)
    jsc = jt2v.VQAScore(NAME, params=params, tokenizer=tok, talker_config=jcfg,
                        talker_params=jtp, code2wav_params=flip_transposed_kernels(jcp))
    tsc = tt2v.VQAScore(NAME, params=params, tokenizer=tok, device="cpu",
                        talker_config=port_cfg(jcfg),
                        talker_params=jax.tree.map(np.asarray, jtp),
                        code2wav_params=jax.tree.map(np.asarray, jcp))
    return jsc, tsc, tok


def test_thinker_rollout_with_hiddens_matches_jax(speech, media):
    """The thinker rollout that feeds the talker: its ids, the input
    embeddings and the residual stream after layer 1 (after the deepstack
    residual) of every prompt and generated token, within 1e-5 of their
    largest magnitude (the vision tower's rows differ by ~1e-5 relative
    between the packages, as in the scoring tests)."""
    jsc, tsc, _ = speech
    j, t = jsc.model, tsc.model
    want = j._thinker_rollout_with_hiddens(media["img"], media["wav"], "Say something.", 4,
                                           {j.eos_token_id}, 1)
    arrays, lens, _ = t._prepare_omni([media["img"]], [media["wav"]], ["Say something."], 0)
    got = t._thinker_rollout_with_hiddens(arrays, lens, 0, 4, {t.eos_token_id}, 1)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] and got[5] == want[5]


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_generate_return_audio_matches_jax(speech, media, tmp_path, sample):
    """generate(return_audio=True) end to end (image + audio, and image only):
    the texts equal, the codec frames (read through chunked_decode) equal,
    the waveforms within 3e-4 of the JAX adapter's (its Code2Wav on reversed
    transposed kernels), and the 24 kHz 16-bit .wav holds the waveform."""
    from t2v_metrics_tpu.models import qwen3omni_talker as jtk

    jsc, tsc, _ = speech
    seen = {"jax": [], "port": []}
    jdec_, tdec_ = jtk.chunked_decode, ttk.chunked_decode

    def spy(store, fn):
        def wrapped(p, cfg, codes, *a, **k):
            store.append(np.asarray(codes).copy())
            return fn(p, cfg, codes, *a, **k)
        return wrapped

    kw = dict(max_new_tokens=4, return_audio=True, speaker="Ethan", talker_max_new_tokens=5,
              talker_do_sample=sample)
    for imgs, auds in (([media["img"]], [media["wav"]]), ([media["img2"]], None)):
        jtk.chunked_decode = spy(seen["jax"], jdec_)
        ttk.chunked_decode = spy(seen["port"], tdec_)
        try:
            jpath, tpath = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
            want_t, want_w = jsc.model.generate(imgs, ["Say something."], audio_paths=auds,
                                                save_audio_path=jpath, **kw)
            got_t, got_w = tsc.model.generate(imgs, ["Say something."], audio_paths=auds,
                                              save_audio_path=tpath, **kw)
        finally:
            jtk.chunked_decode, ttk.chunked_decode = jdec_, tdec_
        assert got_t == want_t and all(isinstance(x, str) for x in got_t)
        np.testing.assert_array_equal(seen["port"][-1], seen["jax"][-1])
        assert seen["port"][-1].shape[1] == 4 and seen["port"][-1].shape[2] >= 1
        assert got_w[0].dtype == np.float32 and got_w[0].shape == want_w[0].shape
        assert got_w[0].size > 0 and np.isfinite(got_w[0]).all()
        np.testing.assert_allclose(got_w[0], want_w[0], atol=3e-4, rtol=0)
        with wave.open(tpath, "rb") as w:
            assert w.getframerate() == 24000 and w.getsampwidth() == 2
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        np.testing.assert_array_equal(
            pcm, np.clip(got_w[0] * 32767, -32768, 32767).astype(np.int16))



# ---------------------------------------------------------------------------
# An HF-layout checkpoint
# ---------------------------------------------------------------------------

def _hf_thinker():
    from transformers.models.qwen3_omni_moe import configuration_qwen3_omni_moe as C
    from transformers.models.qwen3_omni_moe import modeling_qwen3_omni_moe as M

    torch.manual_seed(0)
    cfg = C.Qwen3OmniMoeThinkerConfig(
        audio_config=dict(d_model=32, encoder_layers=2, encoder_attention_heads=4,
                          encoder_ffn_dim=64, num_mel_bins=32, max_source_positions=1500,
                          n_window=8, n_window_infer=32, downsample_hidden_size=12,
                          output_dim=48, activation_function="gelu", scale_embedding=False,
                          conv_chunksize=500),
        vision_config=dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                           patch_size=4, out_hidden_size=48, num_position_embeddings=16,
                           deepstack_visual_indexes=[0]),
        text_config=dict(vocab_size=512, hidden_size=48, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                         moe_intermediate_size=32, num_experts=4, num_experts_per_tok=2,
                         rope_scaling={"rope_type": "default", "mrope_section": [4, 2, 2],
                                       "interleaved": True}),
        audio_token_id=505, image_token_id=501, video_token_id=502, audio_start_token_id=506)
    return M.Qwen3OmniMoeThinkerForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def hf_snapshot(tmp_path_factory):
    from test_torch_hf_parity import stage_safetensors

    hf = _hf_thinker()
    sd = {f"thinker.{k}": v for k, v in hf.state_dict().items()}
    sd["talker.model.norm.weight"] = torch.ones(8)          # read by nothing
    sd["code2wav.pre_transformer.norm.weight"] = torch.ones(8)
    path = stage_safetensors(sd, str(tmp_path_factory.mktemp("omni") / "ckpt"))
    return hf, sd, path


def test_checkpoint_loads_the_hf_thinker(hf_snapshot, media):
    """A staged HF snapshot (``thinker.*`` keys, the experts per module, HF's
    merger names, talker and code2wav keys beside) through ``checkpoint=``:
    the audio tower gives HF's Qwen3OmniMoeAudioEncoder output (2e-4) and
    the vision tower HF's (3e-5); the scores equal those of the same state
    dict converted in memory and passed as ``params=``."""
    hf, sd, path = hf_snapshot
    tok = SimpleT5Tokenizer(512)
    s = tt2v.VQAScore(NAME, checkpoint=path, tokenizer=tok, device="cpu", dtype=torch.float32)
    m = s.model
    for t_mel in (16, 37, 40):
        mel = np.random.default_rng(t_mel).standard_normal((32, t_mel)).astype(np.float32)
        with torch.no_grad():
            want = hf.audio_tower(input_features=torch.from_numpy(mel),
                                  feature_lens=torch.tensor([t_mel])).last_hidden_state
        got = tqa.encode_audio(m.params.audio, TCFG.audio, torch.from_numpy(mel))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=0)
    img = media["img"]
    levels, grid, _, _ = m._encode_visuals([img])[0]
    p = TCFG.vision.patch_size     # 48x64 is smart-resized to 56x72
    px = tq2.image_patches(torch.from_numpy(img.reshape(1, 48, -1)), TCFG.vision,
                           grid[1] * p, grid[2] * p)[0]
    with torch.no_grad():
        main, deep = hf.visual(px, grid_thw=torch.tensor([grid]))
    np.testing.assert_allclose(levels[0].numpy(), main.numpy(), atol=3e-5, rtol=0)
    np.testing.assert_allclose(levels[1].numpy(), deep[0].numpy(), atol=3e-5, rtol=0)
    tree = tqo.convert_qwen3omni(sd, TCFG)
    ref = tt2v.VQAScore(NAME, params=tree, tokenizer=tok, device="cpu", dtype=torch.float32)
    kw = dict(images=[img, None], texts=TEXTS, audio_paths=[media["wav"], media["wav2"]])
    np.testing.assert_array_equal(s(**kw), ref(**kw))
    experts = m.params.decoder.blocks[1].moe
    hf_mlp = hf.model.layers[1].mlp.experts
    np.testing.assert_array_equal(experts.down[2].numpy(),
                                  hf_mlp[2].down_proj.weight.t().detach().numpy())


def test_checkpoint_missing_thinker_key_is_named(hf_snapshot, tmp_path):
    from t2v_metrics_tpu_torch.models.checkpoint import CheckpointError
    from test_torch_hf_parity import stage_safetensors

    _, sd, _ = hf_snapshot
    broken = {k: v for k, v in sd.items() if k != "thinker.audio_tower.proj2.weight"}
    path = stage_safetensors(broken, str(tmp_path / "broken"))
    with pytest.raises(CheckpointError, match="audio_tower.proj2.weight"):
        tt2v.VQAScore(NAME, checkpoint=path, tokenizer=SimpleT5Tokenizer(512), device="cpu")
