"""Qwen3-Omni adapter: audio (+ vision) VQAScore scoring (port of the scoring
half of t2v_metrics_tpu/models/qwen3omni_adapter.py).

Contract as the JAX adapter's: ``allows_audio``; ``audio_paths`` (one per
pair, or None) adds an audio block behind the vision block (``images`` may
hold None for audio-only pairs); teacher-forced P(answer) with the audio
features spliced at ``<|audio|>`` positions, which take plain sequential
rope positions (HF get_rope_index :335-345), and the vision features
Qwen3-VL's way, their deepstack residuals at the vision rows only. The rope
index is the JAX adapter's: ``tokens_per_second`` 1 and one second per
temporal grid step for every visual.

Media: images and video frames (``fps`` default 8.0) are resized on the
device with Pillow's fixed-point uint8 resize, bit for bit, and encoded one
tower call per group of same-shape visuals (``Qwen3VLAdapter``). Audio is
read with the stdlib ``wave`` module (16-bit PCM, channels averaged, a
linear resample to 16 kHz), as the JAX adapter does without its libav
reader; any other file raises ``wave.Error`` there and here. Its log-mel is
computed on the device (``qwen3omni_audio.log_mel_device``; also for clips
under 400 samples, where the JAX adapter calls WhisperFeatureExtractor on
the host: the same numbers), and the distinct audios of a call go through
one audio tower call. A video's own audio track is never scored
(``use_audio_in_video`` is accepted and has no effect): the JAX adapter
probes the track with its native reader, which reports none where that
reader is absent, and the port has no such reader.

Generation, traces and the talker are not ported yet: ``generate``,
``forward_with_trace`` and ``forward_with_trace_teacher_forcing`` raise
``NotImplementedError`` (the Qwen adapter's versions would drop the audio).
"""

from __future__ import annotations

import wave

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.scoring import unique_visuals
from . import qwen2vl as q2
from . import qwen3omni as qo
from . import qwen3omni_audio as qa
from . import qwen3vl as q3
from .adapters import default_dtype, load_checkpoint_tree
from .qwen2vl_adapter import (_CHAT_POST, _CHAT_PRE, DEFAULT_QWEN_ANSWER,
                              DEFAULT_QWEN_QUESTION, SEQ_BUCKETS, _bucket)
from .qwen3vl_adapter import Qwen3VLAdapter

_NOT_PORTED = ("Qwen3-Omni generation, traces and the talker are not ported yet "
               "(ROADMAP.md, queue 1: Qwen3-Omni generation and the talker)")


def read_wav_16k(path) -> np.ndarray:
    """A 16-bit PCM ``.wav`` file -> mono float32 samples at 16 kHz: the
    channels averaged, /32768, and a linear resample from another rate (the
    JAX adapter's stdlib path). Raises ``wave.Error`` for anything else."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1)
    audio = raw.astype(np.float32) / 32768.0
    if sr != 16000:
        idx = np.linspace(0, len(audio) - 1, int(len(audio) * 16000 / sr))
        audio = np.interp(idx, np.arange(len(audio)), audio).astype(np.float32)
    return audio


def load_audio_mel(path, cfg: qa.AudioEncoderConfig, device="cpu") -> torch.Tensor:
    """An audio file -> its (mel_bins, T) Whisper-style log-mel on ``device``."""
    return qa.log_mel_device(read_wav_16k(path), n_mels=cfg.num_mel_bins, device=device)


class Qwen3OmniAdapter(Qwen3VLAdapter):
    """Qwen3-Omni thinker VQAScore adapter (images, videos, audio).

    Weights, in this order: ``params`` (a ``Qwen3OmniModel``, or a pytree in
    the JAX package's layout carried over by ``bridge.py``); ``checkpoint``
    (an HF directory: the ``thinker.*`` keys, ``talker.*`` and
    ``code2wav.*`` ignored; experts per module or packed; or a native tree);
    random from ``seed`` with ``init='random'`` or for a model without a hub
    repo; else the pretrained repo from the local cache (never downloaded).
    kwargs also: config (a ``Qwen3OmniConfig``), dtype, tokenizer,
    use_audio_in_video (no effect, see the module docstring).
    """

    video_mode = "direct"
    allows_image = True
    allows_video = True
    allows_audio = True

    def load_model(self):
        spec = qo.QWEN3_OMNI_MODELS[self.model_name]
        cfg: qo.Qwen3OmniConfig = self.kwargs.get("config") or qo.resolve_config(
            self.model_name)
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        params = self.kwargs.get("params")
        if params is None:
            path = self.checkpoint_path(spec)
            if path is not None:
                from ..bridge import qwen3omni_from_numpy

                params = load_checkpoint_tree(path, qo.convert_qwen3omni,
                                              qwen3omni_from_numpy, cfg,
                                              self.model_name, dtype)
            else:
                params = qo.init_qwen3omni(cfg, self.kwargs.get("seed", 0), device, dtype)
        if not isinstance(params, qo.Qwen3OmniModel):
            from ..bridge import qwen3omni_from_numpy

            params = qwen3omni_from_numpy(params, cfg, device, dtype)
        self.params = params
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self.fps_default = 8.0
        self.use_audio_in_video = self.kwargs.get("use_audio_in_video", True)
        self._assistant_suffix = ""
        self._geometry = {}
        # the rope index's view of the config: Qwen3-VL's vision tower
        # (tokens_per_second 1) and the Omni token ids
        self._rope_cfg = q3.Qwen3VLConfig(
            vision=cfg.vision, text=cfg.text, image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            vision_end_token_id=cfg.vision_end_token_id)

    # ------------------------------------------------------------------
    # media -> features
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _encode_audios(self, paths) -> list[torch.Tensor]:
        """Distinct audio files -> their (n_tokens, d_model) features on the
        device, from one audio tower call."""
        cfg = self.config.audio
        mels = [load_audio_mel(p, cfg, self.device) for p in paths]
        return qa.encode_audios(self.params.audio, cfg, mels)

    def _prepare_omni(self, visuals, audios, questions, a_max: int, fps=None):
        """Per pair a visual (or None), an audio (or None) and a question ->
        the host arrays of the batched prefill (ids, feats (P, 1 + n_ds, T,
        D) on the device, splice mask, splice slot, rope ids, attention
        mask) and the prompt lengths; the sequence bucket leaves room for
        ``a_max`` answer tokens. Each distinct visual and audio is encoded
        once."""
        cfg = self.config
        uniq_v, inv_v = unique_visuals([v for v in visuals if v is not None])
        uniq_a, inv_a = unique_visuals([a for a in audios if a is not None])
        enc_v = self._encode_visuals(uniq_v, fps) if uniq_v else []
        enc_a = self._encode_audios(uniq_a) if uniq_a else []
        it_v, it_a = iter(inv_v), iter(inv_a)
        pairs = [(None if v is None else next(it_v), None if a is None else next(it_a))
                 for v, a in zip(visuals, audios)]

        pre = self._encode_text(_CHAT_PRE)
        ids_list, grids, combos = [], [], {}
        for (pv, pa), question in zip(pairs, questions):
            ids, pair_grids = list(pre), []
            if pv is not None:
                levels, grid, video, _ = enc_v[pv]
                tok = cfg.video_token_id if video else cfg.image_token_id
                ids += ([cfg.vision_start_token_id] + [tok] * levels.shape[-2]
                        + [cfg.vision_end_token_id])
                pair_grids.append(grid)
            if pa is not None:
                ids += ([cfg.audio_start_token_id] + [cfg.audio_token_id] * enc_a[pa].shape[0]
                        + [cfg.audio_end_token_id])
            ids_list.append(ids + self._encode_text(_CHAT_POST.format(question=question)))
            grids.append(pair_grids)
            combos.setdefault((pv, pa), len(combos))

        # each distinct (visual, audio) pairing's rows: the vision levels,
        # then the audio features as the main level over zero deepstack rows
        n_lv = 1 + len(cfg.vision.deepstack_indexes)
        rows = []
        for pv, pa in combos:
            parts = [] if pv is None else [enc_v[pv][0]]
            if pa is not None:
                parts.append(F.pad(enc_a[pa][None], (0, 0, 0, 0, 0, n_lv - 1)))
            rows.append(torch.cat(parts, dim=1) if parts else None)
        t_max = max([1] + [r.shape[1] for r in rows if r is not None])
        empty = torch.zeros((n_lv, t_max, cfg.text.d_model), device=self.device,
                            dtype=self.params.decoder.embed.dtype)
        padded = torch.stack([empty if r is None else F.pad(r, (0, 0, 0, t_max - r.shape[1]))
                              for r in rows])
        feats = padded[torch.as_tensor([combos[p] for p in pairs], device=padded.device)]

        p = len(pairs)
        s = _bucket(max(len(x) for x in ids_list) + a_max, SEQ_BUCKETS)
        ids = np.zeros((p, s), np.int64)
        splice_mask = np.zeros((p, s), bool)
        splice_slot = np.zeros((p, s), np.int64)
        attn = np.zeros((p, s), bool)
        pos = np.zeros((3, p, s), np.int64)
        splice_ids = [cfg.image_token_id, cfg.video_token_id, cfg.audio_token_id]
        for j, toks in enumerate(ids_list):
            n = len(toks)
            arr = np.asarray(toks)
            ids[j, :n] = arr
            attn[j, :n] = True
            sm = np.isin(arr, splice_ids)
            splice_mask[j, :n] = sm
            splice_slot[j, :n][sm] = np.arange(sm.sum())
            pos[:, j, :n] = q2.build_rope_index(
                arr, grids[j], self._rope_cfg, second_per_grid_ts=[1.0] * len(grids[j]))
        return (ids, feats, splice_mask, splice_slot, pos, attn), [len(x) for x in ids_list]

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_device(self, images, texts, audio_paths=None, fps=None,
                       question_template: str = DEFAULT_QWEN_QUESTION,
                       answer_template: str = DEFAULT_QWEN_ANSWER,
                       temperature: float = 1.0, **kw):
        """Pairwise scoring -> (scores on the device, count). ``images`` may
        hold videos and None (audio only); ``audio_paths`` one audio or None
        a pair."""
        audio_paths = [None] * len(texts) if audio_paths is None else list(audio_paths)
        if not len(images) == len(texts) == len(audio_paths):
            raise ValueError("forward_device: one image (or None) and one audio "
                             "(or None) per text")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        a_max = max(len(self._encode_text(a)) for a in answers)
        arrays, prompt_lens = self._prepare_omni(list(images), audio_paths, questions,
                                                 a_max, fps)
        return self._score_prepared(arrays, prompt_lens, answers, temperature), len(images)

    def _splice_and_score(self, ids, feats, splice_mask, *arrays, temperature):
        # feats: (P, 1 + n_ds, T, D); the vision rows are the spliced rows
        # that are not audio
        vis_mask = splice_mask & (ids != self.config.audio_token_id)
        splice_slot, pos, attn, ans_ids, ans_pos, ans_mask = arrays
        return qo.splice_and_score(self.params, self.config, ids, feats[:, 0], splice_mask,
                                   splice_slot, pos, attn, ans_ids, ans_pos, ans_mask,
                                   deepstack_feats=feats[:, 1:].unbind(1),
                                   vis_mask=vis_mask, temperature=temperature)

    def score_matrix(self, images, texts, audio_paths=None, **kw) -> np.ndarray:
        """(M visuals, each with its audio in ``audio_paths``) x (N texts)."""
        m, n = len(images), len(texts)
        flat_audio = None if audio_paths is None else [a for a in audio_paths for _ in range(n)]
        return self.forward([im for im in images for _ in range(n)], list(texts) * m,
                            audio_paths=flat_audio, **kw).reshape(m, n)

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------

    def generate(self, *args, **kw):
        raise NotImplementedError(_NOT_PORTED)

    def forward_with_trace(self, *args, **kw):
        raise NotImplementedError(_NOT_PORTED)

    def forward_with_trace_teacher_forcing(self, *args, **kw):
        raise NotImplementedError(_NOT_PORTED)
