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

Generation and traces (the JAX adapter's, over the same batched prompt
assembly as scoring, audio included): ``generate`` decodes several pairs
greedily in one batch through ``CachedLM.greedy_batch`` (deepstack at the
prefill, M-RoPE step positions) and one pair through a per-sequence
rollout; ``forward_with_trace`` scores the answer at the start or the end
of a greedy rollout. Each rollout's prompt takes its own sequence bucket,
as in the JAX adapter. ``generate(return_audio=True)`` adds speech: a
greedy thinker rollout that also captures the hidden state after layer
``accept_hidden_layer``, the talker and its code predictor
(``models/qwen3omni_talker.py``, weights from ``talker_config=``,
``talker_params=`` and ``code2wav_params=``) and Code2Wav, returning (texts,
24 kHz waveforms) and writing a ``.wav`` with the stdlib ``wave`` module.
``forward_with_trace_teacher_forcing`` raises ``NotImplementedError``: the
JAX adapter inherits the Qwen2.5 version, which raises ``AttributeError`` on
this family (its vision config has no ``window_size``).
"""

from __future__ import annotations

import wave

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.scoring import unique_visuals
from . import decoder as dec
from . import qwen2vl as q2
from . import qwen3omni as qo
from . import qwen3omni_audio as qa
from . import qwen3omni_talker as tk
from . import qwen3vl as q3
from .adapters import default_dtype, load_checkpoint_tree
from .generation import decode_text, trace_from_rollout
from .qwen2vl_adapter import (_CHAT_POST, _CHAT_PRE, DEFAULT_QWEN_ANSWER,
                              DEFAULT_QWEN_QUESTION, SEQ_BUCKETS, _bucket)
from .qwen3vl_adapter import Qwen3VLAdapter

_NO_TEACHER_FORCING = (
    "Qwen3-Omni has no forward_with_trace_teacher_forcing: the JAX adapter inherits "
    "Qwen2.5-VL's, which raises AttributeError on this family ('Qwen3VisionConfig' "
    "object has no attribute 'window_size'); use forward_with_trace")


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
    use_audio_in_video (no effect, see the module docstring); for speech
    output talker_config (a ``TalkerConfig``), talker_params and
    code2wav_params (a ``TalkerModel`` / ``Code2WavModel`` or the JAX
    package's trees, e.g. ``qwen3omni_talker.convert_talker`` /
    ``convert_code2wav`` of an HF checkpoint's ``talker.*`` / ``code2wav.*``
    tensors) and seed (the talker's sampling).
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
        mask), the prompt lengths and each pair's visual grids; the
        sequence bucket leaves room for ``a_max`` answer tokens. Each
        distinct visual and audio is encoded once."""
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
        return ((ids, feats, splice_mask, splice_slot, pos, attn),
                [len(x) for x in ids_list], grids)

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
        arrays, prompt_lens, _ = self._prepare_omni(list(images), audio_paths, questions,
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
    # generation and traces
    # ------------------------------------------------------------------

    def _splice_prompts(self, arrays):
        """The prompts' embeddings (P, S, D) with the vision and audio rows
        spliced in, and the deepstack residuals at the vision rows only."""
        ids, feats, splice_mask, splice_slot = arrays[:4]
        vis_mask = splice_mask & (ids != self.config.audio_token_id)
        dev = [torch.from_numpy(a).to(self.device)
               for a in (ids, splice_mask, splice_slot, vis_mask)]
        return q2.splice_embeds(self.params, dev[0], feats[:, 0], dev[1], dev[2],
                                feats[:, 1:].unbind(1), deepstack_mask=dev[3])

    @staticmethod
    def _row(embeds, deepstack, j: int, s: int):
        """Pair j's prompt cut to its own bucket ``s`` (1, s, D), and its
        deepstack rows."""
        return (embeds[j:j + 1, :s],
                None if deepstack is None else [d[j:j + 1, :s] for d in deepstack])

    def _generation_eos(self) -> set:
        """``generate``'s stop ids: eos, and <|im_end|> where the tokenizer
        names it (the JAX adapter's)."""
        eos = {self.eos_token_id} - {None}
        c2i = getattr(self.tokenizer, "convert_tokens_to_ids", None)
        if c2i is not None:
            try:
                i = c2i("<|im_end|>")
            except (KeyError, ValueError, TypeError):
                i = None
            if isinstance(i, int) and i >= 0:
                eos.add(i)
        return eos

    @torch.inference_mode()
    def generate(self, images, texts, audio_paths=None, fps=None,
                 max_new_tokens: int = 256, return_audio: bool = False,
                 speaker: str = "Ethan", save_audio_path=None, **kw):
        """Free-form answers (reference qwen3omni_model.py:483-548): greedy,
        in one batch for several pairs, per sequence for one. ``images`` may
        hold None and ``audio_paths`` one audio (or None) a pair. With
        ``return_audio``: (texts, 24 kHz float32 waveforms), see
        ``_generate_with_audio``."""
        audio_paths = [None] * len(texts) if audio_paths is None else list(audio_paths)
        if not len(images) == len(texts) == len(audio_paths):
            raise ValueError("generate: one image (or None) and one audio (or None) per text")
        if return_audio:
            return self._generate_with_audio(images, texts, audio_paths, max_new_tokens,
                                             speaker, save_audio_path, fps=fps, **kw)
        eos = self._generation_eos()
        arrays, prompt_lens, _ = self._prepare_omni(list(images), audio_paths, list(texts),
                                                    0, fps)
        embeds, deepstack = self._splice_prompts(arrays)
        if len(images) > 1:
            tokens, lengths = self._lm.greedy_batch(
                self.params.decoder, embeds, arrays[4], np.asarray(prompt_lens, np.int32),
                max_new_tokens, eos_id=min(eos) if eos else None, deepstack=deepstack)
            return [decode_text(self.tokenizer, tokens[j, :lengths[j]].tolist(), eos)
                    for j in range(len(prompt_lens))]
        n = prompt_lens[0]
        s = _bucket(n, SEQ_BUCKETS)
        row, ds = self._row(embeds, deepstack, 0, s)
        gen, _ = self._lm.greedy(self.params.decoder, row, arrays[4][:, :1, :s], n,
                                 max_new_tokens, eos_ids=eos, deepstack=ds)
        return [decode_text(self.tokenizer, gen, eos)]

    @torch.inference_mode()
    def forward_with_trace(self, images, texts, audio_paths=None, fps=None,
                           question_template: str = DEFAULT_QWEN_QUESTION,
                           answer_template: str = DEFAULT_QWEN_ANSWER,
                           max_new_tokens: int = 1, temperature: float = 1.0,
                           score_position: str = "end", debug: bool = False):
        """Reference trace contract (qwen3omni_model.py supports_trace): the
        answer's geometric-mean probability at the start or the end of a
        greedy rollout of ``max_new_tokens``, and one trace dict a pair."""
        if score_position not in ("start", "end"):
            raise ValueError(f"score_position must be 'start' or 'end', not {score_position!r}")
        audio_paths = [None] * len(texts) if audio_paths is None else list(audio_paths)
        if not len(images) == len(texts) == len(audio_paths):
            raise ValueError("forward_with_trace: one image (or None) and one audio "
                             "(or None) per text")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        eos = {self.eos_token_id} - {None}
        decode = getattr(self.tokenizer, "decode", lambda x: str(x))
        arrays, prompt_lens, _ = self._prepare_omni(list(images), audio_paths, questions,
                                                    0, fps)
        embeds, deepstack = self._splice_prompts(arrays)
        lm_probs, traces = [], []
        for j, n in enumerate(prompt_lens):
            s = _bucket(n, SEQ_BUCKETS)
            row, ds = self._row(embeds, deepstack, j, s)
            gen, dists = self._lm.greedy(self.params.decoder, row, arrays[4][:, j:j + 1, :s],
                                         n, max_new_tokens, eos_ids=eos,
                                         temperature=temperature, deepstack=ds)
            gm, trace = trace_from_rollout(gen, dists, self._encode_text(answers[j]), eos,
                                           decode, score_position)
            lm_probs.append(gm)
            traces.append(trace)
        return np.asarray(lm_probs, np.float32), traces

    def forward_with_trace_teacher_forcing(self, *args, **kw):
        raise NotImplementedError(_NO_TEACHER_FORCING)

    # ------------------------------------------------------------------
    # speech output (reference qwen3omni_model.py:483-548: return_audio,
    # speaker, save_audio_path; a 24 kHz waveform)
    # ------------------------------------------------------------------

    def _talker_session(self):
        """(TalkerSession, TalkerConfig, Code2WavModel or None), made once
        from ``talker_config=``, ``talker_params=`` and ``code2wav_params=``
        (modules, or the JAX package's trees, carried over by ``bridge.py``
        in the thinker's dtype)."""
        if getattr(self, "_talker", None) is not None:
            return self._talker
        tcfg = self.kwargs.get("talker_config")
        tparams = self.kwargs.get("talker_params")
        if tcfg is None or tparams is None:
            raise RuntimeError(
                "talker weights not loaded: pass talker_config= and talker_params= "
                "(convert with qwen3omni_talker.convert_talker / convert_code2wav from "
                "an HF checkpoint's talker.* / code2wav.* tensors)")
        from .. import bridge

        dtype = self.params.decoder.embed.dtype
        if not isinstance(tparams, tk.TalkerModel):
            tparams = bridge.talker_from_numpy(tparams, tcfg, self.device, dtype)
        c2w = self.kwargs.get("code2wav_params")
        if c2w is not None and not isinstance(c2w, tk.Code2WavModel):
            c2w = bridge.code2wav_from_numpy(c2w, tcfg.code2wav, self.device, dtype)
        # the modules replace the trees they were made from
        self.kwargs["talker_params"], self.kwargs["code2wav_params"] = tparams, c2w
        self._talker = (tk.TalkerSession(tcfg, tparams), tcfg, c2w)
        return self._talker

    def _thinker_rollout_with_hiddens(self, arrays, prompt_lens, j: int,
                                      max_new_tokens: int, eos, accept_layer: int,
                                      embeds=None, deepstack=None):
        """Pair j's greedy rollout (its own bucket, deepstack at the prefill)
        that also keeps, for every token (prompt and generated), its input
        embedding and the residual stream after layer ``accept_layer``
        (after the deepstack residual: the talker's condition). Returns
        (thinker ids (T,) host, embeddings (1, T, D), hiddens (1, T, D) on
        the device, multimodal mask (T,), prompt length, generated ids)."""
        cfg = self.config
        if embeds is None:
            embeds, deepstack = self._splice_prompts(arrays)
        n = prompt_lens[j]
        s = _bucket(n, SEQ_BUCKETS)
        row, ds = self._row(embeds, deepstack, j, s)
        pos = arrays[4][:, j:j + 1, :s]
        last_pos = int(pos[:, 0, n - 1].max())
        dev = row.device
        table = self.params.decoder.embed
        cache = dec.init_cache(cfg.text, 1, s + max_new_tokens, dtype=row.dtype, device=dev)
        valid = torch.zeros((1, s + max_new_tokens), dtype=torch.bool, device=dev)
        valid[0, :n] = True
        logits, cache, cap = dec.forward(
            self.params.decoder, cfg.text, row, torch.from_numpy(pos).to(dev), valid,
            logit_positions=torch.full((1, 1), n - 1, device=dev), cache=cache,
            deepstack=ds, cache_pos=0, capture_layer=accept_layer)
        all_ids = [int(i) for i in arrays[0][j, :n]]
        emb_rows, hid_rows = [row[0, :n]], [cap[0, :n]]
        nxt = int(logits[0, 0].argmax())
        for t in range(max_new_tokens):
            all_ids.append(nxt)
            e1 = table[torch.full((1, 1), nxt, device=dev)]
            emb_rows.append(e1[0])
            if nxt in eos:
                # HF keeps a hidden state for every generated token, eos
                # included; the talker reads only its embedding
                hid_rows.append(torch.zeros_like(e1[0]))
                break
            cpos = s + t
            valid[0, cpos] = True
            logits, cache, cap1 = dec.forward(
                self.params.decoder, cfg.text, e1,
                torch.full((3, 1, 1), last_pos + 1 + t, device=dev), valid, cache=cache,
                cache_pos=cpos, capture_layer=accept_layer)
            hid_rows.append(cap1[0])
            nxt = int(logits[0, 0].argmax())
        thinker_ids = np.asarray(all_ids)
        mm_mask = np.isin(thinker_ids, [cfg.image_token_id, cfg.video_token_id,
                                        cfg.audio_token_id])
        return (thinker_ids, torch.cat(emb_rows)[None], torch.cat(hid_rows)[None], mm_mask,
                n, all_ids[n:])

    @torch.inference_mode()
    def _generate_with_audio(self, images, texts, audio_paths, max_new_tokens, speaker,
                             save_audio_path, fps=None, **kw):
        """``generate(return_audio=True)``: for each pair a greedy thinker
        rollout with the accept-layer capture, the talker's codec frames
        (``talker_max_new_tokens`` 512, ``talker_do_sample`` True,
        ``talker_temperature`` 0.9, ``talker_top_k`` 50, ``talker_top_p``
        1.0, ``talker_repetition_penalty`` 1.05, drawn from
        ``np.random.default_rng(seed)``) and Code2Wav's chunked decode ->
        (texts, 24 kHz float32 waveforms). ``save_audio_path``: the last
        pair's waveform as a 16-bit mono ``.wav``."""
        sess, tcfg, c2w = self._talker_session()
        eos = {self.eos_token_id} - {None}
        rng = np.random.default_rng(self.kwargs.get("seed", 0))
        arrays, prompt_lens, grids = self._prepare_omni(list(images), list(audio_paths),
                                                        list(texts), 0, fps)
        embeds, deepstack = self._splice_prompts(arrays)
        out_texts, out_wavs = [], []
        for j in range(len(prompt_lens)):
            t_ids, t_embed, t_hidden, mm_mask, n_prompt, gen_ids = \
                self._thinker_rollout_with_hiddens(arrays, prompt_lens, j, max_new_tokens,
                                                   eos, tcfg.accept_hidden_layer,
                                                   embeds, deepstack)
            out_texts.append(decode_text(self.tokenizer, gen_ids, eos))
            talker_embeds, talker_ids, trailing, tts_pad = tk.build_talker_inputs(
                tcfg, sess.params, t_ids, t_embed, t_hidden, mm_mask,
                self.params.decoder.embed, speaker, n_prompt)
            # the talker's 3-D positions: the thinker's rope index over its ids
            pos = q2.build_rope_index(talker_ids[0], grids[j], self._rope_cfg,
                                      second_per_grid_ts=[1.0] * len(grids[j]))[:, None]
            do_sample = kw.get("talker_do_sample", True)
            codes = sess.generate_codes(
                talker_embeds, pos, trailing, tts_pad,
                max_new_tokens=kw.get("talker_max_new_tokens", 512), do_sample=do_sample,
                temperature=kw.get("talker_temperature", 0.9),
                top_k=kw.get("talker_top_k", 50), top_p=kw.get("talker_top_p", 1.0),
                repetition_penalty=kw.get("talker_repetition_penalty", 1.05), rng=rng,
                predictor_do_sample=do_sample)
            if codes.shape[1] == 0 or c2w is None:
                wav = np.zeros((0,), np.float32)
            else:
                wav = tk.chunked_decode(c2w, tcfg.code2wav, codes[None])[0, 0]
            out_wavs.append(wav)
            if save_audio_path:
                with wave.open(str(save_audio_path), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(24000)
                    w.writeframes(np.clip(wav * 32767, -32768, 32767)
                                  .astype(np.int16).tobytes())
        return out_texts, out_wavs
