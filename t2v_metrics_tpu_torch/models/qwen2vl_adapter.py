"""Qwen2.5-VL VQAScore adapter, image and video scoring (port of the
scoring half of t2v_metrics_tpu/models/qwen2vl_adapter.py).

Contract as the JAX adapter's: P(answer tokens) with the temperature applied
before an fp32 log-softmax, geometric mean over the answer tokens, default
question 'Does this figure show "{}"? Please answer Yes or No.' and answer
"Yes". Engine: one vision-tower call per group of same-shape visuals (patch
count bucketed), one teacher-forced decoder prefill over the padded pair
sequences, the lm head at the answer rows only.

Images arrive as uint8 HWC arrays (paths and PIL images decode with PIL,
imported only for them). The whole preprocess (bicubic resize to the
smart-resize size, bit for bit as Pillow's uint8 resize, normalize,
patchify, window layout) runs on the device; the JAX adapter resizes images
with PIL on the host. Videos (a path, or a ``media.video.DecodedVideo``)
are sampled at ``fps`` frames a second (default 8.0, ``"dynamic"`` 2.0) on
the host, as the JAX adapter's ``_decode_video_raw`` samples them, and the
frames go to the device as uint8, where ``qwen2vl.video_patches`` resizes
them in one float pass (max 360*420 pixels) as the JAX adapter does on its
device. The
JAX adapter decodes with its native libav reader where built, else with
cv2's position seek; the port reads with cv2 only (``media/video.py``).

Generation and traces (the JAX adapter's): ``generate`` decodes a batch
greedily on the device through ``CachedLM.greedy_batch``, or one sequence
at a time with nucleus sampling when ``do_sample`` and ``temperature > 0``;
``forward_with_trace`` scores the answer at the start or the end of a
greedy rollout with a per-token trace; ``forward_with_trace_teacher_forcing``
gives the same trace from one teacher-forced pass. Prompts (images and
videos) are built by the same ``_prepare_pairs`` as scoring.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.scoring import _HostScores, _load_uint8, unique_visuals
from ..media.video import MediaError, is_video, open_video
from ..ops.image import smart_resize
from ..tracing import span, to_device
from . import qwen2vl as q
from .generation import CachedLM, trace_from_rollout
from . import checkpoint as ckpt
from .adapters import VQAScoreModel, default_dtype, load_checkpoint_tree

DEFAULT_QWEN_QUESTION = 'Does this figure show "{}"? Please answer Yes or No.'
DEFAULT_QWEN_ANSWER = "Yes"

_CHAT_PRE = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
_CHAT_POST = "{question}<|im_end|>\n<|im_start|>assistant\n"

SEQ_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280, 1536,
               1792, 2048, 2304, 2560, 3072, 3584, 4096)
PATCH_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048, 2304, 2560,
                 2816, 3072, 3328, 3584, 4096, 4608, 5120, 6144, 7168, 8192,
                 10240, 12288, 14336, 16384)

# qwen_vl_utils image defaults; video frames are capped at 360*420 pixels
IMAGE_MIN_PIXELS = 56 * 56
IMAGE_MAX_PIXELS = 28 * 28 * 1280
VIDEO_MIN_PIXELS = 56 * 56
VIDEO_MAX_PIXELS = 360 * 420


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def _padded_geometry(cfg_vision, grid, s, sb):
    """Host geometry for one (grid, patch-bucket) vision shape, padded to
    the bucket. Returns ``(geom, pos_hw, win_seg, full_seg, reverse,
    tiled)``.

    ``tiled`` when every window fits a 128-row tile and the bin-packed tiles
    fit the bucket: then the whole row domain is composed through the tile
    layout here (``geom["perm_tile"]`` gathers patch rows straight into tile
    slots, pad slots read row 0 under segment -1 and are never read by
    ``reverse``), and pos_hw / win_seg / full_seg / reverse are in tile
    order. Otherwise the rows run in window order, padded with zero rows
    under segment -1, and the windowed layers attend over the whole bucket
    under window segment ids.
    """
    mu = cfg_vision.merge_unit
    geom = q.vision_geometry(grid, cfg_vision)
    nt_rows = len(geom["win_gather"])
    if geom["win_tr"] == 128 and nt_rows <= sb:
        extra = sb - nt_rows  # pad tiles up to the bucket
        wg = np.concatenate([geom["win_gather"], np.zeros(extra, np.int32)])
        win_seg = np.concatenate([geom["win_tseg"], np.full(extra, -1, np.int32)])
        geom = dict(geom, perm_tile=geom["perm"][wg])
        pos_hw = geom["pos_hw"][wg]
        full_seg = np.where(win_seg >= 0, 0, -1).astype(np.int32)
        rev = (geom["win_scatter"][geom["reverse"].astype(np.int64) * mu] // mu
               ).astype(np.int32)
        reverse = np.concatenate([rev, np.zeros(sb // mu - len(rev), np.int32)])
        return geom, pos_hw, win_seg, full_seg, reverse, True
    pad = sb - s
    pos_hw = np.concatenate([geom["pos_hw"], np.zeros((pad, 2), np.int32)])
    win_seg = np.concatenate([geom["win_seg"], np.full(pad, -1, np.int32)])
    full_seg = np.concatenate([np.zeros(s, np.int32), np.full(pad, -1, np.int32)])
    reverse = np.concatenate([geom["reverse"],
                              np.arange(s // mu, sb // mu, dtype=np.int32)])
    return geom, pos_hw, win_seg, full_seg, reverse, False


class Qwen2VLAdapter(VQAScoreModel):
    """Qwen2.5-VL VQAScore adapter (images and videos).

    Weights, in this order: ``params``; ``checkpoint``; random with
    ``init='random'`` (or a model without a hub repo); else the pretrained
    ``hf`` repo from the local Hugging Face cache (never downloaded).

    kwargs:
      checkpoint: a local directory: an HF model directory (safetensors or
        ``*.bin`` shards, either prefix layout) or a native tree
      init: 'random' builds random weights on the device from ``seed``
      params: a ``Qwen2VLModel``, or a pytree in the JAX package's layout
        with numpy or CPU tensor leaves (carried over by ``bridge.py``)
      config: a ``Qwen2VLConfig`` that replaces the registry's
      seed: random-init seed (default 0)
      dtype: parameter dtype (default bf16 on CUDA, fp32 on CPU)
      tokenizer: a tokenizer object or a local tokenizer directory
    """

    video_mode = "direct"
    # tokens added to the longest prompt before its sequence bucket (the JAX
    # Qwen3-VL adapter adds 8)
    seq_extra = 0

    def load_model(self):
        spec = q.QWEN2_VL_MODELS[self.model_name]
        cfg: q.Qwen2VLConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        params = self.kwargs.get("params")
        if params is None:
            path = self.checkpoint_path(spec)
            if path is not None:
                params = self._load_checkpoint(path, cfg, dtype)
            else:
                params = q.init_qwen2vl(cfg, self.kwargs.get("seed", 0), device, dtype)
        if not isinstance(params, q.Qwen2VLModel):
            from ..bridge import qwen2vl_from_numpy

            params = qwen2vl_from_numpy(params, cfg, device, dtype)
        self.params = params
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self.fps_default = spec.get("fps", 8.0)
        self._geometry = {}

    def checkpoint_path(self, spec) -> str | None:
        """The directory to load: ``checkpoint``, else the local snapshot of
        the pretrained repo unless ``init='random'`` (None: random init)."""
        path = self.kwargs.get("checkpoint")
        if path is None and self.kwargs.get("init") != "random" and spec["hf"] is not None:
            path = ckpt.resolve_snapshot(spec["hf"], self.cache_dir)
        return path

    def _load_checkpoint(self, path: str, cfg, dtype) -> dict:
        from ..bridge import qwen2vl_from_numpy

        return load_checkpoint_tree(path, q.convert_qwen2vl, qwen2vl_from_numpy, cfg,
                                    self.model_name, dtype)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    # ------------------------------------------------------------------
    # media -> vision features
    # ------------------------------------------------------------------

    def _device_geometry(self, grid, s, sb):
        """``_padded_geometry`` of one shape, with its arrays on the device
        (kept per shape)."""
        key = (grid, sb)
        if key not in self._geometry:
            geom, pos_hw, win_seg, full_seg, reverse, tiled = _padded_geometry(
                self.config.vision, grid, s, sb)
            perm = geom["perm_tile"] if tiled else geom["perm"]
            dev = [to_device(a.astype(np.int64), self.device)
                   for a in (perm, pos_hw, win_seg, full_seg, reverse)]
            self._geometry[key] = (*dev, tiled)
        return self._geometry[key]

    def _decode_video_raw(self, video, fps):
        """fps-based sampling (qwen_vl_utils smart_nframes semantics) of a
        video path or ``DecodedVideo``: raw (T, H0, W0, 3) uint8 frames, T
        padded to the temporal patch by repeating the last frame, and the
        seconds per temporal grid step."""
        if fps == "dynamic":
            fps = 2.0
        with open_video(video) as (total, native, read):
            n = total / native * float(fps)
            n = max(4, min(768, total, int(round(n / 2) * 2)))  # FRAME_FACTOR=2
            idx = np.round(np.linspace(0, max(total - 1, 0), n)).astype(np.int64)
            frames = [f for f in map(read, idx) if f is not None]
        if not frames:
            raise MediaError(f"no readable frame in video {video}")
        frames = np.stack(frames)
        tp = self.config.vision.temporal_patch_size
        if frames.shape[0] % tp:  # repeat the last frame to the temporal grid
            reps = np.repeat(frames[-1:], tp - frames.shape[0] % tp, axis=0)
            frames = np.concatenate([frames, reps], axis=0)
        sample_fps = len(frames) / max(total / native, 1e-6)
        spg_t = tp / max(sample_fps, 1e-6)
        return np.ascontiguousarray(frames), spg_t

    def _host_visual(self, v, fps):
        """A visual decoded on the host: ("vid", (T, H0, W0, 3) uint8 frames,
        seconds per temporal grid step) or ("img", (H0, W0, 3) uint8, 0.0)."""
        if is_video(v):
            return ("vid", *self._decode_video_raw(v, fps))
        return "img", _load_uint8(v), 0.0

    def _visual_grid(self, kind, shape):
        """(resized height, width, grid_thw) of a decoded visual's shape."""
        cfg = self.config.vision
        if kind == "vid":
            t, h0, w0 = shape[:3]
            hb, wb = smart_resize(h0, w0, cfg.patch_size * cfg.merge_size,
                                  VIDEO_MIN_PIXELS, VIDEO_MAX_PIXELS)
            return hb, wb, (t // cfg.temporal_patch_size, hb // cfg.patch_size,
                            wb // cfg.patch_size)
        h0, w0 = shape[:2]
        hb, wb = smart_resize(h0, w0, cfg.patch_size * cfg.merge_size,
                              IMAGE_MIN_PIXELS, IMAGE_MAX_PIXELS)
        return hb, wb, (1, hb // cfg.patch_size, wb // cfg.patch_size)

    def _patch_rows(self, kind, pixels, hb, wb):
        """(n, S, patch_dim) patch rows of n same-shape decoded visuals on
        the device: images (n, H0, W0*3), videos (n, T, H0, W0*3)."""
        if kind == "vid":
            return q.video_patches(pixels, self.config.vision, hb, wb)
        return q.image_patches(pixels, self.config.vision, hb, wb)

    def _decoded_groups(self, visuals, fps):
        """Decode the visuals on the host and group them by (kind, shape):
        (decoded list, {(kind, shape): [index, ...]})."""
        fps = fps if fps is not None else self.fps_default
        with span("engine.decode"):
            hosts = [self._host_visual(v, fps) for v in visuals]
            groups = {}
            for i, (kind, arr, _) in enumerate(hosts):
                groups.setdefault((kind, arr.shape), []).append(i)
        return hosts, groups

    @torch.inference_mode()
    def _encode_visuals(self, visuals, fps=None):
        """Encode unique visuals, one batched tower call per group of
        same-shape images or videos -> [(feats (T, D) on the device,
        grid_thw, is_video, seconds per temporal grid step)]."""
        cfg = self.config.vision
        hosts, groups = self._decoded_groups(visuals, fps)
        mu = cfg.merge_unit
        out = [None] * len(hosts)
        for (kind, shape), idxs in groups.items():
            hb, wb, grid = self._visual_grid(kind, shape)
            s = int(np.prod(grid))
            sb = _bucket(s, PATCH_BUCKETS)
            perm, pos_hw, win_seg, full_seg, reverse, tiled = \
                self._device_geometry(grid, s, sb)
            n = len(idxs)
            with span("engine.decode"):
                stack = np.stack([hosts[i][1] for i in idxs])
            with span("engine.encode"):
                pixels = to_device(stack.reshape(*stack.shape[:-2], -1), self.device)
                rows = self._patch_rows(kind, pixels, hb, wb)[:, perm]
                if rows.shape[1] < sb:
                    rows = torch.nn.functional.pad(rows, (0, 0, 0, sb - rows.shape[1]))
                feats = q.vision_tower_batch(
                    self.params.vision, cfg, rows, pos_hw.expand(n, -1, -1),
                    win_seg.expand(n, -1), full_seg.expand(n, -1),
                    reverse.expand(n, -1), tiled=tiled)
            for row, i in enumerate(idxs):
                out[i] = (feats[row, : s // mu], grid, kind == "vid", hosts[i][2])
        return out

    # ------------------------------------------------------------------
    # prompts
    # ------------------------------------------------------------------

    def _encode_text(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _build_ids(self, question, n_vis, is_video=False):
        cfg = self.config
        pre = self._encode_text(_CHAT_PRE)
        post = self._encode_text(_CHAT_POST.format(question=question))
        vis_tok = cfg.video_token_id if is_video else cfg.image_token_id
        return (pre + [cfg.vision_start_token_id] + [vis_tok] * n_vis
                + [cfg.vision_end_token_id] + post)

    def _prepare_pairs(self, visuals, questions, fps=None):
        """visuals: list of images or videos (len P, may repeat); questions
        len P -> host arrays of the batched prefill, the per-pair features
        on the device, and the prompt lengths."""
        cfg = self.config
        uniq, inv = unique_visuals(visuals)
        encoded = self._encode_visuals(uniq, fps)

        p = len(visuals)
        mu = cfg.vision.merge_unit
        with span("engine.tokenize"):
            ids_list = [self._build_ids(questions[j],
                                        int(np.prod(encoded[inv[j]][1])) // mu,
                                        encoded[inv[j]][2])
                        for j in range(p)]
            s = _bucket(max(len(x) for x in ids_list) + self.seq_extra, SEQ_BUCKETS)
            ids = np.zeros((p, s), np.int64)
            vis_mask = np.zeros((p, s), bool)
            vis_slot = np.zeros((p, s), np.int64)
            attn = np.zeros((p, s), bool)
            pos = np.zeros((3, p, s), np.int64)
            prompt_lens = []
            for j, toks in enumerate(ids_list):
                n = len(toks)
                arr = np.asarray(toks)
                ids[j, :n] = arr
                attn[j, :n] = True
                vm = np.isin(arr, [cfg.image_token_id, cfg.video_token_id])
                vis_mask[j, :n] = vm
                vis_slot[j, :n][vm] = np.arange(vm.sum())
                _, grid, video, spg = encoded[inv[j]]
                pos[:, j, :n] = q.build_rope_index(
                    arr, [grid], cfg, second_per_grid_ts=[spg] if video else None)
                prompt_lens.append(n)
        # per-pair features gathered on the device from the unique visuals'
        # (the token axis is the second last: (T, D), or (levels, T, D))
        with span("engine.encode"):
            t_max = max(max(e[0].shape[-2] for e in encoded), 1)
            padded = torch.stack([torch.nn.functional.pad(
                e[0], (0, 0, 0, t_max - e[0].shape[-2])) for e in encoded])
            feats = padded[to_device(np.asarray(inv, np.int64), padded.device)]
        return (ids, feats, vis_mask, vis_slot, pos, attn), prompt_lens

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts, fps=None,
                       question_template: str = DEFAULT_QWEN_QUESTION,
                       answer_template: str = DEFAULT_QWEN_ANSWER,
                       temperature: float = 1.0, **kw):
        """Pairwise scoring -> (scores, count); ``images`` may hold videos,
        sampled at ``fps`` frames a second. The scores stay on the device
        until ``np.asarray`` copies them to the host, so a caller can queue
        the next chunk first (``Score.batch_forward``)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        arrays, prompt_lens = self._prepare_pairs(images, questions, fps)
        return self._score_prepared(arrays, prompt_lens, answers, temperature), len(images)

    def _score_prepared(self, arrays, prompt_lens, answers, temperature) -> _HostScores:
        """Teacher-force each pair's answer behind its prompt: ``arrays``
        (ids, feats, splice mask, splice slot, rope ids, attention mask) of
        the prompts from ``_prepare_pairs`` -> the scores on the device."""
        ids, feats, vis_mask, vis_slot, pos, attn = arrays
        with span("engine.tokenize"):
            ans_tok = [self._encode_text(a) for a in answers]
            a_max = max(len(a) for a in ans_tok)
            pcount = len(answers)
            s = ids.shape[1]
            full_ids = ids.copy()
            ans_ids = np.zeros((pcount, a_max), np.int64)
            ans_pos = np.zeros((pcount, a_max), np.int64)
            ans_mask = np.zeros((pcount, a_max), np.float32)
            for j, (a, n) in enumerate(zip(ans_tok, prompt_lens)):
                if n + len(a) > s:
                    raise ValueError("sequence bucket overflow")
                full_ids[j, n:n + len(a)] = a
                attn[j, n:n + len(a)] = True
                ans_ids[j, : len(a)] = a
                ans_pos[j, : len(a)] = n - 1 + np.arange(len(a))
                ans_mask[j, : len(a)] = 1.0
                # answer tokens are plain text positions in the rope index
                last = pos[:, j, n - 1].max()
                pos[:, j, n:n + len(a)] = last + 1 + np.arange(len(a))

        with span("engine.score"):
            dev = [to_device(a, self.device)
                   for a in (full_ids, vis_mask, vis_slot, pos, attn, ans_ids,
                             ans_pos, ans_mask)]
            logp = self._splice_and_score(dev[0], feats, *dev[1:],
                                          temperature=float(temperature))
            return _HostScores(torch.exp(logp.float()))

    def _splice_and_score(self, ids, feats, *arrays, temperature):
        return q.splice_and_score(self.params, self.config, ids, feats,
                                  *arrays, temperature=temperature)

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        flat_txts = list(texts) * m
        return self.forward(flat_imgs, flat_txts, **kw).reshape(m, n)

    # ------------------------------------------------------------------
    # generation and traces
    # ------------------------------------------------------------------

    @property
    def eos_token_id(self):
        return getattr(self.tokenizer, "eos_token_id", None)

    @property
    def _lm(self) -> CachedLM:
        if getattr(self, "_cached_lm", None) is None:
            self._cached_lm = CachedLM(self.config.text)
        return self._cached_lm

    def _decode(self, ids) -> str:
        return getattr(self.tokenizer, "decode", lambda x: str(x))(ids)

    def _split_feats_batched(self, feats):
        """(P, T, D) visual features -> (main, deepstack levels or None).
        Qwen3-VL overrides: its rows stack the deepstack levels."""
        return feats, None

    def _greedy_steps(self, ids_row, feats, vis_mask, vis_slot, pos_row, n_prompt,
                      max_new_tokens, temperature=1.0, sample=False, top_p=0.9, rng=None):
        """KV-cached generation of one sequence: ids_row (S,), vis_mask and
        vis_slot (S,) and pos_row (3, S) on the host, feats its visual
        features on the device (Qwen3-VL: the deepstack levels too, added at
        the prefill only). Returns (generated ids, per-step fp32
        distributions)."""
        main, levels = self._split_feats_batched(feats[None])
        rows = [torch.from_numpy(np.asarray(a)[None]).to(self.device)
                for a in (ids_row, vis_mask, vis_slot)]
        embeds, deepstack = q.splice_embeds(self.params, rows[0], main, *rows[1:], levels)
        return self._lm.greedy(self.params.decoder, embeds, np.asarray(pos_row)[:, None],
                               int(n_prompt), max_new_tokens, eos_ids={self.eos_token_id},
                               temperature=temperature, deepstack=deepstack,
                               sample=sample, top_p=top_p, rng=rng)

    @torch.inference_mode()
    def forward_with_trace(self, images, texts, fps=None,
                           question_template: str = DEFAULT_QWEN_QUESTION,
                           answer_template: str = DEFAULT_QWEN_ANSWER,
                           max_new_tokens: int = 1, temperature: float = 1.0,
                           score_position: str = "end", debug: bool = False):
        """Reference trace contract (qwen2vl_model.py:303-493): the answer's
        geometric-mean probability at the start or the end of a greedy
        rollout of ``max_new_tokens``, and one trace dict a pair."""
        assert score_position in ("start", "end")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        arrays, prompt_lens = self._prepare_pairs(images, questions, fps)
        ids, feats, vis_mask, vis_slot, pos, _ = arrays
        lm_probs, traces = [], []
        for j in range(len(images)):
            gen, dists = self._greedy_steps(ids[j], feats[j], vis_mask[j], vis_slot[j],
                                            pos[:, j], prompt_lens[j], max_new_tokens,
                                            temperature)
            gm, trace = trace_from_rollout(gen, dists, self._encode_text(answers[j]),
                                           {self.eos_token_id}, self._decode,
                                           score_position)
            lm_probs.append(gm)
            traces.append(trace)
        return np.asarray(lm_probs, np.float32), traces

    def _splice_and_answer_dists(self, ids, feats, *arrays, temperature):
        return q.splice_and_answer_dists(self.params, self.config, ids, feats, *arrays,
                                         temperature=temperature)

    @torch.inference_mode()
    def forward_with_trace_teacher_forcing(
            self, images, texts, fps=None,
            question_template: str = DEFAULT_QWEN_QUESTION,
            answer_template: str = DEFAULT_QWEN_ANSWER,
            temperature: float = 1.0, debug: bool = False):
        """The trace of ``forward_with_trace`` from one teacher-forced pass
        over the answer tokens (the reference's test_teacher_vs_rollout.py
        holds the two within 1e-6); scored_indices are the forced answer
        tokens'."""
        if len(images) != len(texts):
            raise ValueError("forward_with_trace_teacher_forcing: one image per text")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        arrays, prompt_lens = self._prepare_pairs(images, questions, fps)
        ids, feats, vis_mask, vis_slot, pos, attn = arrays
        ans_tok = [self._encode_text(a) for a in answers]
        a_max = max(len(a) for a in ans_tok)
        full_ids = ids.copy()
        ans_pos = np.zeros((len(images), a_max), np.int64)
        for j, (a, n) in enumerate(zip(ans_tok, prompt_lens)):
            full_ids[j, n:n + len(a)] = a
            attn[j, n:n + len(a)] = True
            ans_pos[j, : len(a)] = n - 1 + np.arange(len(a))
            pos[:, j, n:n + len(a)] = pos[:, j, n - 1].max() + 1 + np.arange(len(a))
        dev = [torch.from_numpy(a).to(self.device)
               for a in (full_ids, vis_mask, vis_slot, pos, attn, ans_pos)]
        dists = self._splice_and_answer_dists(dev[0], feats, *dev[1:],
                                              temperature=float(temperature))
        dists = dists.float().cpu().numpy()
        lm_probs, traces = [], []
        for j, a in enumerate(ans_tok):
            gm, trace = trace_from_rollout(list(a), [dists[j, i] for i in range(len(a))],
                                           a, {self.eos_token_id}, self._decode,
                                           score_position="start")
            lm_probs.append(gm)
            traces.append(trace)
        return np.asarray(lm_probs, np.float32), traces

    @torch.inference_mode()
    def generate(self, images, texts, fps=None, max_new_tokens: int = 128,
                 temperature: float = 0.0, do_sample=None, top_p: float = 0.9,
                 **kw) -> list[str]:
        """Free-form continuation (reference qwen2vl_model.py:495-563):
        greedy over the batch, or nucleus sampling one sequence at a time
        when do_sample and temperature > 0."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        if do_sample is None:
            do_sample = temperature > 0
        sample = bool(do_sample and temperature > 0)
        arrays, prompt_lens = self._prepare_pairs(images, list(texts), fps)
        if not sample:
            return self._generate_batched(arrays, prompt_lens, max_new_tokens)
        ids, feats, vis_mask, vis_slot, pos, _ = arrays
        outs = []
        for j in range(len(images)):
            gen, _ = self._greedy_steps(ids[j], feats[j], vis_mask[j], vis_slot[j],
                                        pos[:, j], prompt_lens[j], max_new_tokens,
                                        temperature=temperature, sample=True,
                                        top_p=top_p)
            if gen and self.eos_token_id is not None and gen[-1] == self.eos_token_id:
                gen = gen[:-1]
            outs.append(self._decode(gen).strip())
        return outs

    def _generate_batched(self, arrays, prompt_lens, max_new_tokens: int) -> list[str]:
        """Greedy decode of the batch through ``CachedLM.greedy_batch``: the
        tokens are read back once, at the end."""
        ids, feats, vis_mask, vis_slot, pos, _ = arrays
        main, deepstack = self._split_feats_batched(feats)
        dev = [torch.from_numpy(a).to(self.device) for a in (ids, vis_mask, vis_slot)]
        embeds, ds = q.splice_embeds(self.params, dev[0], main, *dev[1:], deepstack)
        tokens, lengths = self._lm.greedy_batch(
            self.params.decoder, embeds, pos, np.asarray(prompt_lens, np.int32),
            max_new_tokens, eos_id=self.eos_token_id, deepstack=ds)
        outs = []
        for j in range(len(prompt_lens)):
            gen = tokens[j, : lengths[j]].tolist()
            if gen and self.eos_token_id is not None and gen[-1] == self.eos_token_id:
                gen = gen[:-1]
            outs.append(self._decode(gen).strip())
        return outs
