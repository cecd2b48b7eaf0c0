"""Qwen2.5-VL VQAScore adapter, image scoring (port of the image half of
t2v_metrics_tpu/models/qwen2vl_adapter.py).

Contract as the JAX adapter's: P(answer tokens) with the temperature applied
before an fp32 log-softmax, geometric mean over the answer tokens, default
question 'Does this figure show "{}"? Please answer Yes or No.' and answer
"Yes". Engine: one vision-tower call per group of same-shape images (patch
count bucketed), one teacher-forced decoder prefill over the padded pair
sequences, the lm head at the answer rows only.

Images arrive as uint8 HWC arrays (paths and PIL images decode with PIL,
imported only for them). The whole preprocess (bicubic resize to the
smart-resize size, rounding to uint8 levels, normalize, patchify, window
layout) runs on the device; the JAX adapter resizes images with PIL on the
host. Video scoring, generation and traces are not ported yet and raise.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from t2v_metrics_tpu.constants import VIDEO_EXTENSIONS
from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer, load_hf_tokenizer

from ..engine.scoring import _HostScores, _load_uint8
from ..ops.image import smart_resize
from . import qwen2vl as q
from .adapters import VQAScoreModel, default_dtype

DEFAULT_QWEN_QUESTION = 'Does this figure show "{}"? Please answer Yes or No.'
DEFAULT_QWEN_ANSWER = "Yes"

_CHAT_PRE = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
_CHAT_POST = "{question}<|im_end|>\n<|im_start|>assistant\n"

SEQ_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280, 1536,
               1792, 2048, 2304, 2560, 3072, 3584, 4096)
PATCH_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048, 2304, 2560,
                 2816, 3072, 3328, 3584, 4096, 4608, 5120, 6144, 7168, 8192,
                 10240, 12288, 14336, 16384)

# qwen_vl_utils image defaults
IMAGE_MIN_PIXELS = 56 * 56
IMAGE_MAX_PIXELS = 28 * 28 * 1280


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
    """Qwen2.5-VL VQAScore adapter (images).

    kwargs:
      init: 'random' builds random weights on the device from ``seed``
      params: a ``Qwen2VLModel``, or a numpy pytree in the JAX package's
        layout (carried over by ``bridge.py``)
      config: a ``Qwen2VLConfig`` that replaces the registry's
      seed: random-init seed (default 0)
      dtype: parameter dtype (default bf16 on CUDA, fp32 on CPU)
      tokenizer: a tokenizer object or a local tokenizer directory
    Checkpoint loading raises: pretrained weights are not ported yet.
    """

    video_mode = "direct"

    def load_model(self):
        spec = q.QWEN2_VL_MODELS[self.model_name]
        cfg: q.Qwen2VLConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        if self.kwargs.get("checkpoint"):
            raise NotImplementedError("checkpoint loading is not ported yet; "
                                      "pass init='random' or params=")
        params = self.kwargs.get("params")
        if params is None:
            if self.kwargs.get("init") != "random" and spec["hf"] is not None:
                raise NotImplementedError(
                    f"pretrained weights for {self.model_name} are not ported "
                    "yet; pass init='random' or params=")
            params = q.init_qwen2vl(cfg, self.kwargs.get("seed", 0), device, dtype)
        elif not isinstance(params, q.Qwen2VLModel):
            from ..bridge import qwen2vl_from_numpy

            params = qwen2vl_from_numpy(params, cfg, device, dtype)
        self.params = params

        tok = self.kwargs.get("tokenizer")
        if isinstance(tok, str):
            if not os.path.isdir(tok):
                raise ValueError(f"tokenizer {tok!r} is not a local directory")
            tok = load_hf_tokenizer(tok)
        if tok is None:
            if spec["hf"] is not None:
                warnings.warn(
                    f"no local tokenizer for {spec['hf']}; using "
                    "SimpleT5Tokenizer, so scores will NOT match pretrained "
                    "weights (pass tokenizer=<local dir>)")
            tok = SimpleT5Tokenizer(cfg.text.vocab_size)
        self.tokenizer = tok
        self._geometry = {}

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    # ------------------------------------------------------------------
    # images -> vision features
    # ------------------------------------------------------------------

    def _device_geometry(self, grid, s, sb):
        """``_padded_geometry`` of one shape, with its arrays on the device
        (kept per shape)."""
        key = (grid, sb)
        if key not in self._geometry:
            geom, pos_hw, win_seg, full_seg, reverse, tiled = _padded_geometry(
                self.config.vision, grid, s, sb)
            perm = geom["perm_tile"] if tiled else geom["perm"]
            dev = [torch.from_numpy(a.astype(np.int64)).to(self.device)
                   for a in (perm, pos_hw, win_seg, full_seg, reverse)]
            self._geometry[key] = (*dev, tiled)
        return self._geometry[key]

    @torch.inference_mode()
    def _encode_visuals(self, visuals):
        """Encode unique images, one batched tower call per group of
        same-shape images -> [(feats (T, D) on the device, grid_thw)]."""
        cfg = self.config.vision
        hosts = []
        for v in visuals:
            if isinstance(v, str) and v.lower().endswith(VIDEO_EXTENSIONS):
                raise NotImplementedError("Qwen2.5-VL video scoring is not "
                                          "ported yet")
            hosts.append(_load_uint8(v))
        groups = {}
        for i, img in enumerate(hosts):
            groups.setdefault(img.shape, []).append(i)
        mu = cfg.merge_unit
        out = [None] * len(hosts)
        for (h0, w0, _), idxs in groups.items():
            hb, wb = smart_resize(h0, w0, cfg.patch_size * cfg.merge_size,
                                  IMAGE_MIN_PIXELS, IMAGE_MAX_PIXELS)
            grid = (1, hb // cfg.patch_size, wb // cfg.patch_size)
            s = grid[1] * grid[2]
            sb = _bucket(s, PATCH_BUCKETS)
            perm, pos_hw, win_seg, full_seg, reverse, tiled = \
                self._device_geometry(grid, s, sb)
            n = len(idxs)
            stack = np.stack([hosts[i] for i in idxs]).reshape(n, h0, w0 * 3)
            pixels = torch.from_numpy(stack).to(self.device)
            rows = q.image_patches(pixels, cfg, hb, wb)[:, perm]
            if rows.shape[1] < sb:
                rows = torch.nn.functional.pad(rows, (0, 0, 0, sb - rows.shape[1]))
            feats = q.vision_tower_batch(
                self.params.vision, cfg, rows, pos_hw.expand(n, -1, -1),
                win_seg.expand(n, -1), full_seg.expand(n, -1),
                reverse.expand(n, -1), tiled=tiled)
            for row, i in enumerate(idxs):
                out[i] = (feats[row, : s // mu], grid)
        return out

    # ------------------------------------------------------------------
    # prompts
    # ------------------------------------------------------------------

    def _encode_text(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _build_ids(self, question, n_vis):
        cfg = self.config
        pre = self._encode_text(_CHAT_PRE)
        post = self._encode_text(_CHAT_POST.format(question=question))
        return (pre + [cfg.vision_start_token_id] + [cfg.image_token_id] * n_vis
                + [cfg.vision_end_token_id] + post)

    def _prepare_pairs(self, visuals, questions):
        """visuals: list of images (len P, may repeat); questions len P ->
        host arrays of the batched prefill, the per-pair features on the
        device, and the prompt lengths."""
        cfg = self.config
        uniq, inv, seen = [], [], {}
        for v in visuals:
            key = v if isinstance(v, (str, bytes)) else id(v)
            if key not in seen:
                seen[key] = len(uniq)
                uniq.append(v)
            inv.append(seen[key])
        encoded = self._encode_visuals(uniq)

        p = len(visuals)
        mu = cfg.vision.merge_unit
        ids_list = [self._build_ids(questions[j],
                                    int(np.prod(encoded[inv[j]][1])) // mu)
                    for j in range(p)]
        s = _bucket(max(len(x) for x in ids_list), SEQ_BUCKETS)
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
            pos[:, j, :n] = q.build_rope_index(arr, [encoded[inv[j]][1]], cfg)
            prompt_lens.append(n)
        # per-pair features gathered on the device from the unique images'
        t_max = max(max(e[0].shape[0] for e in encoded), 1)
        padded = torch.stack([torch.nn.functional.pad(
            e[0], (0, 0, 0, t_max - e[0].shape[0])) for e in encoded])
        feats = padded[torch.as_tensor(inv, device=padded.device)]
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
        """Pairwise scoring -> (scores, count). The scores stay on the
        device until ``np.asarray`` copies them to the host, so a caller can
        queue the next chunk first (``Score.batch_forward``)."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        arrays, prompt_lens = self._prepare_pairs(images, questions)
        ids, feats, vis_mask, vis_slot, pos, attn = arrays

        ans_tok = [self._encode_text(a) for a in answers]
        a_max = max(len(a) for a in ans_tok)
        pcount = len(images)
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

        dev = [torch.from_numpy(a).to(self.device)
               for a in (full_ids, vis_mask, vis_slot, pos, attn, ans_ids,
                         ans_pos, ans_mask)]
        logp = q.splice_and_score(self.params, self.config, dev[0], feats,
                                  *dev[1:], temperature=float(temperature))
        return _HostScores(torch.exp(logp.float())), pcount

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        flat_txts = list(texts) * m
        return self.forward(flat_imgs, flat_txts, **kw).reshape(m, n)
