"""CLIP-FlanT5 scoring engine: host batch assembly + device passes (port of
t2v_metrics_tpu/engine/scoring.py:CLIPT5Engine, without generation).

  1. one vision-tower pass per unique image (M), kept as (M, T, D) features;
  2. one teacher-forced encoder+decoder pass per chunk of pairs, with shapes
     padded to the same buckets as the JAX package;
  3. fp32 log-softmax on the device; only the (P,) scores return to the host.

Images: same-shape uint8 HWC arrays no larger than 384 px ship at source
resolution and the whole preprocess (pad to square, Pillow-parity bicubic
resize, normalize) runs on the device. Anything else is loaded and resized
on the host (Pillow-parity numpy resize; paths decode with PIL).
"""

from __future__ import annotations

import numpy as np
import torch

from t2v_metrics_tpu.constants import (CLIP_MEAN, CLIP_STD,
                                       DEFAULT_ANSWER_TEMPLATE,
                                       DEFAULT_QUESTION_TEMPLATE,
                                       IMAGE_TOKEN_INDEX)
from t2v_metrics_tpu.tokenization import splice_image_tokens_t5

from ..models import clip_flant5 as tcft5
from ..ops import image as timage


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 63) // 64) * 64


ENC_BUCKETS = (640, 704, 768, 896, 1024, 1280, 1536, 2048)
ANS_BUCKETS = (4, 8, 16, 32, 64)
IMG_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
TXT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

_DEVICE_RESIZE_MAX_SIDE = 384


def _device_resize_batch(images) -> np.ndarray | None:
    """(N, H, W*3) channel-flattened uint8 stack if every image is a
    same-shape uint8 HWC array no larger than 384 px; else None (host
    path)."""
    if not images:
        return None
    first = images[0]
    if not (isinstance(first, np.ndarray) and first.dtype == np.uint8
            and first.ndim == 3 and first.shape[2] == 3
            and max(first.shape[:2]) <= _DEVICE_RESIZE_MAX_SIDE):
        return None
    for im in images[1:]:
        if not (isinstance(im, np.ndarray) and im.dtype == np.uint8
                and im.shape == first.shape):
            return None
    h, w, c = first.shape
    return np.stack(images).reshape(len(images), h, w * c)


def _load_uint8(image) -> np.ndarray:
    """A path, PIL image or array -> uint8 RGB HWC."""
    if isinstance(image, np.ndarray):
        arr = image
    else:
        from PIL import Image  # only paths and PIL images need Pillow

        img = image if isinstance(image, Image.Image) else Image.open(image)
        arr = np.asarray(img.convert("RGB"))
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def _expand2square(img: np.ndarray, fill_rgb) -> np.ndarray:
    h, w, c = img.shape
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side, c), dtype=img.dtype)
    out[:] = np.asarray(fill_rgb, dtype=img.dtype)
    if w > h:
        top = (side - h) // 2
        out[top:top + h] = img
    else:
        left = (side - w) // 2
        out[:, left:left + w] = img
    return out


def _host_resize_batch(images, size: int, pad_square: bool) -> np.ndarray:
    """Host preprocess to (N, size, size*3) uint8 with Pillow's uint8 resize
    pipeline (pad mode: expand2square with the CLIP-mean fill first)."""
    out = []
    for image in images:
        img = _load_uint8(image)
        if pad_square:
            img = _expand2square(img, tuple(int(m * 255) for m in CLIP_MEAN))
            img = timage.resize_np(img, size, size, quantize_uint8=True)
        else:
            rh, rw = timage.resize_shortest_side(img.shape[:2], size)
            img = timage.resize_np(img, rh, rw, quantize_uint8=True)
            top, left = (rh - size) // 2, (rw - size) // 2
            img = img[top:top + size, left:left + size]
        out.append(img.astype(np.uint8).reshape(size, size * 3))
    return np.stack(out)


class _HostScores:
    """Scores still on the device. ``np.asarray`` on it copies them to the
    host (waiting for the device), so a caller can queue further chunks
    before it reads this one."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        arr = self.t.float().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class CLIPT5Engine:
    """Device engine for CLIP-FlanT5 VQAScore. Parameters live on
    ``device``; public methods take host data and return numpy."""

    def __init__(self, params: tcft5.CLIPT5Model, cfg: tcft5.CLIPT5Config,
                 tokenizer, device, max_pairs_per_call: int = 128):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.max_pairs = max_pairs_per_call

    # -- device passes --------------------------------------------------------

    @torch.inference_mode()
    def _encode(self, pixels: np.ndarray) -> torch.Tensor:
        """(M, H, W*3) uint8 -> (M, T, D) image features on the device."""
        cfg = self.cfg
        x = torch.from_numpy(pixels).to(self.device).float() / 255.0
        s = cfg.vision.image_size
        h, w = x.shape[-2], x.shape[-1] // 3
        if h != s or w != s:
            if cfg.image_aspect_ratio == "pad":
                # PIL fills with tuple(int(m*255)): match exactly
                fill = [int(m * 255) / 255.0 for m in CLIP_MEAN]
                x = timage.pad_square_flat(x, 3, fill)
                x = timage.resize_flat(x, s, s, 3)
            else:
                rh, rw = timage.resize_shortest_side((h, w), s)
                x = timage.resize_flat(x, rh, rw, 3)
                x = timage.center_crop_flat(x, s, s, 3)
            x = torch.clamp(x, 0.0, 1.0)  # PIL clamps each resize pass
        x = timage.normalize_flat(x, CLIP_MEAN, CLIP_STD)
        return tcft5.image_features(self.params, cfg, x)

    @torch.inference_mode()
    def _score(self, feats, arrays, pair_image, pair_text) -> torch.Tensor:
        dev = [torch.from_numpy(a).to(self.device) for a in arrays]
        return tcft5.score_pairs(
            self.params, self.cfg, feats, *dev,
            torch.from_numpy(pair_image).to(self.device).long(),
            torch.from_numpy(pair_text).to(self.device).long())

    # -- host-side assembly ---------------------------------------------------

    def _build_text_arrays(self, questions, answers):
        """Tokenize + splice questions; bucket-pad; return numpy arrays."""
        T = self.cfg.num_image_tokens
        spliced = [splice_image_tokens_t5(q, self.tokenizer) for q in questions]
        ans_tok = [self.tokenizer(a).input_ids for a in answers]

        enc_lens = [len(s) - 1 + T for s in spliced]
        S = _bucket(max(enc_lens), ENC_BUCKETS)
        A = _bucket(max(len(a) for a in ans_tok), ANS_BUCKETS)
        n = len(questions)

        ids = np.zeros((n, S), np.int32)
        img_mask = np.zeros((n, S), bool)
        img_slot = np.zeros((n, S), np.int32)
        enc_mask = np.zeros((n, S), bool)
        ans_ids = np.zeros((n, A), np.int32)
        ans_mask = np.zeros((n, A), np.float32)

        for j, (toks, ans) in enumerate(zip(spliced, ans_tok)):
            pos = 0
            for t in toks:
                if t == IMAGE_TOKEN_INDEX:
                    img_mask[j, pos:pos + T] = True
                    img_slot[j, pos:pos + T] = np.arange(T)
                    pos += T
                else:
                    ids[j, pos] = t
                    pos += 1
            enc_mask[j, :pos] = True
            ans_ids[j, :len(ans)] = ans
            ans_mask[j, :len(ans)] = 1.0
        return ids, img_mask, img_slot, enc_mask, ans_ids, ans_mask

    def _pixels(self, images) -> np.ndarray:
        pixels = _device_resize_batch(images)
        if pixels is None:
            pixels = _host_resize_batch(images, self.cfg.vision.image_size,
                                        self.cfg.image_aspect_ratio == "pad")
        m = len(images)
        mb = _bucket(m, IMG_BUCKETS)
        if mb > m:
            pixels = np.concatenate([pixels, np.repeat(pixels[-1:], mb - m, axis=0)])
        return pixels

    def _prompts(self, texts, question_template, answer_template):
        qt = question_template or DEFAULT_QUESTION_TEMPLATE
        at = answer_template or DEFAULT_ANSWER_TEMPLATE
        conv = self.cfg.conversation
        return ([tcft5.format_question(qt.format(t), conv) for t in texts],
                [tcft5.format_answer(at.format(t), conv) for t in texts])

    def encode_images(self, images) -> torch.Tensor:
        """images: list of paths/arrays -> (M, T, D) device features."""
        return self._encode(self._pixels(images))[: len(images)]

    # -- scoring --------------------------------------------------------------

    def score_matrix(self, images, texts, question_template: str | None = None,
                     answer_template: str | None = None) -> np.ndarray:
        """(M images) x (N texts) -> (M, N) float32 scores = exp(mean logp)."""
        questions, answers = self._prompts(texts, question_template,
                                           answer_template)
        return np.exp(self._score_pairs_all(images, questions, answers))

    def _score_pairs_all(self, images, questions, answers) -> np.ndarray:
        m, n = len(images), len(questions)
        feats = self.encode_images(images)
        arrays = _pad_rows(self._build_text_arrays(questions, answers),
                           _bucket(n, TXT_BUCKETS))
        pair_image = np.repeat(np.arange(m, dtype=np.int32), n)
        pair_text = np.tile(np.arange(n, dtype=np.int32), m)
        p = m * n
        chunk = min(self.max_pairs, p)
        out = np.empty((p,), np.float32)
        for lo in range(0, p, chunk):
            hi = min(lo + chunk, p)
            pi, pt = pair_image[lo:hi], pair_text[lo:hi]
            if hi - lo < chunk:  # pad the last chunk
                pad = chunk - (hi - lo)
                pi = np.concatenate([pi, np.repeat(pi[-1:], pad)])
                pt = np.concatenate([pt, np.repeat(pt[-1:], pad)])
            logp = self._score(feats, arrays, pi, pt)
            out[lo:hi] = logp.float().cpu().numpy()[: hi - lo]
        return out.reshape(m, n)

    def forward_pairwise(self, images, texts, question_template=None,
                         answer_template=None) -> np.ndarray:
        """len(images) == len(texts) paired scoring -> (P,) scores."""
        dev, n = self.forward_device_prepared(
            self.prepare_pairs(images, texts, question_template,
                               answer_template))
        return np.asarray(dev, np.float32)[:n]

    def prepare_pairs(self, images, texts, question_template=None,
                      answer_template=None):
        """Host stage of pairwise scoring: decode/resize pixels, tokenize and
        splice texts, bucket-pad; no device work."""
        if len(images) != len(texts):
            raise ValueError("prepare_pairs: one image per text")
        uniq, inv, seen = [], [], {}
        for im in images:  # repeated [img]*N calls still encode once
            key = id(im) if not isinstance(im, (str, bytes)) else im
            if key not in seen:
                seen[key] = len(uniq)
                uniq.append(im)
            inv.append(seen[key])
        questions, answers = self._prompts(texts, question_template,
                                           answer_template)
        n = len(texts)
        nb = _bucket(n, TXT_BUCKETS)
        arrays = _pad_rows(self._build_text_arrays(questions, answers), nb)
        pair_image = _pad_rows((np.asarray(inv, np.int32),), nb)[0]
        pair_text = _pad_rows((np.arange(n, dtype=np.int32),), nb)[0]
        return {"pixels": self._pixels(uniq), "m": len(uniq), "arrays": arrays,
                "pair_image": pair_image, "pair_text": pair_text, "n": n}

    def forward_device_prepared(self, prep):
        """Device stage: returns (scores still on the device, valid count)."""
        feats = self._encode(prep["pixels"])[: prep["m"]]
        logp = self._score(feats, prep["arrays"], prep["pair_image"],
                           prep["pair_text"])
        return _HostScores(torch.exp(logp)), prep["n"]


def _pad_rows(arrays, nb: int):
    """Pad each array's rows to ``nb`` by repeating its last row."""
    n = len(arrays[0])
    if nb <= n:
        return tuple(arrays)
    return tuple(np.concatenate([a, np.repeat(a[-1:], nb - n, axis=0)])
                 for a in arrays)
