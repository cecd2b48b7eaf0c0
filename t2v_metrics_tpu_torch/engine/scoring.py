"""Scoring engines: host batch assembly + device passes (port of
t2v_metrics_tpu/engine/scoring.py: ``CLIPT5Engine`` and ``CLIPEngine``).

CLIP-FlanT5 (VQAScore):
  1. one vision-tower pass per unique image (M), kept as (M, T, D) features;
  2. one teacher-forced encoder+decoder pass per chunk of pairs, with shapes
     padded to the same buckets as the JAX package;
  3. fp32 log-softmax on the device; only the (P,) scores return to the host.
``CLIPT5Engine.generate`` encodes the batch once (padded to the text
buckets by repeating the last row, as in the JAX package) and decodes it
greedily with the cached T5 step, reading the tokens back once at the end.

CLIPScore: one image-tower pass over the M images and one text-tower pass
over the N texts (each padded to the JAX package's buckets), the fp32
cosine matrix on the device; pairwise scoring encodes each distinct image
and text once.

Images: same-shape uint8 HWC arrays no larger than 384 px ship at source
resolution and the whole preprocess (CLIP-FlanT5: pad to square; CLIPScore:
shortest side and centre crop; a float bicubic resize, normalize) runs on
the device, as the JAX engines' device path. Anything else is decoded on the
host (paths with PIL; ``.npy`` paths, BGR arrays, with numpy), goes to the
device as uint8 and is padded or resized and cropped there with Pillow's
uint8 resize, bit for bit (``pillow_resize_batch``), as the JAX engines'
host path does with Pillow.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import tracing
from ..tracing import to_host
from ..constants import (CLIP_MEAN, CLIP_STD, DEFAULT_ANSWER_TEMPLATE,
                         DEFAULT_QUESTION_TEMPLATE, IMAGE_TOKEN_INDEX)
from ..media.video import MediaError
from ..models import clip as tclip
from ..models import clip_flant5 as tcft5
from ..models import t5 as tt5
from ..ops import image as timage
from ..tokenization import splice_image_tokens_t5


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


def _stack_host(arrays, device) -> torch.Tensor:
    """Same-shape uint8 HWC arrays stacked into one (n, H, W*3) host tensor
    for ``tracing.to_device``, page-locked where ``device`` is CUDA."""
    h, w, c = arrays[0].shape
    out = tracing.host_empty((len(arrays), h, w * c), torch.uint8, device)
    np.stack(arrays, out=out.numpy().reshape(len(arrays), h, w, c))
    return out


def _device_resize_batch(images, device) -> torch.Tensor | None:
    """(N, H, W*3) channel-flattened uint8 host stack (``_stack_host``) if
    every image is a same-shape uint8 HWC array no larger than 384 px; else
    None (host path)."""
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
    with tracing.span("engine.decode"):
        return _stack_host(images, device)


def _load_uint8(image) -> np.ndarray:
    """A path, PIL image or array -> uint8 RGB HWC. A path ending in ``.npy``
    holds a BGR array (the reference's ``model.py:12-13``): it is flipped to
    RGB and, unless uint8, clipped to [0, 255] and truncated, with no
    Pillow."""
    if isinstance(image, np.ndarray):
        arr = image
    elif str(image).endswith(".npy"):  # no PIL image's str() ends so
        try:
            arr = np.load(image)[:, :, [2, 1, 0]]
        except (OSError, ValueError, IndexError) as e:  # missing, truncated, not HWC
            raise MediaError(f"cannot read image {image}: {e}") from e
    else:
        from PIL import Image  # only paths and PIL images need Pillow

        try:
            img = image if isinstance(image, Image.Image) else Image.open(image)
            arr = np.asarray(img.convert("RGB"))
        except OSError as e:  # missing, truncated or not an image
            raise MediaError(f"cannot read image {image}: {e}") from e
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def encode_by_shape(visuals, device, encode) -> list:
    """Each visual's features on ``device``: the visuals decoded to uint8
    HWC and grouped by shape; each group stacked to (n, H, W*3) uint8 on the
    device goes through ``encode`` in one call (one preprocess and tower call
    a group), and each visual gets its row of the result. The stacks are
    built in page-locked memory where ``device`` is CUDA."""
    with tracing.span("engine.decode"):
        hosts = [_load_uint8(v) for v in visuals]
        groups = {}
        for i, img in enumerate(hosts):
            groups.setdefault(img.shape, []).append(i)
    out = [None] * len(hosts)
    for idxs in groups.values():
        with tracing.span("engine.decode"):
            stack = _stack_host([hosts[i] for i in idxs], device)
        feats = encode(tracing.to_device(stack, device))
        for row, i in enumerate(idxs):
            out[i] = feats[row]
    return out


def _pillow_resize(pixels: torch.Tensor, size: int, pad_square: bool) -> torch.Tensor:
    """(n, H, W*3) uint8 -> (n, size, size*3) uint8 as the JAX package's
    ``media.images.load_batch(raw_uint8=True)`` makes it with Pillow: pad mode
    expand2square with the CLIP-mean fill then the resize to size x size;
    otherwise the resize of the shortest side to ``size``, then the centre
    crop."""
    if pad_square:
        x = timage.pad_square_flat(pixels, 3, tuple(int(m * 255) for m in CLIP_MEAN))
        x = timage.resize_uint8_pillow_flat(x, size, size, 3)
    else:
        rh, rw = timage.resize_shortest_side((pixels.shape[-2], pixels.shape[-1] // 3), size)
        x = timage.center_crop_flat(timage.resize_uint8_pillow_flat(pixels, rh, rw, 3),
                                    size, size, 3)
    return x.to(torch.uint8)


def pillow_resize_batch(images, size: int, pad_square: bool, device) -> torch.Tensor:
    """Images (paths, PIL images or uint8 arrays of any sizes) -> (N, size,
    size*3) uint8 on ``device``: decoded on the host, each group of same-shape
    images resized in one call on the device by ``_pillow_resize``."""
    return torch.stack(encode_by_shape(
        images, device, lambda x: _pillow_resize(x, size, pad_square)))


def clip_pixels(pixels: torch.Tensor, size: int, pad_square: bool) -> torch.Tensor:
    """(M, H, W*3) uint8 on the device -> (M, size, size*3) normalized fp32:
    /255, and where the image is not size x size, padded to square with the
    CLIP-mean fill (``pad_square``) or resized to the shortest side and
    centre-cropped, bicubic in fp32, then clipped to [0, 1] (PIL clamps each
    resize pass); then the CLIP mean and std."""
    x = pixels.float() / 255.0
    h, w = x.shape[-2], x.shape[-1] // 3
    if h != size or w != size:
        if pad_square:
            # PIL fills with tuple(int(m*255)): match exactly
            fill = [int(m * 255) / 255.0 for m in CLIP_MEAN]
            x = timage.pad_square_flat(x, 3, fill)
            x = timage.resize_flat(x, size, size, 3)
        else:
            rh, rw = timage.resize_shortest_side((h, w), size)
            x = timage.resize_flat(x, rh, rw, 3)
            x = timage.center_crop_flat(x, size, size, 3)
        x = torch.clamp(x, 0.0, 1.0)
    return timage.normalize_flat(x, CLIP_MEAN, CLIP_STD)


def _pixels_bucketed(images, size: int, pad_square: bool, device) -> torch.Tensor:
    """(bucket, size-or-source H, W*3) uint8 on ``device``: the device path's
    stack at source size or ``pillow_resize_batch``'s, its rows padded to
    ``IMG_BUCKETS`` with the last."""
    stack = _device_resize_batch(images, device)
    if stack is None:
        pixels = pillow_resize_batch(images, size, pad_square, device)
    else:
        pixels = tracing.to_device(stack, device)
    return pad_rows_to(pixels, _bucket(len(images), IMG_BUCKETS))


def pad_rows_to(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Pad a tensor's rows to ``nb`` by repeating its last row."""
    if nb <= x.shape[0]:
        return x
    return torch.cat([x, x[-1:].expand(nb - x.shape[0], *x.shape[1:])])


class _HostScores:
    """Scores still on the device. ``np.asarray`` on it copies them to the
    host (waiting for the device), so a caller can queue further chunks
    before it reads this one."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        arr = to_host(self.t)
        return arr if dtype is None else arr.astype(dtype)


class _Parallel:
    """An engine's mesh (``parallel/mesh.py``): the model sharded over it
    (tensor and expert parallelism), its images split over the data axes
    by image, and the mesh ambient while the device works (sequence
    parallelism). Without a mesh: one rank, no collective."""

    def __init__(self, params, mesh):
        self.mesh = mesh
        self.data = None
        if mesh is not None:
            from ..parallel import mesh as pmesh

            pmesh.shard_params(params, mesh)
            self.data = pmesh.data_sharding(mesh, 1)

    def ambient(self):
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    @property
    def ranks(self) -> int:
        """The data-parallel ranks (1 without a mesh)."""
        return 1 if self.data is None else self.data.count

    def rows(self, n: int) -> slice:
        """This rank's share of ``n`` images."""
        return slice(0, n) if self.data is None else self.data.rows(n)

    def gather_rows(self, local: np.ndarray, n: int, device) -> np.ndarray:
        """The ranks' ``rows(n)`` of a matrix joined on every rank."""
        if self.ranks == 1:
            return local
        t = torch.from_numpy(np.ascontiguousarray(local, np.float32)).to(device)
        return self.data.gather(t, n).cpu().numpy()

    def split_pairs(self, images):
        """(this rank's pair indices, the owner of each pair): the pairs go
        with their image, each distinct image to one rank's ``rows``."""
        uniq, inv = unique_visuals(images)
        chunk = -(-len(uniq) // self.ranks)
        owners = [u // chunk for u in inv]
        me = self.data.mesh.axis_index(self.data.axes)
        return [j for j, o in enumerate(owners) if o == me], owners

    def gather_pairs(self, local: torch.Tensor, owners) -> torch.Tensor:
        """Each rank's scores of its pairs (``split_pairs``) joined into the
        scores of all pairs, in order, on every rank."""
        counts = np.bincount(owners, minlength=self.ranks)
        width = int(counts.max())
        pad = local.new_zeros((width - local.shape[0],))
        parts = self.mesh.all_gather(torch.cat([local.float(), pad]), self.data.axes)
        parts = parts.reshape(self.ranks, width)
        out = local.new_empty((len(owners),), dtype=torch.float32)
        for k in range(self.ranks):
            idx = torch.as_tensor([j for j, o in enumerate(owners) if o == k],
                                  dtype=torch.long, device=out.device)
            out[idx] = parts[k, :counts[k]]
        return out


class CLIPT5Engine:
    """Device engine for CLIP-FlanT5 VQAScore. Parameters live on
    ``device``; public methods take host data and return numpy.

    ``mesh`` (``parallel/mesh.py``): the model is sharded over it in place
    (tensor parallelism), the pairs are split over its data axes by image,
    so each image is still encoded once, and every rank returns all the
    scores; a mesh with an sp axis runs the T5 encoder sequence-parallel.
    """

    def __init__(self, params: tcft5.CLIPT5Model, cfg: tcft5.CLIPT5Config,
                 tokenizer, device, max_pairs_per_call: int = 128, mesh=None):
        self.par = _Parallel(params, mesh)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.max_pairs = max_pairs_per_call
        self.copies = tracing.CopyStream(self.device)

    # -- device passes --------------------------------------------------------

    @torch.inference_mode()
    def _encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """(M, H, W*3) uint8 on the device -> (M, T, D) image features."""
        cfg = self.cfg
        with tracing.span("engine.encode"):
            x = clip_pixels(pixels, cfg.vision.image_size, cfg.image_aspect_ratio == "pad")
            with self.par.ambient():
                return tcft5.image_features(self.params, cfg, x)

    @torch.inference_mode()
    def _score(self, feats, arrays, pair_image, pair_text, real: int) -> torch.Tensor:
        """(P,) log scores on the device of the pairs ``pair_image`` x
        ``pair_text``, the first ``real`` of them the caller's and the rest
        padding. Traced, it counts the encoder's rows, all and the real
        pairs'."""
        with tracing.span("engine.score"):
            if tracing.enabled():
                enc_mask = arrays[3]
                tracing.count("t5_enc_rows", len(pair_text) * enc_mask.shape[1])
                tracing.count("t5_enc_rows_valid", int(enc_mask[pair_text[:real]].sum()))
            dev = [tracing.to_device(a, self.device) for a in arrays]
            pi = tracing.to_device(pair_image, self.device).long()
            pt = tracing.to_device(pair_text, self.device).long()
            with self.par.ambient():
                return tcft5.score_pairs(self.params, self.cfg, feats, *dev, pi, pt)

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

    def _pixels(self, images) -> torch.Tensor:
        return _pixels_bucketed(images, self.cfg.vision.image_size,
                                self.cfg.image_aspect_ratio == "pad", self.device)

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
        with tracing.span("engine.tokenize"):
            questions, answers = self._prompts(texts, question_template,
                                               answer_template)
        rows = self.par.rows(len(images))
        local = (self._score_pairs_all(images[rows], questions, answers)
                 if rows.stop > rows.start else np.zeros((0, len(texts)), np.float32))
        return np.exp(self.par.gather_rows(local, len(images), self.device))

    def _score_pairs_all(self, images, questions, answers) -> np.ndarray:
        m, n = len(images), len(questions)
        feats = self.encode_images(images)
        with tracing.span("engine.tokenize"):
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
            logp = self._score(feats, arrays, pi, pt, hi - lo)
            out[lo:hi] = to_host(logp)[: hi - lo]
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
        """Host stage of pairwise scoring: decode the images and send them to
        the device (resized there where they take Pillow's resize) on the
        engine's copy stream, tokenize and splice texts, bucket-pad. Over
        data-parallel ranks, each rank prepares the pairs of its share of the
        distinct images, as one rank would for those pairs alone."""
        if len(images) != len(texts):
            raise ValueError("prepare_pairs: one image per text")
        if self.par.ranks > 1:
            mine, owners = self.par.split_pairs(images)
            local = (self._prepare([images[j] for j in mine], [texts[j] for j in mine],
                                   question_template, answer_template)
                     if mine else None)
            return {"dp": (local, owners), "n": len(texts)}
        return self._prepare(images, texts, question_template, answer_template)

    def _prepare(self, images, texts, question_template, answer_template):
        uniq, inv = unique_visuals(images)  # repeated [img]*N calls still encode once
        n = len(texts)
        nb = _bucket(n, TXT_BUCKETS)
        with tracing.span("engine.tokenize"):
            questions, answers = self._prompts(texts, question_template,
                                               answer_template)
            arrays = _pad_rows(self._build_text_arrays(questions, answers), nb)
        pair_image = _pad_rows((np.asarray(inv, np.int32),), nb)[0]
        pair_text = _pad_rows((np.arange(n, dtype=np.int32),), nb)[0]
        return {"pixels": self.copies.run(self._pixels, uniq), "m": len(uniq), "arrays": arrays,
                "pair_image": pair_image, "pair_text": pair_text, "n": n}

    def forward_device_prepared(self, prep):
        """Device stage: returns (scores still on the device, valid count);
        over data-parallel ranks, every rank's scores of all the pairs."""
        if "dp" in prep:
            local, owners = prep["dp"]
            scores = (self.forward_device_prepared(local)[0].t[:local["n"]] if local
                      else torch.zeros((0,), device=self.device))
            return _HostScores(self.par.gather_pairs(scores, owners)), prep["n"]
        feats = self._encode(prep["pixels"].take())[: prep["m"]]
        logp = self._score(feats, prep["arrays"], prep["pair_image"],
                           prep["pair_text"], prep["n"])
        return _HostScores(torch.exp(logp)), prep["n"]

    # -- generation -----------------------------------------------------------

    @torch.inference_mode()
    def _encode_hidden(self, feats, arrays, pair_image, pair_text) -> torch.Tensor:
        """The T5 encoder hidden of the pairs' spliced prompts."""
        ids, img_mask, img_slot, enc_mask = arrays
        cfg = self.cfg
        embeds = tcft5._pair_embeds(self.params, feats, ids, img_mask, img_slot,
                                    pair_image, pair_text)
        with self.par.ambient():
            return tt5.encode(self.params.t5, cfg.t5, embeds, enc_mask[pair_text])

    @torch.inference_mode()
    def generate(self, images, texts, max_new_tokens: int = 128, **_) -> list[str]:
        """Greedy T5 continuation conditioned on the images (the v3.0
        CLIP-FlanT5 LLaVA-style generate): one encoder pass for the batch,
        then cached decode steps with no host round-trip until the tokens
        are read."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        cfg = self.cfg
        eos = getattr(self.tokenizer, "eos_token_id", 1)
        n = len(texts)
        questions = [tcft5.format_question(t, cfg.conversation) for t in texts]
        feats = self.encode_images(images)
        nb = _bucket(n, TXT_BUCKETS)
        arrays = _pad_rows(self._build_text_arrays(questions, [""] * n)[:4], nb)
        if nb > n:
            feats = torch.cat([feats, feats[-1:].expand(nb - n, -1, -1)])
        dev = [torch.from_numpy(a).to(self.device) for a in arrays]
        idx = torch.arange(nb, device=self.device)
        enc_hidden = self._encode_hidden(feats, dev, idx, idx)
        tokens = tt5.greedy_decode(self.params.t5, cfg.t5, enc_hidden, dev[3],
                                   max_new_tokens, eos).cpu().numpy()
        outs = []
        for row in tokens[:n]:
            gen = [int(t) for t in row if t != 0]
            try:
                outs.append(self.tokenizer.decode(gen, skip_special_tokens=True).strip())
            except TypeError:
                outs.append(self.tokenizer.decode(gen).strip())
        return outs


class CLIPEngine:
    """CLIPScore engine: batched dual-encoder cosine similarity. Parameters
    live on ``device``; public methods take host data and return numpy."""

    def __init__(self, params: tclip.CLIPModel, vcfg: tclip.CLIPVisionConfig,
                 tcfg: tclip.CLIPTextConfig, tokenizer, device, mesh=None):
        self.par = _Parallel(params, mesh)   # TP; images split over dp
        self.params = params
        self.vcfg, self.tcfg = vcfg, tcfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)

    def _tokenize(self, texts) -> np.ndarray:
        """(N, context_length) int32 ids, cut to the context, zero-padded."""
        ctx = self.tcfg.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenizer(t).input_ids[:ctx]
            out[i, : len(ids)] = ids
        return out

    @torch.inference_mode()
    def score_matrix(self, images, texts, **_) -> np.ndarray:
        """(M images) x (N texts) -> (M, N) float32 cosine similarities."""
        m, n = len(images), len(texts)
        rows = self.par.rows(m)
        ids = _pad_rows((self._tokenize(texts),), _bucket(n, TXT_BUCKETS))[0]
        with self.par.ambient():
            txf = tclip.encode_text(self.params, self.tcfg,
                                    torch.from_numpy(ids).to(self.device).long())[:n]
            local = np.zeros((0, n), np.float32)
            if rows.stop > rows.start:
                mine = images[rows]
                pixels = clip_pixels(
                    _pixels_bucketed(mine, self.vcfg.image_size, False, self.device),
                    self.vcfg.image_size, False)
                imf = tclip.encode_image(self.params, self.vcfg, pixels)[:len(mine)]
                local = (imf.float() @ txf.float().T).cpu().numpy()
        return self.par.gather_rows(local, m, self.device)

    def forward_pairwise(self, images, texts, **_) -> np.ndarray:
        """len(images) == len(texts) paired scoring -> (P,): each distinct
        image and text is encoded once (a batch_forward chunk repeats each
        image over its texts)."""
        if len(images) != len(texts):
            raise ValueError("forward_pairwise: one image per text")
        uimg, iinv = unique_visuals(images)
        utxt, tinv = unique_visuals(texts)
        return self.score_matrix(uimg, utxt)[iinv, tinv].copy()


def unique_visuals(visuals):
    """(distinct items, index of each among them): a path or text counts as
    itself, an array or image object by identity."""
    uniq, inv, seen = [], [], {}
    for v in visuals:
        key = v if isinstance(v, (str, bytes)) else id(v)
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(v)
        inv.append(seen[key])
    return uniq, inv


def pair_features(encoded, inv) -> torch.Tensor:
    """Each pair's visual features (P, T, D): the distinct visuals' (T_i,
    D) features padded with zero rows to the longest, row ``inv[j]`` for
    pair j."""
    t_max = max(f.shape[0] for f in encoded)
    padded = torch.stack([torch.nn.functional.pad(f, (0, 0, 0, t_max - f.shape[0]))
                          for f in encoded])
    return padded[torch.as_tensor(inv, device=padded.device)]


def image_slot_arrays(prompts, s: int, image_token_id: int):
    """(ids, vis_mask, vis_slot) (B, s) of prompt id lists padded to ``s``:
    ``vis_mask`` true at each prompt's ``image_token_id`` slots,
    ``vis_slot`` numbering them in order."""
    b = len(prompts)
    ids = np.zeros((b, s), np.int64)
    vis_mask = np.zeros((b, s), bool)
    vis_slot = np.zeros((b, s), np.int64)
    for j, p in enumerate(prompts):
        ids[j, :len(p)] = p
        vis_mask[j, :len(p)] = ids[j, :len(p)] == image_token_id
        vis_slot[j][vis_mask[j]] = np.arange(vis_mask[j].sum())
    return ids, vis_mask, vis_slot


def _pad_rows(arrays, nb: int):
    """Pad each array's rows to ``nb`` by repeating its last row."""
    n = len(arrays[0])
    if nb <= n:
        return tuple(arrays)
    return tuple(np.concatenate([a, np.repeat(a[-1:], nb - n, axis=0)])
                 for a in arrays)
