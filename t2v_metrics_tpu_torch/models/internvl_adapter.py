"""InternVL VQAScore adapter (port of t2v_metrics_tpu/models/internvl_adapter.py).

Contract as the JAX adapter's (reference internvl_model.py): the
``internvl2_5`` conversation with ``<img>`` + ``<IMG_CONTEXT>`` x 256 per
tile + ``</img>`` in place of ``<image>`` (:344-377); the score is P(first
answer token) at the prompt's last row (:383-432), default question 'Does
this figure show "{}"? Please answer Yes or No.' and answer "Yes".

Images: ``dynamic_preprocess`` tiles (up to 12 + a thumbnail), a video
(a path, read with cv2, or a ``media.video.DecodedVideo``) 32 frames at
``round(linspace(0, total - 1, 32))``, each resized straight to one 448 tile
(:293-322). The resizes run on the device (``ops/image.py:
resize_uint8_pillow_flat``: Pillow's fixed-point uint8 bicubic bit for bit,
where the JAX adapter calls Pillow on the host; the card machine has no
Pillow). The tower runs once for
each distinct image or clip (the JAX adapter runs it once per pair; the
tower is per tile, so the numbers are the same).

``generate``: the batched greedy decode (``CachedLM.greedy_batch``, stopping
at the smallest stop id) for more than one visual without sampling, else one
sequence at a time (``CachedLM.greedy``, nucleus sampling when
``do_sample`` and ``temperature > 0``, with ``rng``, an
``np.random.Generator``); a video becomes ``Frame{i}: <image>`` blocks of
one tile each (``num_frames`` frames, default 16). The conversation's
separator is a stop id where the tokenizer knows it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.scoring import (_HostScores, _load_uint8, image_slot_arrays, pair_features,
                               unique_visuals)
from ..media.video import extract_frames, is_video
from ..ops.image import resize_uint8_pillow_flat
from . import internvl as ivl
from .adapters import VQAScoreModel, family_params
from .fastchat_utils import get_conv_template
from .generation import CachedLM, decode_text
from .qwen2vl import splice_embeds

DEFAULT_QUESTION = 'Does this figure show "{}"? Please answer Yes or No.'
DEFAULT_ANSWER = "Yes"


def _bucket(n: int) -> int:
    """Sequence length padded to a multiple of 64 (pad rows are masked and
    come after every scored row)."""
    return ((n + 63) // 64) * 64


class InternVLAdapter(VQAScoreModel):
    """InternVL 3 / 3.5 VQAScore adapter (images and videos).

    Weights: ``params`` (an ``InternVLModel``, or a pytree in the JAX
    package's layout carried over by ``bridge.py``); ``checkpoint`` (an HF
    InternVLForConditionalGeneration directory, either key layout, or a
    native tree); random from ``seed`` with ``init='random'`` (or a model
    without a hub repo); else the hub repo's snapshot from the local cache
    (never downloaded). kwargs also config, dtype (default bf16 on CUDA,
    fp32 on CPU), tokenizer (an object or a local directory; else
    SimpleT5Tokenizer, with a warning).
    """

    video_mode = "direct"
    conversation_template = "internvl2_5"

    def load_model(self):
        from ..bridge import internvl_from_numpy

        spec = ivl.INTERNVL_MODELS[self.model_name]
        cfg: ivl.InternVLConfig = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        self.params = family_params(self, spec["hf"], cfg, ivl.InternVLModel,
                                    ivl.init_internvl, ivl.convert_internvl,
                                    internvl_from_numpy)
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self._lm = CachedLM(cfg.text)

    def load_images(self, images):
        return images  # decoded and preprocessed in batches

    def _encode_text(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _tiles(self, visual, num_segments: int) -> torch.Tensor:
        """Normalized tiles (n, 448, 448*3) of an image or a video on the
        device: a video's frames each resized to one tile."""
        size = self.config.vision.image_size
        if is_video(visual):
            frames = np.stack(extract_frames(visual, num_segments, mode="linspace"))
            px = torch.from_numpy(frames.reshape(*frames.shape[:2], -1)).to(self.device)
            tiles = resize_uint8_pillow_flat(px, size, size, 3)
        else:
            img = _load_uint8(visual)
            px = torch.from_numpy(np.ascontiguousarray(img).reshape(img.shape[0], -1))
            tiles = ivl.tile_pixels(px.to(self.device), self.config.max_tiles, size)
        return ivl.preprocess_tiles(tiles)

    @torch.inference_mode()
    def _encode_visuals(self, visuals, num_segments: int):
        """Each visual's (tile count, features (tiles x 256, d_model)) on the
        device, one tower call a visual."""
        out = []
        for visual in visuals:
            feats = ivl.image_features(self.params, self.config,
                                       self._tiles(visual, num_segments))
            out.append((feats.shape[0], feats.flatten(0, 1)))
        return out

    def _build_ids(self, question: str, n_tiles: int) -> list[int]:
        """The scoring prompt: one image block of ``n_tiles`` tiles, ``<img>``
        encoded with the text before it (as the JAX adapter's forward)."""
        cfg = self.config
        conv = get_conv_template(self.conversation_template)
        conv.append_message(conv.roles[0], "<image>\n" + question)
        conv.append_message(conv.roles[1], None)
        pre, post = conv.get_prompt().split("<image>")
        return (self._encode_text(pre + cfg.img_start_token)
                + [cfg.image_token_id] * (cfg.tokens_per_tile * n_tiles)
                + self._encode_text(cfg.img_end_token + post))

    def _build_ids_multi(self, prompt: str, tiles_per_block: list[int]) -> list[int]:
        """The conversation prompt with each ``<image>`` expanded to <img> +
        <IMG_CONTEXT> x tokens_per_tile x tiles + </img> (reference
        _build_inputs, internvl_model.py:344-377)."""
        cfg = self.config
        conv = get_conv_template(self.conversation_template)
        conv.append_message(conv.roles[0], prompt)
        conv.append_message(conv.roles[1], None)
        chunks = conv.get_prompt().split("<image>")
        if len(chunks) != len(tiles_per_block) + 1:
            raise ValueError(f"{len(chunks) - 1} <image> placeholders for "
                             f"{len(tiles_per_block)} image blocks")
        ids = self._encode_text(chunks[0])
        for chunk, tiles in zip(chunks[1:], tiles_per_block):
            ids += self._encode_text(cfg.img_start_token)
            ids += [cfg.image_token_id] * (cfg.tokens_per_tile * tiles)
            ids += self._encode_text(cfg.img_end_token + chunk)
        return ids

    def forward(self, images, texts, **kw) -> np.ndarray:
        dev, n = self.forward_device(images, texts, **kw)
        return np.asarray(dev, np.float32)[:n]

    @torch.inference_mode()
    def forward_device(self, images, texts, question_template: str = DEFAULT_QUESTION,
                       answer_template: str = DEFAULT_ANSWER, num_segments: int = 32,
                       temperature: float = 1.0, **kw):
        """Pairwise scoring -> (scores still on the device, count): P(the
        answer's first token) at each prompt's last row."""
        if len(images) != len(texts):
            raise ValueError("forward_device: one image per text")
        uniq, inv = unique_visuals(images)
        encoded = self._encode_visuals(uniq, num_segments)
        prompts = [self._build_ids(question_template.format(t), encoded[inv[j]][0])
                   for j, t in enumerate(texts)]
        p = len(prompts)
        s = _bucket(max(len(x) for x in prompts))
        ids, vis_mask, vis_slot = image_slot_arrays(prompts, s, self.config.image_token_id)
        attn = np.arange(s)[None] < np.asarray([len(x) for x in prompts])[:, None]
        ans_ids = np.asarray([[self._encode_text(answer_template.format(t))[0]]
                              for t in texts], np.int64)
        ans_pos = np.asarray([[len(x) - 1] for x in prompts], np.int64)
        pos = np.broadcast_to(np.arange(s)[None], (p, s)).copy()
        dev = [torch.from_numpy(a).to(self.device)
               for a in (ids, vis_mask, vis_slot, pos, attn, ans_ids, ans_pos,
                         np.ones((p, 1), np.float32))]
        logp = ivl.splice_and_score(self.params, self.config, dev[0],
                                    pair_features([f for _, f in encoded], inv), *dev[1:],
                                    temperature=float(temperature))
        return _HostScores(torch.exp(logp)), p

    def score_matrix(self, images, texts, **kw) -> np.ndarray:
        m, n = len(images), len(texts)
        flat_imgs = [im for im in images for _ in range(n)]
        return self.forward(flat_imgs, list(texts) * m, **kw).reshape(m, n)

    # ------------------------------------------------------------------
    # generation (reference internvl_model.py:438-481)
    # ------------------------------------------------------------------

    def _eos_ids(self) -> set:
        """The tokenizer's eos id and the conversation separator's id (the
        reference's eos = convert_tokens_to_ids(sep), internvl_model.py:356-360)."""
        ids = set()
        t = getattr(self.tokenizer, "eos_token_id", None)
        if t is not None:
            ids.add(int(t))
        sep = get_conv_template(self.conversation_template).sep
        c2i = getattr(self.tokenizer, "convert_tokens_to_ids", None)
        if c2i is not None and sep:
            try:
                i = c2i(sep)
            except Exception:
                i = None
            if isinstance(i, int) and i >= 0:
                ids.add(i)
        return ids

    def _generation_embeds(self, visuals, texts, num_frames: int):
        """(embeds (B, S, D) on the device, prompt lengths (B,)): a video's
        frames as ``Frame{i}: <image>`` blocks of one tile, an image as one
        tiled block."""
        uniq, inv = unique_visuals(visuals)
        encoded = self._encode_visuals(uniq, num_frames)
        prompts = []
        for j, text in enumerate(texts):
            n_tiles = encoded[inv[j]][0]
            if is_video(uniq[inv[j]]):
                blocks = [1] * n_tiles
                prompt = "".join(f"Frame{i + 1}: <image>\n" for i in range(n_tiles)) + text
            else:
                blocks, prompt = [n_tiles], "<image>\n" + text
            prompts.append(self._build_ids_multi(prompt, blocks))
        s = max(max(len(x) for x in prompts), 8)
        arrays = [torch.from_numpy(a).to(self.device)
                  for a in image_slot_arrays(prompts, s, self.config.image_token_id)]
        embeds = splice_embeds(self.params, arrays[0], pair_features([f for _, f in encoded], inv),
                               *arrays[1:])[0]
        return embeds, np.asarray([len(x) for x in prompts], np.int64)

    @torch.inference_mode()
    def generate(self, images, texts, num_frames: int = 16, max_new_tokens: int = 1024,
                 do_sample=None, temperature: float = 0.0, top_p: float = 0.9, rng=None,
                 **kw) -> list[str]:
        """Greedy (or nucleus) continuation of each (visual, text) prompt."""
        if len(images) != len(texts):
            raise ValueError("generate: one image per text")
        eos = self._eos_ids()
        if do_sample is None:
            do_sample = temperature > 0
        sample = bool(do_sample and temperature > 0)
        if len(images) > 1 and not do_sample:
            embeds, lens = self._generation_embeds(images, texts, num_frames)
            b, s = embeds.shape[:2]
            tokens, lengths = self._lm.greedy_batch(
                self.params.decoder, embeds, np.tile(np.arange(s), (b, 1)), lens,
                max_new_tokens, eos_id=min(eos) if eos else None)
            return [decode_text(self.tokenizer, tokens[j, :lengths[j]].tolist(), eos)
                    for j in range(b)]
        outs = []
        for visual, text in zip(images, texts):
            embeds, lens = self._generation_embeds([visual], [text], num_frames)
            gen, _ = self._lm.greedy(
                self.params.decoder, embeds, np.arange(embeds.shape[1])[None], int(lens[0]),
                max_new_tokens, eos_ids=eos, sample=sample,
                temperature=temperature if sample else 1.0, top_p=top_p, rng=rng)
            outs.append(decode_text(self.tokenizer, gen, eos))
        return outs
