"""Qwen3-VL VQAScore adapter, image and video scoring (port of
t2v_metrics_tpu/models/qwen3vl_adapter.py).

A subclass of the port's Qwen2.5-VL adapter with the same scoring contract
and batched flow, and Qwen3's vision encoding: no windows (the patch rows
stay in merge-group order), the interpolated position embeddings, and the
deepstack levels, which travel beside the main features and are added to
the decoder's hidden state after its first layers. The features stay on the
device (the JAX adapter copies them through host f32 numpy, which is exact
from bf16, so the numbers are the same). The sequence bucket is chosen for
the longest prompt plus 8 tokens, as in the JAX adapter. qwen3.5 prompts end
with the closed empty thinking block of ``enable_thinking=False``. Videos
are sampled as for Qwen2.5-VL; their frames are resized on the device with
Pillow's fixed-point uint8 resize, bit for bit (the JAX adapter resizes them
with Pillow on the host; the port needs no Pillow), and the tower runs with
grid_t > 1 (the position table tiled over time).
Generation and traces are the Qwen2.5-VL adapter's, with the deepstack
residuals added at the prefill only (the decode steps take none).
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from ..tracing import span, to_device
from . import qwen2vl as q2
from . import checkpoint as ckpt
from . import qwen3vl as q3
from .adapters import default_dtype, load_checkpoint_tree
from .qwen2vl_adapter import PATCH_BUCKETS, Qwen2VLAdapter, _bucket

THINKING_OFF_SUFFIX = "<think>\n\n</think>\n\n"

# the config.json fields the qwen3.5 dims adoption takes (the JAX adapter's
# list, read there from hf.config.text_config)
_QWEN35_TEXT_KEYS = {k: ckpt._HF_DECODER_KEYS[k] for k in (
    "hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "intermediate_size", "vocab_size", "head_dim", "rope_theta")}


class Qwen3VLAdapter(Qwen2VLAdapter):
    """Qwen3-VL VQAScore adapter (images and videos), dense and MoE.

    kwargs as ``Qwen2VLAdapter``'s: checkpoint (an HF directory, dense or
    MoE, or a native tree), init='random', params (a ``Qwen3VLModel`` or a
    pytree in the JAX package's layout), config (a ``Qwen3VLConfig``),
    seed, dtype, tokenizer; the pretrained repo from the local cache
    otherwise. qwen3.5's dims are provisional: its checkpoint's config.json
    replaces them, with a warning naming each field.
    """

    seq_extra = 8

    def load_model(self):
        spec = q3.QWEN3_VL_MODELS[self.model_name]
        cfg: q3.Qwen3VLConfig = self.kwargs.get("config") or q3.resolve_config(
            self.model_name)
        self.config = cfg
        self._assistant_suffix = (THINKING_OFF_SUFFIX
                                  if spec.get("enable_thinking") is False else "")
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        params = self.kwargs.get("params")
        if params is None:
            path = self.checkpoint_path(spec)
            if path is not None:
                cfg = self.config = self._adopt_config_json(path, cfg)
                params = self._load_checkpoint(path, cfg, dtype)
            else:
                params = q3.init_qwen3vl(cfg, self.kwargs.get("seed", 0), device, dtype)
        if not isinstance(params, q3.Qwen3VLModel):
            from ..bridge import qwen3vl_from_numpy

            params = qwen3vl_from_numpy(params, cfg, device, dtype)
        self.params = params
        self.tokenizer = self._load_tokenizer(spec["hf"], cfg.text.vocab_size)
        self.fps_default = spec.get("fps", 8.0)
        self._geometry = {}

    def _adopt_config_json(self, path: str, cfg: q3.Qwen3VLConfig) -> q3.Qwen3VLConfig:
        """qwen3.5: the checkpoint's config.json text dims over the
        provisional registry values (the JAX adapter's adoption)."""
        cj = ckpt.read_hf_config(path) if os.path.isdir(path) else None
        if not self.model_name.startswith("qwen3.5") or cj is None:
            return cfg
        tc = cj.get("text_config", cj)
        if "head_dim" not in tc and "hidden_size" in tc and "num_attention_heads" in tc:
            tc = {**tc, "head_dim": tc["hidden_size"] // tc["num_attention_heads"]}
        text, diff = ckpt.adopt_config_json(tc, cfg.text, _QWEN35_TEXT_KEYS)
        if not diff:
            return cfg
        warnings.warn(
            f"{self.model_name}: adopted checkpoint dims over "
            f"the provisional registry values: "
            + ", ".join(f"text.{k} {o} -> {n}" for k, (o, n) in sorted(diff.items())))
        return dataclasses.replace(cfg, text=text)

    def _load_checkpoint(self, path: str, cfg, dtype) -> dict:
        from ..bridge import qwen3vl_from_numpy

        return load_checkpoint_tree(path, q3.convert_qwen3vl, qwen3vl_from_numpy, cfg,
                                    self.model_name, dtype)

    def _build_ids(self, question, n_vis, is_video=False):
        ids = super()._build_ids(question, n_vis, is_video)
        if self._assistant_suffix:
            ids = ids + self._encode_text(self._assistant_suffix)
        return ids

    def _device_geometry(self, grid, s, sb):
        """Rotary ids and segment ids padded to the bucket, and the position
        table's interpolation, on the device (kept per shape)."""
        key = (grid, sb)
        if key not in self._geometry:
            cfg = self.config.vision
            pos_hw = np.concatenate([q3.vision_geometry(grid, cfg),
                                     np.zeros((sb - s, 2), np.int32)])
            seg = np.concatenate([np.zeros(s, np.int32), np.full(sb - s, -1, np.int32)])
            pe_idx, pe_w, pe_perm = q3.pos_embed_interp(grid, cfg)
            self._geometry[key] = tuple(
                to_device(a, self.device)
                for a in (pos_hw.astype(np.int64), seg, pe_idx.astype(np.int64),
                          pe_w, pe_perm.astype(np.int64)))
        return self._geometry[key]

    def _patch_rows(self, kind, pixels, hb, wb):
        # the JAX adapter resizes video frames with Pillow on the host
        return q2.video_patches(pixels, self.config.vision, hb, wb, pillow=True) \
            if kind == "vid" else q2.image_patches(pixels, self.config.vision, hb, wb)

    @torch.inference_mode()
    def _encode_visuals(self, visuals, fps=None):
        """Encode unique visuals, one batched tower call per group of
        same-shape images or videos -> [(levels (1 + n_ds, T, D) on the
        device, grid_thw, is_video, seconds per temporal grid step)]: the
        merged features, then the deepstack levels."""
        cfg = self.config.vision
        hosts, groups = self._decoded_groups(visuals, fps)
        mu = cfg.merge_unit
        out = [None] * len(hosts)
        for (kind, shape), idxs in groups.items():
            hb, wb, grid = self._visual_grid(kind, shape)
            s = int(np.prod(grid))
            sb = _bucket(s, PATCH_BUCKETS)
            pos_hw, seg, pe_idx, pe_w, pe_perm = self._device_geometry(grid, s, sb)
            n = len(idxs)
            with span("engine.decode"):
                stack = np.stack([hosts[i][1] for i in idxs])
            with span("engine.encode"):
                pixels = to_device(stack.reshape(*stack.shape[:-2], -1), self.device)
                rows = self._patch_rows(kind, pixels, hb, wb)
                if rows.shape[1] < sb:
                    rows = torch.nn.functional.pad(rows, (0, 0, 0, sb - rows.shape[1]))
                main, deepstack = q3.vision_tower(
                    self.params.vision, cfg, rows, pos_hw.expand(n, -1, -1), pe_idx,
                    pe_w, pe_perm, seg.expand(n, -1), grid_t=grid[0])
                levels = torch.stack([main, *deepstack], dim=1)  # (n, 1+n_ds, S/mu, D)
            for row, i in enumerate(idxs):
                out[i] = (levels[row, :, : s // mu], grid, kind == "vid", hosts[i][2])
        return out

    def _splice_and_score(self, ids, feats, *arrays, temperature):
        # feats: (P, 1 + n_ds, T, D) -> the main level and the deepstack ones
        return q3.splice_and_score(self.params, self.config, ids, feats[:, 0],
                                   feats[:, 1:].unbind(1), *arrays,
                                   temperature=temperature)

    def _splice_and_answer_dists(self, ids, feats, *arrays, temperature):
        # feats: (P, 1 + n_ds, T, D), the main level and the deepstack ones
        return q3.splice_and_answer_dists(self.params, self.config, ids, feats, *arrays,
                                          temperature=temperature)

    def _split_feats_batched(self, feats):
        # (P, 1 + n_ds, T, D) -> main (P, T, D) and the deepstack levels
        return feats[:, 0], feats[:, 1:].unbind(1)
