"""Model adapters behind VQAScore and CLIPScore (port of the CLIP-FlanT5
and CLIPScore parts of t2v_metrics_tpu/models/adapters.py).

The adapter contract is the JAX package's: ``load_model`` builds the engine,
``forward`` scores pairs, ``score_matrix`` scores M images x N texts, and
``prepare_pairs`` / ``forward_device_prepared`` split host and device work
for the shared ``Score.batch_forward`` pipeline.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..constants import DEFAULT_ANSWER_TEMPLATE, DEFAULT_QUESTION_TEMPLATE
from ..engine.scoring import CLIPEngine, CLIPT5Engine
from ..ops import quant as Q
from ..tokenization import SimpleT5Tokenizer, load_hf_tokenizer
from . import checkpoint as ckpt
from . import clip as tclip
from . import clip_flant5 as tcft5
from . import t5 as tt5


def resolve_device(device) -> torch.device:
    """``None`` means the GPU. A CUDA device without a GPU raises: the CPU
    runs only when the caller asks for it (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the GPU, fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_checkpoint_tree(path: str, convert, from_numpy, cfg, model_name: str, dtype):
    """A checkpoint directory as a tree in the JAX layout (CPU tensor leaves):
    a native tree (``manifest.json``) as it is, HF shards (safetensors or
    ``*.bin``) through ``convert(sd, cfg)``; then checked by running the
    family's loader ``from_numpy`` over it onto the meta device. Raises
    ``CheckpointError`` naming ``path`` and what is missing, misshapen or
    unexpected; never falls back to other weights."""
    if not os.path.isdir(path):
        raise ckpt.CheckpointError(f"checkpoint {path!r} is not a directory")
    if ckpt.is_native_tree(path):
        tree = ckpt.load_params(path)
    else:
        tree = ckpt.convert_checked(convert, ckpt.load_hf_state_dict(path), path, cfg)
    try:
        ckpt.validate_params_dims(tree, lambda t: from_numpy(t, cfg, "meta", dtype),
                                  model_name)
    except ValueError as e:
        raise ckpt.CheckpointError(f"{path!r}: {e}") from None
    return tree


def family_params(adapter, hf_repo, cfg, model_cls, init, convert, from_numpy):
    """An adapter's weights, in the order the families take them: the
    ``params`` kwarg (a ``model_cls``, or a tree in the JAX package's layout
    carried over by ``from_numpy``); the ``checkpoint`` directory (see
    ``load_checkpoint_tree``, with ``convert``); random from ``seed`` with
    ``init='random'`` or for a model without a hub repo (``init(cfg, seed,
    device, dtype)``); else the hub repo's snapshot from the local cache
    (never downloaded). On the adapter's device in ``dtype`` (default bf16 on
    CUDA, fp32 on the CPU)."""
    kw, device = adapter.kwargs, adapter.device
    dtype = kw.get("dtype") or default_dtype(device)
    params = kw.get("params")
    if params is None:
        path = kw.get("checkpoint")
        if path is None and kw.get("init") != "random" and hf_repo is not None:
            path = ckpt.resolve_snapshot(hf_repo, adapter.cache_dir)
        if path is not None:
            params = load_checkpoint_tree(path, convert, from_numpy, cfg,
                                          adapter.model_name, dtype)
        else:
            params = init(cfg, kw.get("seed", 0), device, dtype)
    if not isinstance(params, model_cls):
        params = from_numpy(params, cfg, device, dtype)
    return params


class ScoreModel:
    """Abstract adapter."""

    video_mode = "direct"  # how Score routes video paths

    def __init__(self, model_name: str, device=None, cache_dir: str | None = None,
                 **kwargs):
        # cache_dir: searched first for pretrained snapshots
        # (checkpoint.hub_cache_dirs); nothing is ever downloaded
        self.model_name = model_name
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        self.kwargs = kwargs
        self.load_model()

    def load_model(self):
        raise NotImplementedError

    def load_images(self, images):
        raise NotImplementedError

    def forward(self, images, texts, **kwargs):
        raise NotImplementedError


def tokenizer_arg(tok):
    """The ``tokenizer`` kwarg: an object, or a local directory loaded with
    ``load_hf_tokenizer``."""
    if isinstance(tok, str):
        if not os.path.isdir(tok):
            raise ValueError(f"tokenizer {tok!r} is not a local directory")
        tok = load_hf_tokenizer(tok)
    return tok


def cached_tokenizer(kwargs, hf_repo, vocab_size: int, cache_dir=None):
    """CLIPScore's and ITMScore's tokenizer, as the JAX adapters choose it:
    the ``tokenizer`` kwarg, else the registry repo's tokenizer from its
    local snapshot (never downloaded), else SimpleT5Tokenizer (with a
    warning when the model has a repo: its scores will not match the
    pretrained weights)."""
    tok = tokenizer_arg(kwargs.get("tokenizer"))
    if tok is not None:
        return tok
    if hf_repo is not None:
        try:
            return load_hf_tokenizer(ckpt.resolve_snapshot(hf_repo, cache_dir))
        except (ckpt.CheckpointError, ImportError, OSError, ValueError) as e:
            warnings.warn(f"tokenizer of {hf_repo} unavailable ({type(e).__name__}); "
                          "using SimpleT5Tokenizer, so scores will NOT match "
                          "pretrained weights (pass tokenizer=<local dir>)")
    return SimpleT5Tokenizer(vocab_size)


class VQAScoreModel(ScoreModel):
    """Adds the question/answer template contract."""

    def forward(self, images, texts,
                question_template: str = DEFAULT_QUESTION_TEMPLATE,
                answer_template: str = DEFAULT_ANSWER_TEMPLATE, **kwargs):
        raise NotImplementedError

    def _load_tokenizer(self, hf_name, vocab_size):
        """The ``tokenizer`` kwarg (an object or a local directory), else
        SimpleT5Tokenizer (with a warning when the model has a hub
        tokenizer, which is never fetched)."""
        tok = tokenizer_arg(self.kwargs.get("tokenizer"))
        if tok is None:
            if hf_name is not None:
                warnings.warn(
                    f"no local tokenizer for {hf_name}; using "
                    "SimpleT5Tokenizer, so scores will NOT match pretrained "
                    "weights (pass tokenizer=<local dir>)")
            tok = SimpleT5Tokenizer(vocab_size)
        return tok


# Tiny configs for tests and smoke runs.
_TEST_T5 = tt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                        num_heads=4, enc_layers=2, dec_layers=2)
_TEST_VISION = tclip.CLIPVisionConfig(image_size=56, patch_size=14, width=32,
                                      layers=2, heads=4, mlp_dim=64, proj_dim=32)

CLIP_T5_MODELS = {
    "clip-flant5-xxl": {
        "config": tcft5.CLIP_T5_CONFIGS["clip-flant5-xxl"],
        "hf_repo": "zhiqiulin/clip-flant5-xxl",
        "tokenizer": "google/flan-t5-xxl",
    },
    "clip-flant5-xl": {
        "config": tcft5.CLIP_T5_CONFIGS["clip-flant5-xl"],
        "hf_repo": "zhiqiulin/clip-flant5-xl",
        "tokenizer": "google/flan-t5-xl",
    },
    "clip-flant5-test": {
        "config": tcft5.CLIPT5Config(t5=_TEST_T5, vision=_TEST_VISION,
                                     num_image_tokens=16),
        "hf_repo": None,
        "tokenizer": None,
    },
}


class CLIPT5Adapter(VQAScoreModel):
    """CLIP-FlanT5 VQAScore adapter.

    Weights, in this order: ``params``; ``checkpoint``; random with
    ``init='random'`` (or a model without a hub repo); else the pretrained
    ``hf_repo`` from the local Hugging Face cache (never downloaded).

    kwargs:
      checkpoint: a local directory: HF shards (safetensors or ``*.bin``) in
        the LLaVA key layout, or a native tree (``manifest.json``). A
        checkpoint without the CLIP tower takes it from the local snapshot
        of the repo its config.json names in ``mm_vision_tower``.
      init: 'random' builds random weights on the device from ``seed``
      params: a ``CLIPT5Model``, or a pytree in the JAX package's layout with
        numpy or CPU tensor leaves (carried over by ``bridge.py``)
      config: a ``CLIPT5Config`` that replaces the registry's
      seed: random-init seed (default 0)
      dtype: parameter dtype (default bf16 on CUDA, fp32 on CPU)
      tokenizer: a tokenizer object or a local tokenizer directory
      quant: None, "int8" (W8A8 T5 linears) or "int8+vit" (and the ViT
        linears); the environment's ``T2V_QUANT`` when not given. A
        ``CLIPT5Model`` passed as ``params`` is quantized in place; loaded
        weights are quantized after the load.
      mesh: a ``parallel.mesh.Mesh`` of this process's ranks: each rank
        holds its share of the weights (random ones drawn whole a tensor at
        a time and sliced, a checkpoint's read in slices; ``params`` sharded
        in place), the pairs are split over the data axes by image, every
        rank returns all the scores
    """

    video_mode = "concat"

    def load_model(self):
        spec = CLIP_T5_MODELS[self.model_name]
        cfg: tcft5.CLIPT5Config = self.kwargs.get("config") or spec["config"]
        self.config = cfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        quant = self.kwargs.get("quant") or os.environ.get("T2V_QUANT")
        mesh = self.kwargs.get("mesh")
        if quant not in (None, "", "int8", "int8+vit"):
            raise ValueError(f"unknown quant mode {quant!r} ('int8' or 'int8+vit')")

        params = self.kwargs.get("params")
        if params is None:
            path = self.kwargs.get("checkpoint")
            if path is None and self.kwargs.get("init") != "random" \
                    and spec["hf_repo"] is not None:
                path = ckpt.resolve_snapshot(spec["hf_repo"], self.cache_dir)
            if path is not None:
                params = self._load_checkpoint(path, cfg, dtype)
            else:
                params = tcft5.init_clip_t5(cfg, self.kwargs.get("seed", 0), device,
                                            dtype, mesh=mesh)
        if not isinstance(params, tcft5.CLIPT5Model):
            from ..bridge import clip_t5_from_numpy

            params = clip_t5_from_numpy(params, cfg, device, dtype, mesh=mesh)
        if quant:
            # in place, one leaf at a time, each dense leaf freed as it goes
            Q.quantize_t5_(params.t5)
            if quant == "int8+vit":
                Q.quantize_clip_vision_(params.vision)

        tokenizer = self._load_tokenizer(spec["tokenizer"], cfg.t5.vocab_size)
        self.engine = CLIPT5Engine(params, cfg, tokenizer, device, mesh=mesh)

    def _load_checkpoint(self, path: str, cfg: tcft5.CLIPT5Config, dtype) -> dict:
        """The tree of a checkpoint directory (see ``load_checkpoint_tree``),
        the CLIP tower from ``mm_vision_tower``'s snapshot where the
        checkpoint has none."""
        from ..bridge import clip_t5_from_numpy

        def convert_clip_t5(sd, cfg):
            tower_sd = (None if tcft5.tower_prefix(sd) is not None
                        else self._tower_state_dict(path, cfg))
            return tcft5.convert_clip_t5(sd, cfg, tower_sd)

        return load_checkpoint_tree(path, convert_clip_t5, clip_t5_from_numpy, cfg,
                                    self.model_name, dtype)

    def _tower_state_dict(self, path: str, cfg: tcft5.CLIPT5Config):
        """The state dict of the CLIP repo a tower-less checkpoint names in
        its config.json's ``mm_vision_tower``, from the local cache; its
        ``vision_model.*`` keys checked."""
        from .convert import convert_clip_vision

        cj = ckpt.read_hf_config(path) or {}
        repo = cj.get("mm_vision_tower")
        if not repo:
            raise ckpt.CheckpointError(
                f"checkpoint {path!r} holds no CLIP tower keys (none of "
                f"{', '.join(tcft5._TOWER_PREFIXES)}) and its config.json names "
                "no mm_vision_tower")
        try:
            tower_dir = ckpt.resolve_snapshot(repo, self.cache_dir)
        except ckpt.CheckpointError as e:
            raise ckpt.CheckpointError(
                f"checkpoint {path!r} holds no CLIP tower keys and its "
                f"mm_vision_tower {repo!r} is not local: {e}") from None
        tower_sd = ckpt.load_hf_state_dict(tower_dir)
        ckpt.convert_checked(convert_clip_vision, tower_sd, tower_dir, cfg.vision.layers)
        return tower_sd

    def load_images(self, images):
        return images  # the engine decodes and preprocesses in batches

    def forward(self, images, texts,
                question_template: str = DEFAULT_QUESTION_TEMPLATE,
                answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                **kwargs) -> np.ndarray:
        """Pairwise scores, len(images) == len(texts) -> (P,)."""
        return self.engine.forward_pairwise(images, texts, question_template,
                                            answer_template)

    def prepare_pairs(self, images, texts,
                      question_template: str = DEFAULT_QUESTION_TEMPLATE,
                      answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                      slot: int | None = None, **kwargs):
        """Host-only stage of pairwise scoring (feeds forward_device_prepared).
        ``slot`` is the facade's staging-ring index; every call here builds
        its own arrays, so it is not needed."""
        return self.engine.prepare_pairs(images, texts, question_template,
                                         answer_template)

    def forward_device_prepared(self, prep):
        """Device stage for a prepare_pairs dict."""
        return self.engine.forward_device_prepared(prep)

    def score_matrix(self, images, texts,
                     question_template: str = DEFAULT_QUESTION_TEMPLATE,
                     answer_template: str = DEFAULT_ANSWER_TEMPLATE,
                     **kwargs) -> np.ndarray:
        """(M, N) matrix with one vision encode per image."""
        return self.engine.score_matrix(images, texts, question_template,
                                        answer_template)

    def generate(self, images, texts, max_new_tokens: int = 128,
                 **kwargs) -> list[str]:
        """Greedy continuation (v3.0 CLIP-FlanT5 LLaVA-style generate)."""
        return self.engine.generate(images, texts, max_new_tokens=max_new_tokens)


# ---------------------------------------------------------------------------
# CLIPScore (OpenCLIP cosine similarity)
# ---------------------------------------------------------------------------

_TEST_CLIP_V = tclip.CLIPVisionConfig(image_size=32, patch_size=8, width=32,
                                      layers=2, heads=4, mlp_dim=64, proj_dim=24)
_TEST_CLIP_T = tclip.CLIPTextConfig(vocab_size=256, context_length=16, width=32,
                                    layers=2, heads=4, mlp_dim=64, proj_dim=24)

CLIP_SCORE_MODELS = {
    # OpenCLIP names: "pretrain_tag:Arch"
    "openai:ViT-B-32": {"arch": "ViT-B-32", "hf_repo": "openai/clip-vit-base-patch32"},
    "openai:ViT-B-16": {"arch": "ViT-B-16", "hf_repo": "openai/clip-vit-base-patch16"},
    "openai:ViT-L-14": {"arch": "ViT-L-14", "hf_repo": "openai/clip-vit-large-patch14"},
    "openai:ViT-L-14-336": {"arch": "ViT-L-14-336",
                            "hf_repo": "openai/clip-vit-large-patch14-336"},
    "clipscore-test": {"arch": None, "hf_repo": None},
}


def resolve_clipscore_name(name: str):
    """The registry entry of a CLIPScore name: any ``pretrain_tag:Arch``
    whose Arch is a known architecture (only ``openai:`` names have a repo),
    else None."""
    if name in CLIP_SCORE_MODELS:
        return CLIP_SCORE_MODELS[name]
    if ":" in name:
        tag, arch = name.split(":", 1)
        if arch in tclip.CLIP_ARCHS:
            return {"arch": arch, "hf_repo": None if tag != "openai" else
                    CLIP_SCORE_MODELS.get(f"openai:{arch}", {}).get("hf_repo")}
    return None


class CLIPScoreAdapter(ScoreModel):
    """CLIPScore: the cosine similarity of CLIP's image and text embeddings.

    Weights, in this order: ``params``; ``checkpoint``; random with
    ``init='random'`` (or a name without a repo); else the ``hf_repo``
    snapshot from the local Hugging Face cache (never downloaded).

    kwargs: checkpoint (a local directory: HF CLIPModel shards, safetensors
    or ``*.bin``, or a native tree), init='random', params (a ``CLIPModel``,
    or a pytree in the JAX package's layout with numpy or CPU tensor leaves),
    vision_config / text_config (replace the registry's), seed (default 0),
    dtype (default bf16 on CUDA, fp32 on CPU), tokenizer (an object or a
    local directory; else the snapshot's, else SimpleT5Tokenizer), mesh (a
    ``parallel.mesh.Mesh``: the towers tensor-parallel, the images split
    over the data axes, every rank returns the whole matrix).
    """

    video_mode = "concat"

    def load_model(self):
        spec = resolve_clipscore_name(self.model_name)
        if spec is None:
            raise ValueError(f"unknown CLIPScore model {self.model_name!r}")
        vcfg, tcfg = (tclip.CLIP_ARCHS[spec["arch"]] if spec["arch"]
                      else (_TEST_CLIP_V, _TEST_CLIP_T))
        vcfg = self.kwargs.get("vision_config") or vcfg
        tcfg = self.kwargs.get("text_config") or tcfg
        self.vcfg, self.tcfg = vcfg, tcfg
        device = self.device
        dtype = self.kwargs.get("dtype") or default_dtype(device)
        mesh = self.kwargs.get("mesh")

        params = self.kwargs.get("params")
        if params is None:
            path = self.kwargs.get("checkpoint")
            if path is None and self.kwargs.get("init") != "random" \
                    and spec["hf_repo"] is not None:
                path = ckpt.resolve_snapshot(spec["hf_repo"], self.cache_dir)
            if path is not None:
                params = self._load_checkpoint(path, (vcfg, tcfg), dtype)
            else:
                params = tclip.init_clip(vcfg, tcfg, self.kwargs.get("seed", 0), device,
                                         dtype, mesh=mesh)
        if not isinstance(params, tclip.CLIPModel):
            from ..bridge import clip_from_numpy

            params = clip_from_numpy(params, (vcfg, tcfg), device, dtype, mesh=mesh)
        tokenizer = cached_tokenizer(self.kwargs, spec["hf_repo"], tcfg.vocab_size,
                                     self.cache_dir)
        self.engine = CLIPEngine(params, vcfg, tcfg, tokenizer, device, mesh=mesh)

    def _load_checkpoint(self, path: str, cfg: tuple, dtype) -> dict:
        from ..bridge import clip_from_numpy
        from . import convert

        def convert_clip(sd, cfg):
            return convert.convert_clip(sd, cfg[0].layers, cfg[1].layers)

        return load_checkpoint_tree(path, convert_clip, clip_from_numpy, cfg,
                                    self.model_name, dtype)

    def load_images(self, images):
        return images  # the engine decodes and preprocesses in batches

    def forward(self, images, texts, **kwargs) -> np.ndarray:
        """Pairwise cosine scores, len(images) == len(texts) -> (P,)."""
        return self.engine.forward_pairwise(images, texts)

    def score_matrix(self, images, texts, **kwargs) -> np.ndarray:
        return self.engine.score_matrix(images, texts)
