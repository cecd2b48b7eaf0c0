"""Molmo2 scorer in PyTorch (port of t2v_metrics_tpu/models/molmo2.py).

The JAX package builds Molmo2 from the reference adapter's observable
contract (reference molmo2_model.py: molmo2-4b / -7b / -8b loaded with
``trust_remote_code``, native video, a greedy one-token rollout scored from
its end). No HF class exists and the remote code is unreachable offline, so
the architecture follows the published Molmo lineage with PROVISIONAL dims,
as in the JAX package, and the port copies it: the CLIP ViT-L/14-336
tower's second-to-last-block patch features (CLS dropped), a ``pool`` x
``pool`` mean pool, the GELU connector into the decoder width, and an
OLMo-2-lineage decoder (``models/decoder.py``: no qkv bias, per-head
qk-norm, 1-D RoPE theta 500k). A converted checkpoint's own dims are
adopted where they differ (``checkpoint.load_with_adopted_dims``). Videos
take ``NATIVE_VIDEO_FRAMES`` uniform frames, the JAX package's stand-in for
the model's own sampler.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from . import clip as tclip
from . import decoder as dec
from .clip_flant5 import Projector

# frames sampled for a video (provisional, as in the JAX package)
NATIVE_VIDEO_FRAMES = 8


@dataclasses.dataclass(frozen=True)
class Molmo2Config:
    vision: tclip.CLIPVisionConfig
    text: dec.DecoderConfig
    pool: int = 2               # 2x2 patch pooling before the connector
    image_token_id: int = 152064

    @property
    def tokens_per_image(self) -> int:
        side = self.vision.image_size // self.vision.patch_size // self.pool
        return side * side


def _text(d_model, layers, heads, kv_heads, d_ff, vocab=152192):
    # OLMo-2-lineage decoder: no qkv bias, qk-norm, standard 1D RoPE
    return dec.DecoderConfig(
        vocab_size=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=d_model // heads, d_ff=d_ff,
        rope_theta=500_000.0, mrope_section=None, qkv_bias=False,
        qk_norm=True)


_CLIP_L_336 = tclip.CLIP_ARCHS["ViT-L-14-336"][0]

MOLMO2_MODELS = {
    # reference molmo2_model.py:8-41; dims PROVISIONAL (see the module doc)
    "molmo2-4b": {"hf": "allenai/Molmo2-4B",
                  "config": Molmo2Config(_CLIP_L_336, _text(2560, 36, 32, 8, 9728))},
    "molmo2-7b": {"hf": "allenai/Molmo2-O-7B",
                  "config": Molmo2Config(_CLIP_L_336, _text(4096, 32, 32, 32, 11008))},
    "molmo2-8b": {"hf": "allenai/Molmo2-8B",
                  "config": Molmo2Config(_CLIP_L_336, _text(4096, 36, 32, 8, 12288))},
    "molmo2-test": {"hf": None,
                    "config": Molmo2Config(
                        tclip.CLIPVisionConfig(image_size=28, patch_size=14, width=32,
                                               layers=2, heads=4, mlp_dim=64, proj_dim=24),
                        dec.DecoderConfig(vocab_size=512, d_model=48, layers=2, heads=4,
                                          kv_heads=2, head_dim=16, d_ff=96,
                                          rope_theta=500_000.0, mrope_section=None,
                                          qkv_bias=False, qk_norm=True),
                        pool=1, image_token_id=500)},
}


class Molmo2Model(nn.Module):
    """Parameters of the whole scorer: ``vision`` (the CLIP tower; its
    ``proj`` is kept, the patch features read none), ``connector`` (fc1,
    fc2) and ``decoder``."""

    def __init__(self, cfg: Molmo2Config, device, dtype):
        super().__init__()
        self.vision = tclip.VisionTower(cfg.vision, device, dtype)
        self.connector = Projector(cfg.vision.width, cfg.text.d_model, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_molmo2(cfg: Molmo2Config, seed: int, device, dtype=torch.float32) -> Molmo2Model:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_molmo2's
    distributions (the numbers differ from the JAX package's): the CLIP
    tower's init, the connector's linears N(0, 1/d_in) with zero biases, the
    decoder's init (qk-norm scales ones)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Molmo2Model(cfg, device, dtype)
    tclip.init_vision(model.vision, gen)
    for leaf in (model.connector.fc1, model.connector.fc2):
        tclip.normal_(leaf.w, leaf.w.shape[0] ** -0.5, gen)
        leaf.b.zero_()
    dec.init_decoder(model.decoder, gen)
    return model


def image_features(params: Molmo2Model, cfg: Molmo2Config,
                   pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (B, H, W*3) pixels -> (B, tokens_per_image, d_model)."""
    feats = tclip.vision_tower(params.vision, cfg.vision, pixels, feature_layer=-2)
    b, n, w = feats.shape
    side, k = int(round(n ** 0.5)), cfg.pool
    x = feats.reshape(b, side // k, k, side // k, k, w).mean(dim=(2, 4)).reshape(b, -1, w)
    h = L.ACT_FNS["gelu"](Q.linear(x, params.connector.fc1))
    return Q.linear(h, params.connector.fc2)
