"""Gemma 4 scorer in PyTorch (port of t2v_metrics_tpu/models/gemma4.py).

Gemma 4 is the Gemma 3 bundle (SigLIP-896 tower, pooled and projected soft
tokens, the sandwich-norm decoder of ``models/gemma3.py``) with the JAX
package's provisional dims: no public config of the checkpoints exists, so a
converted checkpoint's own dims are adopted where they differ
(``checkpoint.load_with_adopted_dims``). What sets the family apart is the
adapter: scoring by a 5-token greedy rollout scored from its end, and a
``generate`` that keeps specials and strips the thinking block
(``parse_response``).
"""

from __future__ import annotations

import re

from . import decoder as dec
from . import siglip
from .gemma3 import Gemma3Config, _gemma3_text, _SIGLIP_896, convert_gemma3, init_gemma3

# Gemma 4 is the Gemma 3 bundle; aliases keep call sites uniform
Gemma4Config = Gemma3Config
init_gemma4 = init_gemma3
convert_gemma4 = convert_gemma3

GEMMA4_MODELS = {
    # dims PROVISIONAL, as in the JAX package
    "gemma-4-12b-it": {
        "hf": "google/gemma-4-12B-it",
        "config": Gemma4Config(
            vision=_SIGLIP_896,
            text=_gemma3_text(3840, 48, 16, 8, 256, 15360, q_scalar=256)),
    },
    "gemma-4-31b-it": {
        "hf": "google/gemma-4-31B-it",
        "config": Gemma4Config(
            vision=_SIGLIP_896,
            text=_gemma3_text(5376, 70, 32, 16, 128, 23040, q_scalar=168)),
    },
    "gemma-4-test": {
        "hf": None,
        "config": Gemma4Config(
            vision=siglip.SiglipVisionConfig(image_size=28, patch_size=14,
                                             width=32, layers=2, heads=4,
                                             mlp_dim=64),
            text=dec.DecoderConfig(
                vocab_size=512, d_model=48, layers=3, heads=4, kv_heads=2,
                head_dim=16, d_ff=96, act="gelu_pytorch_tanh",
                rope_theta=1_000_000.0, mrope_section=None, qkv_bias=False,
                tie_embeddings=True, qk_norm=True, q_scale=16 ** -0.5,
                sandwich_norms=True, rms_offset=1.0, rms_cast_weight=False,
                sliding_window=8,
                layer_types=("sliding_attention", "full_attention",
                             "sliding_attention"),
                local_rope_theta=10_000.0, rope_scaling_factor=8.0),
            mm_tokens_per_image=1, image_token_id=501, boi_token_id=502,
            eoi_token_id=503),
    },
}


_THINK_PATTERNS = (
    # harmony-style channel blocks ("<|channel>thought\n<channel|>") and
    # <think> blocks
    re.compile(r"<\|channel\|?>\s*thought.*?(?:<\|?channel\|?>|$)", re.DOTALL),
    re.compile(r"<think>.*?</think>", re.DOTALL),
)


def parse_response(raw: str) -> str:
    """Strip thinking blocks from a raw decode (a copy of the JAX package's
    ``parse_response``: both marker syntaxes, then whitespace)."""
    out = raw
    for pat in _THINK_PATTERNS:
        out = pat.sub("", out)
    return out.strip()
