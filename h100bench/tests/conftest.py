"""Fixtures of the benchmark's CPU tests: a tiny benchmark in a temporary
directory (the port's ``clip-flant5-test`` and ``qwen3-vl-moe-test`` sizes,
float32, images that take the Pillow-exact resize path as the 1024 px cells
do), whose configs, mixes, metrics and limits are found by name."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]

TINY_CONFIG = {
    "model": "clip-flant5-test", "family": "clip_flant5", "dtype": "float32",
    "source": "tests", "reduced": [], "assumed": [],
    "t5": {"vocab_size": 512, "d_model": 64, "d_kv": 16, "d_ff": 128, "num_heads": 4,
           "enc_layers": 2, "dec_layers": 2, "num_buckets": 32, "max_distance": 128,
           "eps": 1e-06, "gated": True, "act": "gelu_new", "tie_word_embeddings": False,
           "decoder_start_token_id": 0},
    "vision": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2, "heads": 4,
               "mlp_dim": 64, "act": "quick_gelu", "ln_eps": 1e-05},
    "feature_layer": -2, "num_image_tokens": 16, "conversation": "t5_chat",
    "image_aspect_ratio": "pad"}

TINY_QWEN = {
    "model": "qwen3-vl-moe-test", "family": "qwen3_vl", "dtype": "float32",
    "source": "tests", "reduced": [], "assumed": [],
    "vision": {"hidden": 32, "depth": 3, "heads": 4, "patch_size": 4, "temporal_patch_size": 2,
               "merge_size": 2, "d_ff": 64, "out_hidden": 48, "num_position_embeddings": 16,
               "deepstack_indexes": [0, 1], "act": "gelu_pytorch_tanh", "ln_eps": 1e-06},
    "text": {"vocab_size": 512, "d_model": 48, "layers": 3, "heads": 4, "kv_heads": 2,
             "head_dim": 16, "rms_eps": 1e-06, "rope_theta": 5000000.0,
             "mrope_section": [4, 2, 2], "mrope_interleaved": True, "qkv_bias": False,
             "qk_norm": True, "num_experts": 4, "experts_per_tok": 2, "moe_d_ff": 32,
             "moe_norm_topk": True, "act": "silu", "tie_embeddings": False},
    "image_token_id": 501, "video_token_id": 502, "vision_start_token_id": 503,
    "vision_end_token_id": 504, "tokenizer_vocab": 500,
    "image_resize": {"min_pixels": 3136, "max_pixels": 1003520},
    # the port's normalisation (CLIP's), so that the plumbing is held against
    # a sound run; the cell's configuration states the published one, which
    # the port does not follow
    "image_mean": [0.48145466, 0.4578275, 0.40821073],
    "image_std": [0.26862954, 0.26130258, 0.27577711]}

# the numbers the cells compare, with limits far below what the control
# and each fault read at these sizes
TINY_LIMITS = {"logp_gap_nats": 1e-3, "logp_mean_gap_nats": 1e-3}
MEDIA = {"kind": "image", "height": 388, "width": 400, "pool": 8}
PROMPTS = {"pool": 16, "min_words": 2, "median_words": 5, "max_words": 12}
TINY_MIXES = {
    "tiny-image": {"driver": "batch_forward", "batch_size": 4, "round_chunks": 2,
                   "media": MEDIA, "prompts": PROMPTS, "warmup": 2, "check": {"pairs": 6}},
    "tiny-call": {"driver": "call", "media_per_call": 4, "media": MEDIA,
                  "prompts": PROMPTS, "warmup": 2, "check": {"calls": 2}},
    "tiny-qwen": {"driver": "batch_forward", "batch_size": 4, "round_chunks": 2,
                  "media": {"kind": "image", "height": 90, "width": 76, "pool": 8},
                  "prompts": PROMPTS, "warmup": 2, "check": {"pairs": 6}},
}


@pytest.fixture
def tiny_bench(tmp_path):
    """(BENCHMARK object, its directory): three cells on the tiny configs, the
    benchmark's own metric readers copied beside them."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (tmp_path / "configs" / "qtiny.json").write_text(json.dumps(TINY_QWEN))
    for name, mix in TINY_MIXES.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell in ("tiny.image", "tiny.call", "qtiny.image"):
        (tmp_path / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    for f in (BENCH / "metrics").glob("*.py"):
        shutil.copy(f, tmp_path / "metrics" / f.name)
    bench = {
        "configs": [{"name": "tiny", "file": str(tmp_path / "configs" / "tiny.json")},
                    {"name": "qtiny", "file": str(tmp_path / "configs" / "qtiny.json")}],
        "workloads": [
            {"name": "tiny.image", "config": "tiny", "traffic": "tiny-image", "chips": 1},
            {"name": "tiny.call", "config": "tiny", "traffic": "tiny-call", "chips": 1},
            {"name": "qtiny.image", "config": "qtiny", "traffic": "tiny-qwen", "chips": 1}],
        "end_to_end": [
            {"name": "pairs_per_s", "unit": "pairs/s", "workloads": ["tiny.image", "qtiny.image"]},
            {"name": "call_p95_ms", "unit": "ms", "workloads": ["tiny.call"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "adapter_host_ms_per_pair", "unit": "ms/pair",
             "workloads": ["tiny.image", "qtiny.image"]},
            {"name": "mfu.pairs", "unit": "%", "workloads": ["tiny.image", "qtiny.image"]},
            {"name": "call_p50_ms.rerank", "unit": "ms", "workloads": ["tiny.call"]}],
    }
    return bench, tmp_path
