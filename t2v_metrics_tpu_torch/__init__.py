"""t2v_metrics_tpu_torch — the PyTorch / CUDA port of t2v_metrics_tpu.

The JAX package beside it (``t2v_metrics_tpu``) is the reference this port
is held against. This package imports ``torch`` and never ``jax``; it reuses
the JAX package's jax-free host modules (``constants``, ``tokenization`` and
the generic ``score.Score`` facade).

    import t2v_metrics_tpu_torch as t2v
    scorer = t2v.VQAScore(model="clip-flant5-xl", init="random", device="cuda")
    scores = scorer(images=[uint8_hwc_array], texts=["a photo of a cat"])

The VQAScore models are clip-flant5 (xl, xxl), Qwen2.5-VL (3b, 7b, 32b,
72b) and Qwen3-VL (dense and MoE; image scoring). On CUDA tensors the hot
ops run hand-written Hopper kernels (``csrc/flash_flat.cu``, the MoE
grouped GEMM ``csrc/grouped_gemm.cu``, the Triton norms in
``ops/norms.py`` and the Triton rotary embedding in ``ops/rope.py``); on
CPU tensors the same entry points run their plain PyTorch versions.
"""

from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer

from .score import VQAScore
from .registry import list_all_vqascore_models

# SimpleT5Tokenizer builds its vocabulary as it meets words: scorers that
# must agree on token ids share one instance (``tokenizer=``).
__all__ = ["SimpleT5Tokenizer", "VQAScore", "list_all_vqascore_models"]
