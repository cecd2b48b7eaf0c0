"""t2v_metrics_tpu_torch — the PyTorch / CUDA port of t2v_metrics_tpu.

The JAX package beside it (``t2v_metrics_tpu``) is the reference this port
is held against. This package imports ``torch`` and never ``jax``, and
nothing of the JAX package: it keeps its own copies of the host layers it
needs (``constants``, ``tokenization``, ``media/video`` and the ``Score``
facade in ``score``).

    import t2v_metrics_tpu_torch as t2v
    scorer = t2v.VQAScore(model="clip-flant5-xl", init="random")
    scores = scorer(images=[uint8_hwc_array], texts=["a photo of a cat"])

The entry points run on the GPU and raise without one; ``device="cpu"``
asks for the CPU. The VQAScore models are clip-flant5 (xl, xxl; xxl also in
the W8A8 modes ``quant="int8"`` and ``"int8+vit"``), Qwen2.5-VL (3b, 7b,
32b, 72b), Qwen3-VL (dense and MoE) and Gemma 3 (4b, 12b, 27b), image
scoring. On CUDA tensors the hot ops run hand-written Hopper kernels (the
flat and per-head flash attention ``csrc/flash_flat.cu`` and
``csrc/flash_attention.cu``, the MoE grouped GEMM ``csrc/grouped_gemm.cu``,
the int8 GEMM ``csrc/quant_matmul.cu``, the Triton norms in
``ops/norms.py``, the Triton rotary embedding in ``ops/rope.py`` and the
Triton row quant in ``ops/quant.py``); on CPU tensors the same entry points
run their plain PyTorch versions.
"""

from .score import VQAScore
from .registry import list_all_vqascore_models
from .tokenization import SimpleT5Tokenizer

# SimpleT5Tokenizer builds its vocabulary as it meets words: scorers that
# must agree on token ids share one instance (``tokenizer=``).
__all__ = ["SimpleT5Tokenizer", "VQAScore", "list_all_vqascore_models"]
