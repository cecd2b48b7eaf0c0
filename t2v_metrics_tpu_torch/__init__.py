"""t2v_metrics_tpu_torch — the PyTorch / CUDA port of t2v_metrics_tpu.

The JAX package beside it (``t2v_metrics_tpu``) is the reference this port
is held against. This package imports ``torch`` and never ``jax``, and
nothing of the JAX package: it keeps its own copies of the host layers it
needs (``constants``, ``tokenization``, ``media/video`` and the ``Score``
facades in ``score``).

    import t2v_metrics_tpu_torch as t2v
    scorer = t2v.VQAScore(model="clip-flant5-xl", init="random")
    scores = scorer(images=[uint8_hwc_array], texts=["a photo of a cat"])
    t2v.CLIPScore("openai:ViT-B-32", init="random")   # cosine similarity
    t2v.ITMScore("blip2-itm", init="random")          # BLIP-2 P(match)

The entry points run on the GPU and raise without one; ``device="cpu"``
asks for the CPU. The VQAScore models are clip-flant5 (xl, xxl; xxl also in
the W8A8 modes ``quant="int8"`` and ``"int8+vit"``), Qwen2.5-VL (3b, 7b,
32b, 72b), Qwen3-VL (dense and MoE), Gemma 3 (4b, 12b, 27b), PaliGemma
(mix-224, 448, 896), Gemma 4 (12b, 31b), Molmo2 (4b, 7b, 8b), InternVL 3 /
3.5 (1b to 241b-a28b), LLaVA-1.5 (7b, 13b), InstructBLIP (flant5-xl,
xxl) and the remote API scorers GPT-4o / GPT-4.1 / GPT-4-turbo and Gemini
2.5 (no model on the card: ``device`` is ignored); CLIPScore takes the OpenCLIP ``pretrain_tag:Arch`` names
(ViT-B-32, B-16, L-14, L-14-336) and ITMScore BLIP-2's ITM head
(``blip2-itm``, ``blip2-itm-coco``); both score video through frames
concatenated into one image. On CUDA tensors the hot ops run hand-written
Hopper kernels (the flat and per-head flash attention
``csrc/flash_flat.cu`` and ``csrc/flash_attention.cu``, LayerNorm
``csrc/layer_norm.cu``, the MoE grouped GEMM ``csrc/grouped_gemm.cu``, the
int8 GEMM ``csrc/quant_matmul.cu``, the Triton RMSNorm in
``ops/norms.py``, the Triton rotary embedding in ``ops/rope.py`` and the
Triton row quant in ``ops/quant.py``); on CPU tensors the same entry points
run their plain PyTorch versions.

The benchmark harnesses come with it: ``benchmarks`` (the datasets and
statistics), ``cli`` (GenAI-Bench image / video / ranking, the paper
benchmarks, ``python -m t2v_metrics_tpu_torch.cli.genai_image_eval ...``)
and ``camerabench``.
"""

from . import constants
from .score import CLIPScore, ITMScore, Score, VQAScore
from .registry import (list_all_clipscore_models, list_all_itmscore_models,
                       list_all_vqascore_models)
from .tokenization import SimpleT5Tokenizer

# SimpleT5Tokenizer builds its vocabulary as it meets words: scorers that
# must agree on token ids share one instance (``tokenizer=``).
__all__ = ["CLIPScore", "ITMScore", "Score", "SimpleT5Tokenizer", "VQAScore",
           "constants", "get_score_model", "list_all_clipscore_models", "list_all_itmscore_models",
           "list_all_models", "list_all_vqascore_models"]


def list_all_models() -> list[str]:
    """Every registered scoring model: VQAScore's, CLIPScore's, ITMScore's."""
    return (list_all_vqascore_models() + list_all_clipscore_models()
            + list_all_itmscore_models())


def get_score_model(model: str = "clip-flant5-xxl", device=None,
                    cache_dir: str | None = None, **kwargs) -> Score:
    """The facade that scores ``model``; ``device`` None is the GPU."""
    if model in list_all_vqascore_models():
        return VQAScore(model, device, cache_dir, **kwargs)
    if model in list_all_clipscore_models():
        return CLIPScore(model, device, cache_dir, **kwargs)
    if model in list_all_itmscore_models():
        return ITMScore(model, device, cache_dir, **kwargs)
    raise ValueError(f"unknown model {model!r}; available: {list_all_models()}")
