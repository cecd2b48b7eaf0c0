"""Model registry of the port: name -> adapter, for the three scorers.

The VQAScore families are listed in the JAX registry's order, the remote API
scorers (GPT-4o, Gemini) last; their modules are imported when a list or an
adapter is first asked for."""

from __future__ import annotations


def _vqa_families():
    """(names, adapter class) of each VQAScore family, in order."""
    from .models.adapters import CLIP_T5_MODELS, CLIPT5Adapter
    from .models.gemma3 import GEMMA3_MODELS
    from .models.gemma4 import GEMMA4_MODELS
    from .models.gemma_adapters import Gemma3Adapter, Gemma4Adapter, PaliGemmaAdapter
    from .models.instructblip import INSTRUCTBLIP_MODELS
    from .models.instructblip_adapter import InstructBlipAdapter
    from .models.internvl import INTERNVL_MODELS
    from .models.internvl_adapter import InternVLAdapter
    from .models.llava import LLAVA_MODELS
    from .models.llava_adapter import LlavaAdapter
    from .models.molmo2 import MOLMO2_MODELS
    from .models.molmo2_adapter import Molmo2Adapter
    from .models.paligemma import PALIGEMMA_MODELS
    from .models.qwen2vl import QWEN2_VL_MODELS
    from .models.qwen2vl_adapter import Qwen2VLAdapter
    from .models.qwen3omni import QWEN3_OMNI_MODELS
    from .models.qwen3omni_adapter import Qwen3OmniAdapter
    from .models.qwen3vl import QWEN3_VL_MODELS
    from .models.qwen3vl_adapter import Qwen3VLAdapter
    from .remote.gemini import GEMINI_MODELS, GeminiAdapter
    from .remote.gpt4v import GPT4V_MODELS, GPT4VAdapter

    return [(CLIP_T5_MODELS, CLIPT5Adapter), (QWEN2_VL_MODELS, Qwen2VLAdapter),
            (QWEN3_VL_MODELS, Qwen3VLAdapter), (GEMMA3_MODELS, Gemma3Adapter),
            (PALIGEMMA_MODELS, PaliGemmaAdapter), (GEMMA4_MODELS, Gemma4Adapter),
            (MOLMO2_MODELS, Molmo2Adapter), (QWEN3_OMNI_MODELS, Qwen3OmniAdapter),
            (INTERNVL_MODELS, InternVLAdapter),
            (LLAVA_MODELS, LlavaAdapter), (INSTRUCTBLIP_MODELS, InstructBlipAdapter),
            (GPT4V_MODELS, GPT4VAdapter), (GEMINI_MODELS, GeminiAdapter)]


def list_all_vqascore_models() -> list[str]:
    return [name for names, _ in _vqa_families() for name in names]


def get_vqascore_model(model_name: str, device=None,
                       cache_dir: str | None = None, **kwargs):
    for names, adapter in _vqa_families():
        if model_name in names:
            return adapter(model_name, device, cache_dir, **kwargs)
    raise ValueError(f"unknown VQAScore model {model_name!r}; "
                     f"available: {list_all_vqascore_models()}")


def list_all_clipscore_models() -> list[str]:
    from .models.adapters import CLIP_SCORE_MODELS

    return list(CLIP_SCORE_MODELS)


def list_all_itmscore_models() -> list[str]:
    from .models.blip2_itm import BLIP2_ITM_MODELS

    return list(BLIP2_ITM_MODELS)


def get_clipscore_model(model_name: str, device=None,
                        cache_dir: str | None = None, **kwargs):
    """A registered name, or any ``pretrain_tag:Arch`` name whose Arch is a
    known architecture."""
    from .models.adapters import CLIPScoreAdapter, resolve_clipscore_name

    if resolve_clipscore_name(model_name) is None:
        raise ValueError(f"unknown CLIPScore model {model_name!r}; "
                         f"available: {list_all_clipscore_models()}")
    return CLIPScoreAdapter(model_name, device, cache_dir, **kwargs)


def get_itmscore_model(model_name: str, device=None,
                       cache_dir: str | None = None, **kwargs):
    if model_name not in list_all_itmscore_models():
        raise ValueError(f"unknown ITMScore model {model_name!r}; "
                         f"available: {list_all_itmscore_models()}")
    from .models.itm_adapter import Blip2ITMAdapter

    return Blip2ITMAdapter(model_name, device, cache_dir, **kwargs)
