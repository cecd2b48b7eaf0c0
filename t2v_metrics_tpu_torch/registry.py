"""Model registry of the port: name -> adapter, for the three scorers."""

from __future__ import annotations


def list_all_vqascore_models() -> list[str]:
    from .models.adapters import CLIP_T5_MODELS
    from .models.gemma3 import GEMMA3_MODELS
    from .models.qwen2vl import QWEN2_VL_MODELS
    from .models.qwen3vl import QWEN3_VL_MODELS

    return [*CLIP_T5_MODELS, *QWEN2_VL_MODELS, *QWEN3_VL_MODELS, *GEMMA3_MODELS]


def get_vqascore_model(model_name: str, device=None,
                       cache_dir: str | None = None, **kwargs):
    from .models.adapters import CLIP_T5_MODELS, CLIPT5Adapter
    from .models.gemma3 import GEMMA3_MODELS
    from .models.qwen2vl import QWEN2_VL_MODELS
    from .models.qwen3vl import QWEN3_VL_MODELS

    if model_name in CLIP_T5_MODELS:
        return CLIPT5Adapter(model_name, device, cache_dir, **kwargs)
    if model_name in QWEN2_VL_MODELS:
        from .models.qwen2vl_adapter import Qwen2VLAdapter

        return Qwen2VLAdapter(model_name, device, cache_dir, **kwargs)
    if model_name in QWEN3_VL_MODELS:
        from .models.qwen3vl_adapter import Qwen3VLAdapter

        return Qwen3VLAdapter(model_name, device, cache_dir, **kwargs)
    if model_name in GEMMA3_MODELS:
        from .models.gemma_adapters import Gemma3Adapter

        return Gemma3Adapter(model_name, device, cache_dir, **kwargs)
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
