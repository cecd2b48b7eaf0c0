"""Model registry of the port: name -> adapter."""

from __future__ import annotations


def list_all_vqascore_models() -> list[str]:
    from .models.adapters import CLIP_T5_MODELS
    from .models.qwen2vl import QWEN2_VL_MODELS

    return [*CLIP_T5_MODELS, *QWEN2_VL_MODELS]


def get_vqascore_model(model_name: str, device=None,
                       cache_dir: str | None = None, **kwargs):
    from .models.adapters import CLIP_T5_MODELS, CLIPT5Adapter
    from .models.qwen2vl import QWEN2_VL_MODELS

    if model_name in CLIP_T5_MODELS:
        return CLIPT5Adapter(model_name, device, cache_dir, **kwargs)
    if model_name in QWEN2_VL_MODELS:
        from .models.qwen2vl_adapter import Qwen2VLAdapter

        return Qwen2VLAdapter(model_name, device, cache_dir, **kwargs)
    raise ValueError(f"unknown VQAScore model {model_name!r}; "
                     f"available: {list_all_vqascore_models()}")
