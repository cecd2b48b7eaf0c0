"""Model registry of the port: name -> adapter."""

from __future__ import annotations


def list_all_vqascore_models() -> list[str]:
    from .models.adapters import CLIP_T5_MODELS

    return list(CLIP_T5_MODELS)


def get_vqascore_model(model_name: str, device=None,
                       cache_dir: str | None = None, **kwargs):
    from .models.adapters import CLIP_T5_MODELS, CLIPT5Adapter

    if model_name in CLIP_T5_MODELS:
        return CLIPT5Adapter(model_name, device, cache_dir, **kwargs)
    raise ValueError(f"unknown VQAScore model {model_name!r}; "
                     f"available: {list_all_vqascore_models()}")
