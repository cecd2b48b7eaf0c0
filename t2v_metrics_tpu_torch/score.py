"""The port's VQAScore facade.

It reuses the JAX package's generic ``Score`` (``forward``,
``batch_forward`` and its staged pipeline), which is jax-free, and binds it
to the port's registry.
"""

from __future__ import annotations

from t2v_metrics_tpu.score import Score

from .registry import get_vqascore_model, list_all_vqascore_models


class VQAScore(Score):
    """P("Yes") answer-likelihood scoring on PyTorch.

    ``device``: "cuda", "cpu", or left out to take the GPU when there is one.
    """

    def prepare_scoremodel(self, model, device, cache_dir, **kwargs):
        # "tpu" is the shared facade's default device name: let the port pick
        return get_vqascore_model(model, None if device == "tpu" else device,
                                  cache_dir, **kwargs)

    def list_all_models(self) -> list[str]:
        return list_all_vqascore_models()
