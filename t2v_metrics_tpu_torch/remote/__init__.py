"""Scorers behind remote APIs (the port's copies of t2v_metrics_tpu/remote)."""

from ..models.adapters import VQAScoreModel


class RemoteVQAScoreModel(VQAScoreModel):
    """A VQAScore model behind a remote API: it holds no weights, and its
    ``device`` is kept as given and never resolved, so it asks for no GPU."""

    def __init__(self, model_name: str, device=None, cache_dir: str | None = None,
                 **kwargs):
        self.model_name = model_name
        self.device = device
        self.cache_dir = cache_dir
        self.kwargs = kwargs
        self.load_model()
