"""Model substrate: the decoder-only stack of every text family the port carries."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
