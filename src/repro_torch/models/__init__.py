"""Model substrate: the dense decoder-only stack so far."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
