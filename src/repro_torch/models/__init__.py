"""The port's model zoo: the dense transformer (``Model``, ``build_model``)."""
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
