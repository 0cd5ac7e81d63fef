"""The port's model zoo: the dense transformer and RWKV6 (``Model``, ``build_model``)."""
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
