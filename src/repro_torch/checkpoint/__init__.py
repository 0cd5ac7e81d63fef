"""Checkpoints of the port (``repro.checkpoint``), in the reference's format."""
from repro_torch.checkpoint.io import load_meta, load_pytree, save_pytree

__all__ = ["load_meta", "load_pytree", "save_pytree"]
