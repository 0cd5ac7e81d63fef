"""Eq.-(1) FederatedAveraging, the §VI.C weighted extension, and the flat layout.

A model is a dict of leaves in the reference's layout. Its flat form, one
row of the model bank, concatenates the leaves in sorted-name order, which
is the order ``jax.tree_util.tree_leaves`` visits a dict in, so a flat row
is exactly the reference's ``flatten_params``.

Eq. (1) runs on the main path as ``repro_torch.core.bank.bank_average``,
the CUDA kernel over bank rows in place; ``fedavg_pytree`` is the leaf-wise
weighted sum over stacked models (clear, autograd-safe).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shapes = Tuple[Tuple[str, Tuple[int, ...]], ...]


def uniform_weights(k: int, device=None) -> torch.Tensor:
    """Paper default: n_i = 1/k."""
    return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)


def fedavg_pytree(stacked: Dict[str, torch.Tensor], weights: torch.Tensor) -> Dict:
    """stacked: leaves with a leading k axis; weights (k,) summing to 1."""

    def avg(leaf):
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).float()
        return torch.sum(leaf.float() * w, dim=0).to(leaf.dtype)

    return {name: avg(leaf) for name, leaf in stacked.items()}


def leaf_shapes(params: Dict[str, torch.Tensor]) -> Shapes:
    """(name, shape) of every leaf, in flatten order."""
    return tuple((name, tuple(params[name].shape)) for name in sorted(params))


def flatten_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One f32 vector: the leaves in sorted-name order."""
    return torch.cat([params[name].reshape(-1).float() for name in sorted(params)])


def unflatten_params(flat: torch.Tensor, shapes: Shapes) -> Dict[str, torch.Tensor]:
    """Leaves as views of ``flat`` (..., P); leading axes are kept."""
    out, ofs = {}, 0
    lead = tuple(flat.shape[:-1])
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[..., ofs:ofs + n].reshape(lead + shape)
        ofs += n
    if ofs != flat.shape[-1]:
        raise ValueError(f"flat size {flat.shape[-1]} != {ofs} from the leaf shapes")
    return out


def staleness_accuracy_weights(
    accuracies: torch.Tensor,     # (k,) f32
    staleness: torch.Tensor,      # (k,) f32 seconds
    tau_max: float,
    temperature: float = 4.0,
) -> torch.Tensor:
    """§VI.C weighted aggregation: fresher + more accurate tips weigh more.

    w_i ∝ softmax(temperature * acc_i) * (1 - staleness_i / (2*tau_max)).
    Reduces to ~uniform when accuracies/staleness are equal.
    """
    a = torch.softmax(temperature * accuracies, dim=-1)
    fresh = torch.clamp(1.0 - staleness / (2.0 * tau_max), 0.1, 1.0)
    w = a * fresh
    return w / torch.clamp(torch.sum(w), min=1e-9)
