"""Model bank: transaction payloads as rows of one flat ``(slots, P)`` tensor.

Slot i is transaction i's model, flattened in the reference's
``flatten_params`` order. Rows are padded to a 16-byte stride
(``kernels.fedavg.alloc_rows``) so the Eq.-(1) kernel can gather the k
chosen rows in place, with no copy of the k models.

The bank is updated in place: ``bank_write`` copies into its row and returns
the same ``Bank``. Everything that reads a stored model (``bank_read``,
``bank_gather``) returns a copy, so training or averaging can never write
into the bank and break a stored model's authentication tag.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregation import Shapes, flatten_params, leaf_shapes, unflatten_params
from repro_torch.core.dag import as_index
from repro_torch.kernels import fedavg as fedavg_kernel


class Bank(NamedTuple):
    rows: torch.Tensor      # (slots, P) one flat model per slot
    shapes: Shapes          # (name, shape) of the leaves, in flatten order


def init_bank(template: Dict[str, torch.Tensor], slots: int) -> Bank:
    """A zeroed f32 bank of ``slots`` models shaped like ``template``."""
    shapes = leaf_shapes(template)
    size = sum(math.prod(shape) for _, shape in shapes)
    device = next(iter(template.values())).device
    return Bank(fedavg_kernel.alloc_rows(slots, size, torch.float32, device), shapes)


def bank_write(bank: Bank, slot, params: Dict[str, torch.Tensor]) -> Bank:
    """Store ``params`` at ``slot``, in place."""
    bank.rows[as_index(slot, bank.rows.device)] = flatten_params(params).unsqueeze(0)
    return bank


def bank_read(bank: Bank, slot) -> Dict[str, torch.Tensor]:
    """A copy of the model at ``slot``."""
    row = bank.rows.index_select(0, as_index(slot, bank.rows.device))[0]
    return unflatten_params(row, bank.shapes)


def bank_gather(bank: Bank, slots: torch.Tensor) -> torch.Tensor:
    """slots (k,) -> a copy of their flat rows (k, P); invalid slots clamp to 0.

    The reference returns the stacked pytree; ``unflatten_params`` of these
    rows is that pytree.
    """
    return bank.rows.index_select(0, slots.clamp(min=0).long())


def bank_average(bank: Bank, slots: torch.Tensor, weights: torch.Tensor) -> Dict:
    """Eq. (1) over bank slots, through the gather kernel.

    slots (k,) int32 (NO_TX = -1 entries get zero weight); weights (k,) f32,
    renormalized over the valid slots. A slot chosen twice adds twice, as
    the reference's one-hot sum does.
    """
    w = torch.where(slots >= 0, weights.float(), 0.0)
    w = w / torch.clamp(torch.sum(w), min=1e-9)
    safe = slots.clamp(min=0).to(torch.int32)
    out = fedavg_kernel.fedavg_gather(bank.rows, safe, w)
    return unflatten_params(out, bank.shapes)


def _frequency(leaf: int) -> float:
    # formed in double and rounded to f32 once, as the reference's weakly
    # typed constant is
    return float(np.float32(0.618033988749895 + 0.001 * leaf))


def checksum_rows(rows: torch.Tensor, shapes: Shapes) -> torch.Tensor:
    """``auth_checksum`` of flat models (..., P) -> (...)."""
    total = torch.zeros(rows.shape[:-1], dtype=torch.float32, device=rows.device)
    ofs = 0
    for i, (_, shape) in enumerate(shapes):
        n = math.prod(shape)
        idx = torch.arange(n, dtype=torch.float32, device=rows.device)
        proj = torch.cos(idx * _frequency(i))
        total = total + rows[..., ofs:ofs + n].float() @ proj
        ofs += n
    return total


def auth_checksum(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cheap integrity tag standing in for the RSA signature.

    A fixed pseudo-random projection of every leaf (leaf i weighted by
    ``cos(idx * (0.618... + 0.001 i))``): any bit flip in the payload moves
    the tag.
    """
    return checksum_rows(flatten_params(params), leaf_shapes(params))
