"""Stage-2 validation: authenticate tips + score their models (consensus).

``make_validator(eval_fn)`` builds a function that, given the model bank and
alpha candidate slots, returns per-candidate accuracy. The paper validates
with a small local test set (Section III.B).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import bank as bank_lib
from repro_torch.core.aggregation import unflatten_params
from repro_torch.core.dag import top_k


def make_validator(eval_fn: Callable[[Any, Any], torch.Tensor]):
    """eval_fn(params, batch) -> scalar accuracy in [0, 1]."""

    def validate(model_bank: bank_lib.Bank, slots: torch.Tensor, batch) -> torch.Tensor:
        """slots (alpha,) int32 (NO_TX padded) -> accuracies (alpha,) f32.

        Invalid slots score -inf so top-k never picks them.
        """
        cands = bank_lib.bank_gather(model_bank, slots)
        accs = torch.stack([
            eval_fn(unflatten_params(row, model_bank.shapes), batch).float()
            for row in cands
        ])
        return torch.where(slots >= 0, accs, -torch.inf)

    return validate


def authenticate(dag_tags: torch.Tensor, model_bank: bank_lib.Bank,
                 slots: torch.Tensor) -> torch.Tensor:
    """Recompute payload checksums and compare with the published tags."""
    tags = bank_lib.checksum_rows(bank_lib.bank_gather(model_bank, slots), model_bank.shapes)
    stored = dag_tags[slots.clamp(min=0).long()]
    ok = torch.abs(tags - stored) <= 1e-3 * (1.0 + torch.abs(stored))
    return ok & (slots >= 0)


def select_top_k(accuracies: torch.Tensor, slots: torch.Tensor, k: int):
    """Stage 3: keep the k highest-accuracy validated tips, ties to the
    lower position.

    Returns (chosen slots (k,) int32, their positions (k,), their accuracies).
    """
    top_acc, top_pos = top_k(accuracies, k)
    chosen = torch.where(torch.isfinite(top_acc), slots[top_pos], -1)
    return chosen.to(torch.int32), top_pos, top_acc
