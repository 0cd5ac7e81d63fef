"""Anomaly detection (§V.4 + §VI.B): contribution rates and credit scores.

The paper's detector: a transaction with <= m approvals is *isolated*; a
node's contribution rate r = contributing / published. Abnormal nodes show
r0 / r well below 1 (Table IV). ``credit_scores`` implements the §VI.B
extension (tips from low-credit nodes get down-weighted during selection),
``rejection_credit`` its transport-layer complement (fault injection,
``repro_torch.net.faults``), and ``parameter_outlier_scores`` the §VI.A-style
model-space validation on the pairwise-distance kernel
(``repro_torch.kernels.model_distance``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dag import DagState
from repro_torch.kernels import model_distance as md_kernel


class ContributionReport(NamedTuple):
    rates: torch.Tensor         # (N,) per-node contribution rate
    mean_rate: torch.Tensor     # ()   r   (all nodes)
    flagged: torch.Tensor       # (N,) bool — below threshold


def contribution_rates(dag: DagState, m: int = 0) -> torch.Tensor:
    contrib = dag.contributing_m0 if m == 0 else dag.contributing_m1
    pub = torch.clamp(dag.published_per_node, min=1)
    return contrib.float() / pub.float()


def contribution_report(
    dag: DagState, m: int = 0, flag_fraction: float = 0.5
) -> ContributionReport:
    rates = contribution_rates(dag, m)
    active = dag.published_per_node > 0
    mean = torch.sum(torch.where(active, rates, 0.0)) / torch.clamp(torch.sum(active), min=1)
    flagged = active & (rates < flag_fraction * mean)
    return ContributionReport(rates, mean, flagged)


def credit_scores(dag: DagState, m: int = 0, floor: float = 0.05) -> torch.Tensor:
    """§VI.B: per-node credit in [floor, 1], proportional to contribution."""
    rates = contribution_rates(dag, m)
    mean = torch.clamp(torch.mean(rates), min=1e-6)
    return torch.clamp(rates / mean, floor, 1.0)


def rejection_credit(
    rejects: torch.Tensor, floor: float = 0.05, scale: float = 1.0
) -> torch.Tensor:
    """Per-sender trust from digest-rejection counts.

    ``rejects`` is an (N, N) matrix: receiver i charged sender j one count
    per chunk that failed digest verification. A sender's credit decays
    exponentially in its TOTAL rejections across all receivers, clipped to
    ``[floor, 1]``: a clean node keeps exactly 1.0, a spoofer collapses to
    the floor within a few rejected chunks.
    """
    per_sender = torch.sum(torch.as_tensor(rejects).to(torch.int32), dim=0).float()
    return torch.clamp(torch.exp(-scale * per_sender), floor, 1.0)


def credit_weighted_tip_scores(
    dag: DagState, tip_scores: torch.Tensor, credits: torch.Tensor
) -> torch.Tensor:
    """Scale gumbel tip-selection scores by the publisher's credit."""
    pub = torch.clamp(dag.publisher, min=0).long()
    c = credits[pub]
    return tip_scores + torch.log(torch.where(dag.publisher >= 0, c, 1.0))


def parameter_outlier_scores(flat_models: torch.Tensor) -> torch.Tensor:
    """§VI.A-style model-space screening of candidate tips.

    flat_models (k, N) -> (k,) mean squared-L2 distance to the other
    candidates (``model_distance``: the kernel on a card); poisoned models
    sit far from the normal cluster.
    """
    d = md_kernel.model_distance(flat_models)                 # (k, k)
    k = d.shape[0]
    off = torch.where(torch.eye(k, dtype=torch.bool, device=d.device), 0.0, d)
    total = off.sum(dim=1)
    # a tensor divisor: a Python scalar would be a reciprocal multiply
    return total / torch.full_like(total, max(k - 1, 1))
