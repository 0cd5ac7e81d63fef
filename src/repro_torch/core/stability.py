"""§IV deployment/stability model: Eqs. (4)-(8) + a Poisson-process simulator.

The paper models iteration completions as a Poisson process with rate
lambda = n*p; with k approvals per new transaction the equilibrium tip count
is L0 = k*lambda*h/(k-1) (Eq. 4, following the tangle analysis), with the
per-iteration delay h = d0 + d1 from the Table-I constants (Eqs. 5-7).
``simulate_tip_count`` verifies Eq. (4) empirically — the bench
``stability_tips`` compares the two.

The port's copy of ``repro.core.stability`` (numpy only): identical values,
and identical traces on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import DagFLConfig


def training_delay(cfg: DagFLConfig, f: float) -> float:
    """Eq. (5): d0 = eta0 * phi0 * beta / f."""
    return cfg.train_density * cfg.minibatch_size_bits * cfg.beta / f


def validation_delay(cfg: DagFLConfig, f: float) -> float:
    """Eq. (6): d1 = eta1 * phi1 * alpha / f."""
    return cfg.validate_density * cfg.valset_size_bits * cfg.alpha / f


def iteration_delay(cfg: DagFLConfig, f: float) -> float:
    """Eq. (7): h = d0 + d1."""
    return training_delay(cfg, f) + validation_delay(cfg, f)


def transmission_delay(cfg: DagFLConfig) -> float:
    """Broadcasting one transaction of phi bits at bandwidth B."""
    return cfg.tx_size_bits / cfg.bandwidth


def equilibrium_tips(cfg: DagFLConfig, f: Optional[float] = None) -> float:
    """Eq. (8): L0 = k*lambda*(eta0*phi0*beta + eta1*phi1*alpha) / ((k-1)*f)."""
    if f is None:
        f = 0.5 * (cfg.cpu_freq_range[0] + cfg.cpu_freq_range[1])
    h = iteration_delay(cfg, f)
    return cfg.k * cfg.arrival_rate * h / (cfg.k - 1)


def tail_mean(tips: np.ndarray, frac: float = 0.5) -> float:
    """Mean over the trailing ``frac`` of samples (equilibrium estimate).

    ``n`` is clamped to >= 1: a short trace (``len * frac < 1``) degrades
    to the last sample instead of ``tips[-0:]`` silently averaging the
    WHOLE trace, and an empty trace is NaN rather than a numpy warning.
    Shared by ``TipTrace`` (the standalone sim) and
    ``repro_torch.net.events.InSystemTrace`` (the in-system sim) so the two
    equilibrium estimates use one rule.
    """
    if len(tips) == 0:
        return float("nan")
    n = max(int(len(tips) * frac), 1)
    return float(np.mean(tips[-n:]))


@dataclass
class TipTrace:
    times: np.ndarray
    tips: np.ndarray

    def tail_mean(self, frac: float = 0.5) -> float:
        return tail_mean(self.tips, frac)


def simulate_tip_count(
    cfg: DagFLConfig,
    horizon: float = 2000.0,
    seed: int = 0,
    f: Optional[float] = None,
) -> TipTrace:
    """Event-driven M/G/inf-style simulation of the tip population.

    Arrivals ~ Poisson(lambda); each iteration takes h seconds during which
    the node has already *reserved* (validated) k tips; at completion the
    new transaction becomes a tip and its k approvals stop being tips.
    The k selected tips are only marked approved at publish time (the paper's
    stage 4), so in-flight iterations can pick overlapping tips — that
    overlap is exactly why the equilibrium exceeds lambda*h/(k-1)*k only
    approximately; Eq. (4) matches the long-run mean.
    """
    if f is None:
        f = 0.5 * (cfg.cpu_freq_range[0] + cfg.cpu_freq_range[1])
    h = iteration_delay(cfg, f)
    rng = np.random.default_rng(seed)
    lam = cfg.arrival_rate

    tips: set = {0}
    next_id = 1
    pending: list = []          # (finish_time, approved ids)
    t = 0.0
    times, counts = [0.0], [1]

    while t < horizon:
        t += rng.exponential(1.0 / lam)
        # complete any pending iterations first
        pending.sort()
        while pending and pending[0][0] <= t:
            _, approved, tid = pending.pop(0)
            for a in approved:
                tips.discard(a)
            tips.add(tid)
            times.append(t)
            counts.append(len(tips))
        # new iteration starts now: select (up to) k distinct current tips
        pool = list(tips)
        kk = min(cfg.k, len(pool))
        approved = list(rng.choice(pool, size=kk, replace=False)) if kk else []
        pending.append((t + h, approved, next_id))
        next_id += 1

    return TipTrace(np.asarray(times), np.asarray(counts, np.float64))
