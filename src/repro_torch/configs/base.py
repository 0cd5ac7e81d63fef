"""DAG-FL deployment configuration (paper Table I + Algorithm params).

The port's copy of ``repro.configs.base.DagFLConfig``; ``ModelConfig`` and
the model-zoo shapes come with the model-zoo slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DagFLConfig:
    """Parameters of Algorithms 1 & 2 and the Table-I platform constants."""

    num_nodes: int = 100
    alpha: int = 5                  # tips sampled & validated per iteration
    k: int = 2                      # tips aggregated/approved (k < alpha)
    tau_max: float = 20.0           # staleness threshold [s]
    beta: int = 1                   # local epochs per iteration
    minibatch: int = 100
    target_accuracy: float = 0.97   # ACC_0 of Algorithm 1
    isolation_m: int = 0            # <= m approvals => isolated transaction
    capacity: int = 512             # ledger slots (struct-of-arrays)

    # Table-I platform constants (used by the latency model / simulator)
    tx_size_bits: float = 7e6 * 8            # phi   (CNN task default, 7 MB)
    minibatch_size_bits: float = 0.3e6 * 8   # phi_0
    valset_size_bits: float = 0.3e6 * 8      # phi_1
    train_density: float = 500.0             # eta_0 [cycles/bit]
    validate_density: float = 160.0          # eta_1 [cycles/bit]
    cpu_freq_range: Tuple[float, float] = (1e9, 2e9)  # f [Hz]
    bandwidth: float = 100e6                 # B [bit/s]
    arrival_rate: float = 1.0                # lambda [iterations/s]

    def __post_init__(self):
        if not self.k < self.alpha:
            raise ValueError("paper requires k < alpha")

    def expected_tips(self, h: Optional[float] = None) -> float:
        """Eq. (4): L0 = k*lambda*h / (k-1)."""
        if h is None:
            h = self.iteration_delay()
        return self.k * self.arrival_rate * h / (self.k - 1)

    def iteration_delay(self, f: Optional[float] = None) -> float:
        """Eqs. (5)-(7): h = d0 + d1 at mean CPU frequency."""
        if f is None:
            f = 0.5 * (self.cpu_freq_range[0] + self.cpu_freq_range[1])
        d0 = self.train_density * self.minibatch_size_bits * self.beta / f
        d1 = self.validate_density * self.valset_size_bits * self.alpha / f
        return d0 + d1
