"""Table-I latency model (Eqs. 5-7 + transmission), host numpy.

The port's copy of ``repro.fl.latency``: the same config and seed give the
same draws.

  d0 = eta0 * phi0 * beta / f_i          training delay        (Eq. 5)
  d1 = eta1 * phi1 * alpha / f_i         validation delay      (Eq. 6)
  t_tx = phi / B                         one model transfer
  PoW ~ Exp(mean 5 s)                    Block FL consensus    (Section V.A)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import DagFLConfig


@dataclass
class LatencyModel:
    cfg: DagFLConfig
    freqs: np.ndarray             # (N,) per-node CPU frequency
    pow_mean: float = 5.0         # Section V.A: PoW solves in ~5 s
    block_collect: int = 5        # miner publishes after 5 tx ...
    block_timeout: float = 10.0   # ... or 10 s
    google_cohort: int = 10       # nodes per synchronous round

    @classmethod
    def create(cls, cfg: DagFLConfig, seed: int = 0) -> "LatencyModel":
        rng = np.random.default_rng(seed)
        lo, hi = cfg.cpu_freq_range
        return cls(cfg=cfg, freqs=rng.uniform(lo, hi, cfg.num_nodes))

    # --- Eq. (5)-(7) ------------------------------------------------------
    def _train_cycles(self) -> float:
        c = self.cfg
        return c.train_density * c.minibatch_size_bits * c.beta

    def _validate_cycles(self) -> float:
        c = self.cfg
        return c.validate_density * c.valset_size_bits * c.alpha

    def d0(self, node: int) -> float:
        return self._train_cycles() / self.freqs[node]

    def d1(self, node: int) -> float:
        return self._validate_cycles() / self.freqs[node]

    def h(self, node: int) -> float:
        return self.d0(node) + self.d1(node)

    def h_all(self) -> np.ndarray:
        """(N,) per-node Eq. (7) iteration delay h_i = d0_i + d1_i.

        Divides before summing so ``h_all()[i]`` is bitwise ``h(i)``.
        """
        return (self._train_cycles() / self.freqs
                + self._validate_cycles() / self.freqs)

    def tx_time(self) -> float:
        return self.cfg.tx_size_bits / self.cfg.bandwidth

    # --- per-system iteration delays ---------------------------------------
    def dagfl_iteration(self, node: int, lazy: bool = False) -> float:
        """Validate alpha tips + train + publish (models already local)."""
        train = 0.0 if lazy else self.d0(node)
        return self.d1(node) + train + self.tx_time()

    def google_iteration(self, node: int, lazy: bool = False) -> float:
        """Download global + train + upload (no validation burden)."""
        train = 0.0 if lazy else self.d0(node)
        return 2 * self.tx_time() + train

    def async_iteration(self, node: int, lazy: bool = False) -> float:
        train = 0.0 if lazy else self.d0(node)
        return 2 * self.tx_time() + train

    def block_iteration(self, node: int, lazy: bool = False) -> float:
        """Node-side only; miner adds collection wait + PoW + block bcast."""
        train = 0.0 if lazy else self.d0(node)
        return 2 * self.tx_time() + train

    def pow_time(self, rng: np.random.Generator) -> float:
        return float(rng.exponential(self.pow_mean))
