"""Algorithm 1 — DAG-FL Controlling, run by the external agent E.

E is a host-side smart-contract analogue: it publishes the genesis
transaction, periodically reconstructs a candidate target model from the
best-k tips of its local DAG, and broadcasts the end signal once
ACC_t >= ACC_0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import DagFLConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import bank as bank_lib
from repro_torch.core import dag as dag_lib
from repro_torch.core import validation as val_lib
from repro_torch.device import resolve_device


@dataclass
class ControllerState:
    dag: dag_lib.DagState
    bank: bank_lib.Bank
    done: bool = False
    best_accuracy: float = 0.0
    target_model: Any = None
    checks: int = 0
    aggregations: int = 0           # checks that found a usable tip and built omega_0


class Controller:
    """External agent E (Algorithm 1), with its ledger on ``device``."""

    def __init__(
        self,
        cfg: DagFLConfig,
        eval_fn: Callable[[Any, Any], torch.Tensor],
        target_accuracy: Optional[float] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.validator = val_lib.make_validator(eval_fn)
        self.acc0 = target_accuracy if target_accuracy is not None else cfg.target_accuracy
        self.device = resolve_device(device)

    def genesis(self, init_params: Any, val_batch, capacity: Optional[int] = None) -> ControllerState:
        """Initialize the ledger with the initial model transaction."""
        cap = capacity or self.cfg.capacity
        params = {name: leaf.to(self.device) for name, leaf in init_params.items()}
        dag = dag_lib.empty_dag(cap, self.cfg.k, self.cfg.num_nodes + 1, self.device)
        bank = bank_lib.init_bank(params, cap)
        bank = bank_lib.bank_write(bank, 0, params)
        acc = self.eval_fn(params, val_batch)
        dag = dag_lib.publish(
            dag,
            self.cfg.num_nodes,                             # E's node id
            torch.zeros((), dtype=torch.float32, device=self.device),
            torch.full((self.cfg.k,), dag_lib.NO_TX, dtype=torch.int32, device=self.device),
            acc.float(),
            bank_lib.auth_checksum(params),
            0,
        )
        return ControllerState(dag=dag, bank=bank)

    def check(self, state: ControllerState, uniform: torch.Tensor, now: float,
              val_batch) -> ControllerState:
        """One Algorithm-1 loop body: validate alpha tips, build omega_0,
        test ACC_t >= ACC_0. ``uniform`` is the (cap,) tip-selection draw."""
        now_f32 = torch.tensor(now, dtype=torch.float32, device=self.device)
        rows, _ = dag_lib.select_tips(state.dag, uniform, self.cfg.alpha, now_f32,
                                      self.cfg.tau_max)
        slots = torch.where(rows >= 0, state.dag.model_slot[rows.clamp(min=0).long()], -1)
        accs = self.validator(state.bank, slots, val_batch)
        chosen, _, _ = val_lib.select_top_k(accs, slots, self.cfg.k)
        n_ok = int(torch.sum(chosen >= 0))
        state.checks += 1
        if n_ok == 0:
            return state
        model = bank_lib.bank_average(
            state.bank, chosen, agg.uniform_weights(self.cfg.k, device=self.device)
        )
        state.aggregations += 1
        acc_t = float(self.eval_fn(model, val_batch))
        if acc_t > state.best_accuracy:
            state.best_accuracy = acc_t
            state.target_model = model
        if acc_t >= self.acc0:
            state.done = True                               # end signal to D
        return state
