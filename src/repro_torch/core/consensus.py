"""DAG-FL consensus: Algorithm 2, split at the iteration's start and end.

Stage 1  select <= alpha tips within tau_max          (dag.select_tips)
Stage 2  authenticate + validate their models          (validation)
Stage 3  FedAvg the k best, train beta epochs locally  (bank_average + train_fn)
Stage 4  publish the new transaction with k approvals  (dag.publish_at)

``make_dagfl_stages`` closes over the task's ``eval_fn(params, batch)`` and
``train_fn(params, batch) -> (params, metrics)``. The reference also hands
``train_fn`` a PRNG key, which the paper's tasks never read; the port's
draws are the (cap,) uniforms that tip selection takes.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import DagFLConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import bank as bank_lib
from repro_torch.core import dag as dag_lib
from repro_torch.core import validation as val_lib


class IterationOut(NamedTuple):
    dag: dag_lib.DagState
    bank: bank_lib.Bank
    new_accuracy: torch.Tensor      # accuracy of the freshly published model
    chosen_rows: torch.Tensor       # (k,) dag rows approved
    num_tips_seen: torch.Tensor


class Prepared(NamedTuple):
    """Stages 1-3 output, awaiting stage-4 publication at completion time.

    Decoupling select(t0) from publish(t1 = t0 + h) is what lets tips
    accumulate to the paper's L0 = k*lambda*h/(k-1) equilibrium — iterations
    in flight select overlapping tip sets (Fig. 4's t1/t2 timeline).
    """

    new_params: Any
    chosen_rows: torch.Tensor
    new_accuracy: torch.Tensor
    num_tips_seen: torch.Tensor


def make_dagfl_stages(
    cfg: DagFLConfig,
    eval_fn: Callable[[Any, Any], torch.Tensor],
    train_fn: Callable[[Any, Any], Any],
    weighted: bool = False,
):
    """Split Algorithm 2 into prepare (stages 1-3, at iteration START) and
    commit (stage 4, at COMPLETION). Returns (prepare_fn, commit_fn)."""
    validator = val_lib.make_validator(eval_fn)

    def prepare(dag, bank, now, uniform, train_batch, val_batch, node_bias=None) -> Prepared:
        """``now`` is an f32 tensor; ``uniform`` the (cap,) tip-selection draw."""
        rows, nvalid = dag_lib.select_tips(
            dag, uniform, cfg.alpha, now, cfg.tau_max, node_bias=node_bias
        )
        slots = torch.where(rows >= 0, dag.model_slot[rows.clamp(min=0).long()], -1)
        auth_ok = val_lib.authenticate(dag.auth_tag, bank, slots)
        accs = torch.where(auth_ok, validator(bank, slots, val_batch), -torch.inf)
        chosen_slots, top_pos, top_acc = val_lib.select_top_k(accs, slots, cfg.k)
        chosen_rows = torch.where(
            torch.isfinite(top_acc), rows[top_pos], dag_lib.NO_TX
        ).to(torch.int32)
        n_chosen = torch.sum(chosen_slots >= 0)

        if weighted:
            stale = now - dag.publish_time[chosen_rows.clamp(min=0).long()]
            weights = agg.staleness_accuracy_weights(
                torch.where(torch.isfinite(top_acc), top_acc, 0.0), stale, cfg.tau_max
            )
        else:
            weights = agg.uniform_weights(cfg.k, device=slots.device)
        aggregated = bank_lib.bank_average(bank, chosen_slots, weights)
        # no usable tips -> continue from the most recent model (genesis early on)
        last = dag_lib.as_index(
            torch.remainder(dag.count - 1, dag_lib.capacity_of(dag)), slots.device)
        fallback = bank_lib.bank_read(bank, dag.model_slot[last].clamp(min=0))
        new_params = {
            name: torch.where(n_chosen > 0, aggregated[name], fallback[name])
            for name in aggregated
        }
        for _ in range(cfg.beta):
            new_params, _ = train_fn(new_params, train_batch)
        new_acc = eval_fn(new_params, val_batch).float()
        return Prepared(new_params, chosen_rows, new_acc, nvalid)

    return prepare, commit_prepared


def commit_prepared(dag, bank, node_id, t_publish, prepared: Prepared,
                    slot=None, new_count=None):
    """Stage-4 publication of a ``Prepared`` iteration — the commit body of
    every runtime. The bank row is written in place.

    Default (``slot=None``): append at the ledger-local row
    ``count % capacity``. Gossip replicas pass a slot and count watermark
    from the global publish sequence (``repro_torch.net.replica.global_row``),
    so a transaction lands in the same slot on every replica.
    """
    if slot is None:
        slot = torch.remainder(dag.count, dag_lib.capacity_of(dag))
        new_count = dag.count + 1
    elif new_count is None:
        raise ValueError("commit_prepared: slot and new_count go together "
                         "(see repro_torch.net.replica.global_row)")
    tag = bank_lib.auth_checksum(prepared.new_params)
    bank = bank_lib.bank_write(bank, slot, prepared.new_params)
    dag = dag_lib.publish_at(
        dag, slot, new_count, node_id, t_publish,
        prepared.chosen_rows, prepared.new_accuracy, tag, slot,
    )
    return dag, bank


def make_dagfl_iteration(
    cfg: DagFLConfig,
    eval_fn: Callable[[Any, Any], torch.Tensor],
    train_fn: Callable[[Any, Any], Any],
    weighted: bool = False,
):
    """Returns iteration(dag, bank, node_id, now, uniform, train_batch,
    val_batch): all four stages at one time ``now``."""
    prepare, commit = make_dagfl_stages(cfg, eval_fn, train_fn, weighted)

    def iteration(dag, bank, node_id, now, uniform, train_batch, val_batch,
                  node_bias=None) -> IterationOut:
        p = prepare(dag, bank, now, uniform, train_batch, val_batch, node_bias)
        dag, bank = commit(dag, bank, node_id, now, p)
        return IterationOut(dag, bank, p.new_accuracy, p.chosen_rows, p.num_tips_seen)

    return iteration
