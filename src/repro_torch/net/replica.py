"""Per-node DAG replicas stacked into one ``DagState``.

``ReplicaSet`` holds R = num_nodes copies of the ledger as a single
``DagState`` whose every leaf grew a leading replica axis — one set of
tensors on the device, not R Python objects — so an anti-entropy round is
one masked reduction over the sender axis (``repro_torch.net.gossip``,
``repro_torch.kernels.gossip_merge``) instead of a loop of merges.

The model bank's payload is stored once: rows are allocated from a global
publish sequence (``publish_local``), so a transaction occupies the same
slot on every replica and its bytes live once in the bank. What gossip
propagates is row visibility.

Memory discipline: ``read_replica`` returns VIEWS into the stacked leaves
and ``write_replica`` copies a replica's rows in place (the reference
donates the stacked buffers to the update instead). A view read before a
write therefore sees that write; anything meant to outlive a later write is
cloned (``snapshot``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import dag as dag_lib
from repro_torch.core.dag import DagState
from repro_torch.kernels import gossip_merge as gossip_kernel


class ReplicaSet(NamedTuple):
    dags: DagState      # every leaf has leading axis (R, ...)
    bank: Any           # shared model bank (repro_torch.core.bank.Bank)
    bank_state: Any = None   # per-node chunk transport (repro_torch.net.bank.BankState)

    @property
    def num_replicas(self) -> int:
        return int(self.dags.publisher.shape[0])


def init_replicas(dag: DagState, bank: Any, num_replicas: int, mesh=None) -> ReplicaSet:
    """Every node starts from the same view (the genesis ledger)."""
    if mesh is not None:
        raise NotImplementedError("a mesh-sharded replica set is not ported yet (ROADMAP A.12)")
    return ReplicaSet(dags=stack(dag, num_replicas), bank=bank)


def stack(dag: DagState, num_replicas: int) -> DagState:
    """``num_replicas`` independent copies of ``dag`` along a new leading axis."""
    return DagState(*(x.unsqueeze(0).repeat((num_replicas,) + (1,) * x.dim()) for x in dag))


def snapshot(state):
    """A copy of every leaf of a ``DagState`` (or a ``BankState``): what a
    later in-place write cannot change."""
    return type(state)(*(x.clone() for x in state))


def read_replica(rs: ReplicaSet, i) -> DagState:
    """Replica ``i`` as views into the stack (see the module's note)."""
    return DagState(*(x[i] for x in rs.dags))


def write_replica(rs: ReplicaSet, i, dag: DagState) -> ReplicaSet:
    """Write replica ``i``'s rows, in place: each stacked leaf's row ``i`` is
    overwritten, the whole (R, cap, ...) stack is never copied. Returns
    ``rs`` itself; views from ``read_replica`` see the new rows."""
    for x, v in zip(rs.dags, dag):
        x[i].copy_(v)
    return rs


def global_row(dag: DagState, seq):
    """(row, count watermark) for a globally-sequenced publish — THE row
    addressing rule replicas must share for ``dag.merge`` to reconcile by
    identity. The global sequence (not the replica-local ``count``) keeps
    the same transaction at the same slot on every replica; ``count`` is a
    watermark, the highest sequence this replica has published past."""
    if not isinstance(seq, torch.Tensor):
        # a fill on the device, not a copy of a host scalar (which waits for the stream)
        seq = torch.full((), int(seq), dtype=torch.int32, device=dag.count.device)
    row = torch.remainder(seq, dag_lib.capacity_of(dag))
    return row, torch.maximum(dag.count, seq + 1)


def publish_local(dag: DagState, seq, publisher, time, approvals, accuracy, auth_tag,
                  model_slot) -> DagState:
    """Publish into a replica at the globally-allocated row (``global_row``)."""
    row, new_count = global_row(dag, seq)
    return dag_lib.publish_at(dag, row, new_count, publisher, time, approvals, accuracy,
                              auth_tag, model_slot)


# ---------------------------------------------------------------------------
# Union view + divergence metrics
# ---------------------------------------------------------------------------


def merge_all(dags: DagState) -> DagState:
    """Fold ``dag.merge`` across the replica axis — the union ledger.

    The same winner reduction the anti-entropy round uses, with one
    receiver hearing every replica (the Rr = 1 case of ``gossip_winner``,
    so on a card it launches the kernel), then ``merge_select``. Bitwise the
    sequential fold: the reduction's replica-0 tie preference is the fold's
    first-element preference.
    """
    r = dags.publisher.shape[0]
    mask = torch.ones((1, r), dtype=torch.bool, device=dags.publisher.device)
    src, _ = gossip_kernel.gossip_winner(dags.publish_time, dags.publisher,
                                         dags.approval_count, mask)
    merged = dag_lib.merge_select(dags, src, mask=mask)
    return DagState(*(x[0] for x in merged))


class UnionKeys(NamedTuple):
    """The union ledger's row identities: what ``missing_vs_union`` reads."""

    publisher: torch.Tensor       # (cap,) i32
    publish_time: torch.Tensor    # (cap,) f32


def union_keys(dags: DagState) -> UnionKeys:
    """``merge_all``'s identity columns without the rest of the merge: one
    winner reduction, then the winning replica's publisher and time per row
    (the payload gather ``merge_select`` makes for them)."""
    r = dags.publisher.shape[0]
    mask = torch.ones((1, r), dtype=torch.bool, device=dags.publisher.device)
    src, _ = gossip_kernel.gossip_winner(dags.publish_time, dags.publisher,
                                         dags.approval_count, mask)
    idx = src.long()
    return UnionKeys(torch.gather(dags.publisher, 0, idx)[0],
                     torch.gather(dags.publish_time, 0, idx)[0])


def missing_vs_union(dags: DagState, union=None) -> torch.Tensor:
    """(R,) rows each replica has not yet seen relative to the union view
    (a ``DagState`` or its ``UnionKeys``) — 0 everywhere iff row visibility
    has converged."""
    if union is None:
        union = merge_all(dags)
    have = (dags.publisher == union.publisher[None]) & (
        dags.publish_time == union.publish_time[None])
    have = have | (union.publisher[None] < 0)
    return (~have).sum(dim=-1, dtype=torch.int32)


def missing_vs_peer(dags: DagState) -> torch.Tensor:
    """(R, R) rows receiver i has not yet seen of what sender j holds: the
    occupied rows of replica j whose (publisher, publish_time) identity
    replica i does not hold at the same global slot."""
    p, t = dags.publisher, dags.publish_time
    have = (p[:, None, :] == p[None, :, :]) & (t[:, None, :] == t[None, :, :])
    have = have | (p[None, :, :] < 0)
    return (~have).sum(dim=-1, dtype=torch.int32)


def replicas_synced(dags: DagState) -> torch.Tensor:
    """() bool tensor — every replica leaf-identical to replica 0."""
    return torch.stack([(x == x[0:1]).all() for x in dags]).all()
