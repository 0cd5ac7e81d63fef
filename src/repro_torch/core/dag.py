"""The DAG ledger: fixed-capacity struct-of-arrays on the device.

Transactions are rows of parallel tensors; approvals are index edges that
always point to OLDER rows (acyclicity by construction). Capacity is a ring:
slots older than ``tau_max`` can never be tips again (§IV.B), so evicting
the oldest row is safe; per-node contribution statistics are cumulative
counters (updated the moment a transaction crosses the ``m`` approvals
threshold) so Table-IV metrics survive eviction.

Updates are functional, as in the reference: ``publish_at`` returns a new
``DagState`` and leaves its input as it was (the ledger is a few hundred
KB, so the copies cost nothing next to a model). Scalars that index the
ledger stay on the device as 1-element tensors, so no update waits for the
device.

The model payload of each transaction lives in the model bank
(``repro_torch.core.bank``); rows store only the bank slot.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NO_TX = -1


class DagState(NamedTuple):
    publisher: torch.Tensor         # (cap,) int32  node id, -1 = empty
    publish_time: torch.Tensor      # (cap,) f32
    approvals: torch.Tensor         # (cap, k) int32 indices approved by row
    approvers: torch.Tensor         # (cap, N) bool  node n approved row r
    approval_count: torch.Tensor    # (cap,) int32  distinct approver nodes
    accuracy: torch.Tensor          # (cap,) f32    validation accuracy at publish
    auth_tag: torch.Tensor          # (cap,) f32    integrity checksum of payload
    model_slot: torch.Tensor        # (cap,) int32  index into the model bank
    count: torch.Tensor             # () int32      total ever published
    # cumulative per-node stats (Table IV), for isolation thresholds m=0,1
    published_per_node: torch.Tensor    # (N,) int32
    contributing_m0: torch.Tensor       # (N,) int32  rows that got > 0 approvals
    contributing_m1: torch.Tensor       # (N,) int32  rows that got > 1 approvals


def empty_dag(capacity: int, k: int, num_nodes: int, device="cpu") -> DagState:
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return DagState(
        publisher=torch.full((capacity,), NO_TX, **i32),
        publish_time=torch.zeros((capacity,), **f32),
        approvals=torch.full((capacity, k), NO_TX, **i32),
        approvers=torch.zeros((capacity, num_nodes), dtype=torch.bool, device=device),
        approval_count=torch.zeros((capacity,), **i32),
        accuracy=torch.zeros((capacity,), **f32),
        auth_tag=torch.zeros((capacity,), **f32),
        model_slot=torch.full((capacity,), NO_TX, **i32),
        count=torch.zeros((), **i32),
        published_per_node=torch.zeros((num_nodes,), **i32),
        contributing_m0=torch.zeros((num_nodes,), **i32),
        contributing_m1=torch.zeros((num_nodes,), **i32),
    )


def capacity_of(dag: DagState) -> int:
    return dag.publisher.shape[0]


def as_index(x, device) -> torch.Tensor:
    """A scalar as a 1-element long index; a 0-d integer tensor used as an
    index is read back to the host, which would stall the device queue."""
    return torch.as_tensor(x, device=device).reshape(1).long()


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the lower
    index.

    ``torch.topk`` orders tied values arbitrarily; validation accuracies are
    multiples of 1/val_size, so ties are the normal case.
    """
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def publish_at(
    dag: DagState,
    row,                         # () int32 slot to write
    new_count,                   # () int32 ledger watermark after the write
    publisher,                   # () int32
    time,                        # () f32
    approvals: torch.Tensor,     # (k,) int32, NO_TX padded
    accuracy,                    # () f32
    auth_tag,                    # () f32
    model_slot,                  # () int32
) -> DagState:
    """Write a transaction into an explicit row and credit its approvals.

    Each approved row gets this publisher in its approver set;
    ``approval_count`` is the set's popcount, so re-approving a row the node
    already credited cannot inflate it. Threshold crossings gate on newly set
    bits.
    """
    dev = dag.publisher.device
    r = as_index(row, dev)
    pub = as_index(publisher, dev)
    appr = dag.approvers.clone()
    c0 = dag.contributing_m0.clone()
    c1 = dag.contributing_m1.clone()
    approvals = torch.as_tensor(approvals, device=dev)
    for j in range(approvals.shape[0]):           # the reference's scan, in order
        tx = approvals[j:j + 1]
        ok = tx >= 0
        idx = tx.clamp(min=0).long()
        old = appr[idx].sum(dim=1)
        cur = appr[idx, pub]
        newly = ok & ~cur
        appr[idx, pub] = cur | ok
        owner = dag.publisher[idx]
        crossed0 = newly & (old == 0) & (owner >= 0)
        crossed1 = newly & (old == 1) & (owner >= 0)
        safe_owner = owner.clamp(min=0).long()
        c0.index_add_(0, safe_owner, crossed0.to(c0.dtype))
        c1.index_add_(0, safe_owner, crossed1.to(c1.dtype))
    appr[r] = False                  # ring reuse: a fresh row is unapproved

    def put(column, value):
        out = column.clone()
        out[r] = torch.as_tensor(value, device=dev).reshape((1,) + column.shape[1:]).to(column.dtype)
        return out

    return DagState(
        publisher=put(dag.publisher, publisher),
        publish_time=put(dag.publish_time, time),
        approvals=put(dag.approvals, approvals),
        approvers=appr,
        approval_count=appr.sum(dim=1, dtype=torch.int32),
        accuracy=put(dag.accuracy, accuracy),
        auth_tag=put(dag.auth_tag, auth_tag),
        model_slot=put(dag.model_slot, model_slot),
        count=torch.as_tensor(new_count, device=dev).reshape(()).to(torch.int32),
        published_per_node=dag.published_per_node.clone().index_add_(
            0, pub, torch.ones(1, dtype=torch.int32, device=dev)),
        contributing_m0=c0,
        contributing_m1=c1,
    )


def publish(dag: DagState, publisher, time, approvals, accuracy, auth_tag,
            model_slot) -> DagState:
    """Append a transaction (Algorithm 2 stage 4) and credit approvals."""
    cap = capacity_of(dag)
    return publish_at(
        dag, torch.remainder(dag.count, cap), dag.count + 1,
        publisher, time, approvals, accuracy, auth_tag, model_slot,
    )


def tip_mask(dag: DagState, now: torch.Tensor, tau_max: float) -> torch.Tensor:
    """Tips (§II.B / §IV.B): occupied, unapproved, staleness <= tau_max.

    ``now`` is an f32 tensor: the staleness test runs in f32, as the
    reference's does.
    """
    fresh = (now - dag.publish_time) <= tau_max
    return (dag.publisher >= 0) & (dag.approval_count == 0) & fresh


def select_tips(
    dag: DagState,
    uniform: torch.Tensor,
    alpha: int,
    now: torch.Tensor,
    tau_max: float,
    node_bias=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample up to alpha tips without replacement (stage 1).

    ``uniform`` is the (cap,) f32 draw in [1e-9, 1) that the reference makes
    from its key; the caller makes it (``repro_torch.fl.systems`` routes
    every draw through one function). Gumbel top-k gives an exact uniform
    sample. ``node_bias`` ((num_nodes+1,) log-weights indexed by publisher)
    skews the draw — used by the simulator's backdoor JOINT attack.

    Returns (idx (alpha,) int32 with NO_TX padding, num_valid ()).
    """
    mask = tip_mask(dag, now, tau_max)
    gumbel = -torch.log(-torch.log(uniform))
    if node_bias is not None:
        gumbel = gumbel + node_bias[dag.publisher.clamp(min=0).long()]
    scores = torch.where(mask, gumbel, -torch.inf)
    top_scores, top_idx = top_k(scores, alpha)
    ok = torch.isfinite(top_scores)
    idx = torch.where(ok, top_idx, NO_TX).to(torch.int32)
    return idx, ok.sum(dtype=torch.int32)


def num_tips(dag: DagState, now: torch.Tensor, tau_max: float) -> torch.Tensor:
    return tip_mask(dag, now, tau_max).sum(dtype=torch.int32)


def isolated_mask(dag: DagState, m: int) -> torch.Tensor:
    """Transactions with <= m approvals are isolated (§V.4)."""
    return (dag.publisher >= 0) & (dag.approval_count <= m)


# ---------------------------------------------------------------------------
# Merge: reduction-friendly views shared by the two-replica fold and the
# fused gossip round (repro_torch.kernels.gossip_merge)
# ---------------------------------------------------------------------------


class MergeViews(NamedTuple):
    """One ``DagState`` split by merge role.

    ``keys``        the (publish_time, publisher) row identity the winner
                    rule reduces over;
    ``approvers``   per-row approver-node bitsets, merged as the exact set
                    union (bitwise OR) across candidates holding the winning
                    identity; ``approval_count`` is the union's popcount;
    ``payload``     row-addressed leaves that follow the winning identity
                    wholesale (keys included);
    ``watermarks``  monotone ledger-wide counters merged by element-wise max.

    ``merge``, the union fold (``repro_torch.net.replica.merge_all``) and the
    fused round all consume these views, so a new ``DagState`` field is
    classified here once.
    """

    keys: Tuple[torch.Tensor, torch.Tensor]       # (publish_time, publisher)
    approvers: torch.Tensor                       # (..., cap, N) bool
    payload: Tuple[Tuple[str, torch.Tensor], ...]
    watermarks: Tuple[Tuple[str, torch.Tensor], ...]


def merge_views(dag: DagState) -> MergeViews:
    return MergeViews(
        keys=(dag.publish_time, dag.publisher),
        approvers=dag.approvers,
        payload=(
            ("publisher", dag.publisher),
            ("publish_time", dag.publish_time),
            ("approvals", dag.approvals),
            ("accuracy", dag.accuracy),
            ("auth_tag", dag.auth_tag),
            ("model_slot", dag.model_slot),
        ),
        watermarks=(
            ("count", dag.count),
            ("published_per_node", dag.published_per_node),
            ("contributing_m0", dag.contributing_m0),
            ("contributing_m1", dag.contributing_m1),
        ),
    )


def row_winner(local_keys, remote_keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """(take_remote, same_tx) masks — THE row-merge rule.

    A slot occupied on one side only adopts that side; two different
    transactions resolve to the lexicographically larger
    ``(publish_time, publisher)`` key; the same transaction on both sides is
    ``same_tx`` (approver sets union).
    """
    l_time, l_pub = local_keys
    r_time, r_pub = remote_keys
    l_occ = l_pub >= 0
    r_occ = r_pub >= 0
    same_tx = l_occ & r_occ & (l_time == r_time) & (l_pub == r_pub)
    remote_newer = (r_time > l_time) | ((r_time == l_time) & (r_pub > l_pub))
    take_remote = (r_occ & ~l_occ) | (r_occ & l_occ & ~same_tx & remote_newer)
    return take_remote, same_tx


def merge(local: DagState, remote: DagState) -> DagState:
    """Anti-entropy reconciliation of two replicas of one ledger (§III.A).

    Row-wise by ``row_winner`` over ``merge_views``: payload leaves follow
    the winning identity; the same transaction on both sides keeps the
    UNION of the two approver bitsets and rederives ``approval_count`` as
    its popcount; ``count`` and the per-node counters merge by max.

    Either side may carry leading replica axes (every leaf stacked the same
    way, as in ``repro_torch.net.replica``); they broadcast against each
    other, so one call merges one sender into every receiver at once.
    """
    lv, rv = merge_views(local), merge_views(remote)
    take_remote, same_tx = row_winner(lv.keys, rv.keys)
    remote_payload = dict(rv.payload)
    row_dims = max(local.publisher.dim(), remote.publisher.dim())

    def pick(a, b):
        trailing = max(a.dim(), b.dim()) - row_dims
        sel = take_remote.reshape(take_remote.shape + (1,) * trailing)
        return torch.where(sel, b, a)

    approvers = torch.where(take_remote[..., None], rv.approvers, lv.approvers)
    approvers = torch.where(same_tx[..., None], lv.approvers | rv.approvers, approvers)
    fields = {name: pick(a, remote_payload[name]) for name, a in lv.payload}
    remote_marks = dict(rv.watermarks)
    fields.update({name: torch.maximum(a, remote_marks[name]) for name, a in lv.watermarks})
    return DagState(
        approvers=approvers,
        approval_count=approvers.sum(dim=-1, dtype=torch.int32),
        **fields,
    )


def merge_select(
    dags: DagState,
    src: torch.Tensor,                 # (Rr, cap) i32 winner indices per row
    mask: torch.Tensor = None,         # (Rr, R) bool dense candidate mask
    nbr_idx: torch.Tensor = None,      # (Rr, D) i32 candidate lists (sparse form)
    nbr_act: torch.Tensor = None,      # (Rr, D) bool candidate activity
) -> DagState:
    """Materialize merged replicas from per-row winner indices.

    ``dags`` is a stacked replica set (every leaf has a leading (R, ...)
    axis). Payload leaves gather the winning sender's row
    (``out[i, r] = leaf[src[i, r], r]``); watermark leaves max-reduce over
    the candidate senders, given as a dense (Rr, R) ``mask`` (the kernel's
    form, the receiver included) or as ``(nbr_idx, nbr_act)`` lists (the
    receiver an active entry of its own list). Approver bitsets take the
    exact OR-union over every candidate holding the winning identity, and
    ``approval_count`` is its popcount.

    The union is a contraction over candidates of 0/1 values, computed in
    f32 (``torch.einsum``): the sums are at most R < 2**24, so they are exact
    whatever the matmul precision.
    """
    views = merge_views(dags)
    idx = src.long()

    def gather(x):
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
        return torch.gather(x, 0, i)

    if mask is not None:
        def watermark(w):
            m = mask.reshape(mask.shape + (1,) * (w.dim() - 1))
            return torch.where(m, w[None], 0).amax(dim=1)
    else:
        nbr = nbr_idx.long()

        def watermark(w):
            m = nbr_act.reshape(nbr_act.shape + (1,) * (w.dim() - 1))
            return torch.where(m, w[nbr], 0).amax(dim=1)

    fields = {name: gather(x) for name, x in views.payload}
    fields.update({name: watermark(w) for name, w in views.watermarks})

    # a candidate contributes its bitset for row r iff it is active and
    # holds the winning (publish_time, publisher) identity
    w_time, w_pub = fields["publish_time"], fields["publisher"]
    t_all, p_all = views.keys
    appr = views.approvers.float()
    if mask is not None:
        same = (
            mask[:, :, None]
            & (p_all[None] == w_pub[:, None])
            & (t_all[None] == w_time[:, None])
            & (w_pub[:, None] >= 0)
        )
        union = torch.einsum("ijr,jrn->irn", same.float(), appr) > 0
    else:
        same = (
            nbr_act[:, :, None]
            & (p_all[nbr] == w_pub[:, None])
            & (t_all[nbr] == w_time[:, None])
            & (w_pub[:, None] >= 0)
        )
        union = torch.einsum("ijr,ijrn->irn", same.float(), appr[nbr]) > 0

    return DagState(
        approvers=union,
        approval_count=union.sum(dim=-1, dtype=torch.int32),
        **fields,
    )
