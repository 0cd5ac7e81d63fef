"""Gossiped model bank: content-addressed chunks over a bandwidth budget.

The paper's DAG layer exchanges models, and Table I prices each transfer at
phi / B. This module makes payload transport a priced part of the
anti-entropy round while the payload bytes stay stored once, as in the
reference (``repro.net.bank``):

  store          the model bank stays one store (``repro_torch.core.bank``,
                 slot i is transaction i's model); what is replicated per
                 node is a presence bitmap of the chunks it has received.

  chunking       each slot's P parameters (the model's own size, not the
                 bank's padded row stride) split into ``chunks_per_slot``
                 equal ranges, each tagged with a content digest
                 (``chunk_digests``). Chunking is ALIGNED: dedup compares
                 chunks at the same offset across slots, so a payload
                 identical to one already held costs nothing.

  transfer       every sync tick, after the DAG merge, each node pulls the
                 chunks referenced by rows of its replica that its effective
                 availability (``kernels.chunk_transfer.chunk_dedup``) does
                 not cover, from active neighbours, charged against a
                 per-directed-link byte budget ``bandwidth / 8 *
                 sync_period``. Whole chunks move in canonical order;
                 partial-chunk budget rolls over across ticks (paused while
                 a link is strided out or partitioned away), and idle
                 bandwidth is never banked.

  gating         a transaction is usable at a node only once its model's
                 chunks have arrived (``gate_view``), so tip selection waits
                 for the payload.

With unlimited bandwidth every assigned chunk moves on the tick its row
arrives, and the run is bitwise the bankless one: the transfer step is
deterministic and draws nothing.

A commit overwriting slot s resets every other node's presence bits for s
and re-digests it (``commit_chunks``).

Wire compression (``BankGossipConfig.codec``, ``repro_torch.kernels.
delta_codec``): with a codec the FL driver encodes every commit before it
reaches the store. The store slot holds the decoded wire values, so the
codec's error enters training once, at commit; ``commit_chunks`` digests the
ENCODED wire form (``chunk_digests`` flattens it leaf by leaf), and the
engines price each chunk at ``chunk_bytes * wire_ratio()``. ``codec=None``
and every codec that prices like raw bytes (``delta_codec.codec_key``) keep
the uncompressed path untouched.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core.bank import Bank
from repro_torch.core.dag import DagState
from repro_torch.kernels import chunk_transfer as ck
from repro_torch.kernels.delta_codec import DeltaCodec

_INT32_MAX = torch.iinfo(torch.int32).max
# the largest float32 below 2**31: what clamps safely into int32
_F32_BELOW_2_31 = 2147483520.0


@dataclass(frozen=True)
class BankGossipConfig:
    """Knobs for gossiping the model bank.

    ``chunks_per_slot`` — byte ranges per bank slot (the transfer granule).
    ``slot_bytes`` — payload size per slot for pricing; None measures the
    model (``slot_nbytes``), Table-I realism passes ``7e6`` (phi = 7 MB).
    ``codec`` — wire compression for commits
    (``repro_torch.kernels.delta_codec.DeltaCodec``); None ships raw f32
    chunks.

    The reference's ``impl`` (Pallas or lax dedup) has no counterpart: the
    dedup reduction takes the kernel on a card and its plain version on the
    CPU, by the device of its inputs.
    """

    chunks_per_slot: int = 4
    slot_bytes: Optional[float] = None
    codec: Optional[DeltaCodec] = None


class BankState(NamedTuple):
    """Per-node bank-transport state (leading axis = replica, like ``dags``).

    ``have``   (R, S, C) bool — physical chunk presence per node;
    ``credit`` (R, R) f32 — rolled-over partial-chunk budget per directed
               link (receiver i <- sender j), bytes;
    ``sent``   (R, R) f32 — cumulative bytes delivered per directed link.
    """

    have: torch.Tensor
    credit: torch.Tensor
    sent: torch.Tensor


def _model_size(bank: Bank) -> int:
    return sum(math.prod(shape) for _, shape in bank.shapes)


def slot_nbytes(bank: Bank) -> float:
    """Payload bytes of one bank slot: the model's P parameters, not the
    bank's padded row stride."""
    return float(_model_size(bank) * bank.rows.element_size())


@functools.lru_cache(maxsize=16)
def _projection(per: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(per, dtype=torch.float32, device=device)
    return torch.cos(idx * 0.618033988749895) + 1e-3 * torch.sin(idx * 0.318309886)


def _digest_flat(flat: torch.Tensor, chunks: int) -> torch.Tensor:
    """(chunks,) f32 digests of one flat f32 payload (P,).

    The one routine behind ``chunk_digests`` (of a model or of a codec's
    wire form) and ``bank_digests``: a fresh zero-padded (chunks, per) copy
    times the fixed projection, always in this shape, so equal payloads get
    bitwise-equal digests whichever path digests them (a batched product
    over many slots may reduce in another order).
    """
    n = flat.shape[0]
    per = -(-n // chunks)                       # ceil; zero-pad the tail
    padded = torch.zeros(chunks * per, dtype=torch.float32, device=flat.device)
    padded[:n] = flat
    return padded.view(chunks, per) @ _projection(per, flat.device)


def _leaves_flat(tree) -> torch.Tensor:
    """One f32 vector of a payload's leaves in ``jax.tree_util.tree_leaves``
    order: a model (a dict of leaves) in sorted-name order, and a codec's wire
    form (a dict of such dicts) key by key — int8 codes as their f32 values,
    so the int8 wire form of the paper's CNN is its 1,663,744 codes, then its
    12,998 scales."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            leaves.append(node.reshape(-1).float())

    walk(tree)
    return torch.cat(leaves)


def chunk_digests(params, chunks: int) -> torch.Tensor:
    """(chunks,) f32 content digests of one payload: a model, or the wire
    form of a codec (``DeltaCodec.encode``).

    The payload flattened in the reference's leaf order, split into
    ``chunks`` equal ranges (zero-padded), each tagged with a fixed
    pseudo-random projection: identical content gives identical digests,
    and any bit flip moves one.
    """
    return _digest_flat(_leaves_flat(params), chunks)


def bank_digests(bank: Bank, chunks: int) -> torch.Tensor:
    """(S, chunks) f32 digest table of the whole store, slot by slot."""
    p = _model_size(bank)
    return torch.stack([_digest_flat(row[:p], chunks) for row in bank.rows])


def init_bank_state(num_replicas: int, slots: int, chunks: int, device=None) -> BankState:
    """Genesis transport state: every node holds the initial store, no
    budget in flight, nothing on the meter."""
    return BankState(
        have=torch.ones((num_replicas, slots, chunks), dtype=torch.bool, device=device),
        credit=torch.zeros((num_replicas, num_replicas), dtype=torch.float32, device=device),
        sent=torch.zeros((num_replicas, num_replicas), dtype=torch.float32, device=device),
    )


def commit_chunks(have: torch.Tensor, digest: torch.Tensor, params, slot: int, node_id: int):
    """Account a stage-4 commit overwriting store ``slot`` with ``params``.

    The committer holds the new content; everyone else's presence bits for
    the slot reset; the slot's digest row is re-derived. ``params`` is only
    digested here, so a driver with a codec passes the ENCODED wire form.
    Returns new ``(have, digest)`` and leaves its inputs as they were.
    """
    have, digest = have.clone(), digest.clone()
    have[:, slot, :] = False
    have[node_id, slot, :] = True
    digest[slot] = chunk_digests(params, digest.shape[1])
    return have, digest


# ---------------------------------------------------------------------------
# The per-tick transfer step
# ---------------------------------------------------------------------------


def referenced_slots(dags: DagState, slots: int) -> torch.Tensor:
    """(R, S) bool — store slots referenced by rows visible in each replica."""
    r = dags.publisher.shape[0]
    occ = (dags.publisher >= 0).to(torch.int32)
    ms = dags.model_slot.clamp(min=0).long()
    ref = torch.zeros((r, slots), dtype=torch.int32, device=occ.device)
    return ref.scatter_reduce_(1, ms, occ, reduce="amax") > 0


def _afford(budget: torch.Tensor, chunk_bytes: float) -> torch.Tensor:
    """(.., ..) int32 whole chunks a budget buys, clipped to [0, int32 max]
    with the reference's saturating cast: an infinite budget (the ideal
    wire) gives int32 max, where a plain cast would give int32 min.

    The granule divides as a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, and a budget of exactly m chunks
    could then floor to m - 1."""
    whole = torch.floor(budget / torch.full_like(budget, chunk_bytes)).clamp(min=0.0)
    return torch.where(whole >= 2.0 ** 31, _INT32_MAX,
                       whole.clamp(max=_F32_BELOW_2_31).to(torch.int32))


def chunk_step(
    dags: DagState,              # receiver block's replicas (post-merge)
    bstate: BankState,           # receiver block's transport state
    digest: torch.Tensor,        # (S, C) f32 store digest table
    sat_all: torch.Tensor,       # (R, S, C) bool every sender's availability
    sat_blk: torch.Tensor,       # (Rb, S, C) bool this block's availability
    edges: torch.Tensor,         # (Rb, R) bool active directed edges
    cap_bytes: torch.Tensor,     # (Rb, R) f32 per-link budget this tick
    chunk_bytes: float,          # the transfer granule, bytes (an f32 value)
    return_pending: bool = False,
):
    """One tick of priced chunk movement for a receiver block.

    ``return_pending=True`` also returns the (Rb, R) bool mask of links that
    still had assigned work after the budget ran out.
    """
    rb, s, c = sat_blk.shape
    ref = referenced_slots(dags, s)
    need = (ref[:, :, None] & ~sat_blk).reshape(rb, s * c)
    budget = bstate.credit + torch.where(edges, cap_bytes, 0.0)
    take, spent_chunks, pending = ck.transfer_select(
        need, sat_all.reshape(-1, s * c), edges, _afford(budget, chunk_bytes))
    spent = spent_chunks.float() * chunk_bytes
    # rollover: keep the residual while work is pending; pause (do not reset)
    # on links that did not fire; never bank idle bandwidth on an active link
    credit = torch.where(pending, budget - spent, torch.where(edges, 0.0, bstate.credit))
    out = BankState(have=bstate.have | take.reshape(rb, s, c), credit=credit,
                    sent=bstate.sent + spent)
    if return_pending:
        return out, pending
    return out


# ---------------------------------------------------------------------------
# Availability views (gating + metrics)
# ---------------------------------------------------------------------------


def rows_available(dag: DagState, sat: torch.Tensor) -> torch.Tensor:
    """(..., cap) bool — rows whose model chunks have fully arrived.

    ``dag`` may be one replica with ``sat (S, C)`` or the stacked set with
    ``sat (R, S, C)``; empty rows count as available.
    """
    ms = dag.model_slot.clamp(min=0).long()
    got = torch.take_along_dim(sat, ms[..., None], dim=-2).all(dim=-1)
    return (dag.publisher < 0) | got


def _mask_unavailable(dag: DagState, avail: torch.Tensor) -> DagState:
    return dag._replace(publisher=torch.where(avail, dag.publisher, -1),
                        model_slot=torch.where(avail, dag.model_slot, -1))


def gate_view(dag: DagState, have_row: torch.Tensor, digest: torch.Tensor) -> DagState:
    """A node's usable view: rows whose payload has not arrived are masked to
    empty (publisher and model_slot -1), as if the transaction had not been
    received. With full availability this is the identity (bitwise).

    One ``chunk_dedup`` of the node's presence bitmap (R = 1).
    """
    sat = ck.chunk_dedup(have_row[None], digest)[0]
    return _mask_unavailable(dag, rows_available(dag, sat))


def gate_views(dags: DagState, sat: torch.Tensor) -> DagState:
    """Every node's usable view at once, given the availability ``sat``
    (R, S, C) already reduced."""
    return _mask_unavailable(dags, rows_available(dags, sat))


def missing_chunks(dags: DagState, bstate: BankState, digest: torch.Tensor) -> torch.Tensor:
    """(R,) int32 — referenced-but-unavailable chunks per node (0 = every
    visible transaction's model is locally usable)."""
    sat = ck.chunk_dedup(bstate.have, digest)
    ref = referenced_slots(dags, sat.shape[1])
    return (ref[:, :, None] & ~sat).sum(dim=(1, 2), dtype=torch.int32)
