"""Metric accumulators for the gossip overlay (port of ``repro.obs.metrics``).

``MetricsState`` accumulates per-round counters and samples one row of a
fixed-capacity series after every merge round or event batch. Everything is
a pure read of the simulation state (no draws, no writes to replicas, bank
or queue), which is what makes the obs-on trajectory bitwise the obs-off
one.

Accumulators (exact, never dropped):

  ``rounds``       merge rounds / event batches observed;
  ``rows_merged``  (N,) rows of each node's replica a round changed;
  ``link_bytes``   (N, N) cumulative payload bytes per directed link (the
                   bank's ``sent``; zero without bank gossip).

Series (capacity S, one row per round; past S a sample is counted in
``dropped`` and not written — the first S samples are kept, never wrapped):

  ``t``               sample instant: ``(tick + 1) * sync_period`` in f32
                      on the tick engine, the batch instant on the events
                      engine (a ``converge()`` flush reuses the tick
                      arithmetic: all zeros on an ideal wire);
  ``tips``            tip count of the union view (Eq. 4's observable);
  ``staleness``       worst per-replica row lag behind the union;
  ``rows_delta``      rows merged this round, over all nodes;
  ``chunk_lag``       worst referenced-but-unavailable chunk count (0
                      without bank gossip);
  ``bytes_total``     cumulative payload bytes;
  ``staleness_node``  (S, N) per-node lag behind the union;
  ``staleness_link``  (S, N, N) rows receiver i lacks of sender j's view;
  ``rejected``        cumulative digest rejections (fault runs with the
                      bank; zeros otherwise);
  ``quarantined``     directed links quarantined (the same);
  ``requests_served`` (S, N) cumulative requests served per node and
  ``serve_staleness`` (S,) the largest gated staleness a batch admitted at
                      the sample's instant saw (serving runs,
                      ``repro_torch.net.serve``; zeros and the -1 sentinel
                      otherwise, and -1 at an instant that admitted none).

The counters ``rounds``, ``cursor`` and ``dropped`` are host integers:
every round is driven from the host, so the sample slot is known there and
writing a series row needs no read back. The series and accumulators live
on the device and are written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core import dag as dag_lib
from repro_torch.core.dag import DagState
from repro_torch.net import bank as bank_lib
from repro_torch.net import replica as replica_lib
from repro_torch.obs.hist import HistConfig

SERIES = ("t", "tips", "staleness", "rows_delta", "chunk_lag", "bytes_total", "staleness_node",
          "staleness_link", "rejected", "quarantined", "requests_served", "serve_staleness")


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs.

    ``series_capacity`` — metric samples kept (one per round or batch);
    ``trace_capacity`` — trace records kept (``repro_torch.obs.trace``);
    ``trace`` — record the PUBLISH/COMMIT/DELIVER/DRAIN/PARTITION trace;
    ``annotate`` — wrap each overlay entry point in
    ``torch.profiler.record_function`` so device profiles name its phases;
    ``tau_max`` — the staleness threshold of the sampled tip count;
    ``hist`` — stream every latency sample into the histograms of
    ``repro_torch.obs.hist`` (``MetricsState.hist``); ``device_spans`` —
    record the FL loop's PUBLISH/COMMIT spans through the device ring
    (``GossipNetwork.trace_device``) instead of the host list.
    """

    series_capacity: int = 2048
    trace_capacity: int = 16384
    trace: bool = True
    annotate: bool = True
    tau_max: float = 20.0
    hist: Optional[HistConfig] = None
    device_spans: bool = False


@dataclass
class MetricsState:
    """The accumulators: host counters, device tensors (shapes per (N, S))."""

    rounds: int                    # rounds / event batches observed
    cursor: int                    # samples attempted (monotone)
    dropped: int                   # samples past capacity (not written)
    rows_merged: torch.Tensor      # (N,) i32 cumulative rows changed per node
    link_bytes: torch.Tensor       # (N, N) f32 cumulative payload bytes per link
    t: torch.Tensor                # (S,) f32 sample instants
    tips: torch.Tensor             # (S,) i32 union tip count
    staleness: torch.Tensor        # (S,) i32 max rows any replica lags the union
    rows_delta: torch.Tensor       # (S,) i32 rows merged this round
    chunk_lag: torch.Tensor        # (S,) i32 max referenced-but-missing chunks
    bytes_total: torch.Tensor      # (S,) f32 cumulative payload bytes
    staleness_node: torch.Tensor   # (S, N) i32 per-node lag behind the union
    staleness_link: torch.Tensor   # (S, N, N) i32 rows receiver i lacks of j
    rejected: torch.Tensor         # (S,) i32 cumulative digest rejections
    quarantined: torch.Tensor      # (S,) i32 quarantined directed links
    requests_served: torch.Tensor  # (S, N) i32 cumulative inference requests
    serve_staleness: torch.Tensor  # (S,) i32 gated staleness at admit (-1: none)
    hist: Any = None               # HistState when ObsConfig.hist is set


def init_metrics(num_nodes: int, cfg: ObsConfig, device="cpu") -> MetricsState:
    s, n = int(cfg.series_capacity), int(num_nodes)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MetricsState(
        rounds=0, cursor=0, dropped=0,
        rows_merged=zeros(n), link_bytes=zeros(n, n, dtype=torch.float32),
        t=zeros(s, dtype=torch.float32), tips=zeros(s), staleness=zeros(s),
        rows_delta=zeros(s), chunk_lag=zeros(s), bytes_total=zeros(s, dtype=torch.float32),
        staleness_node=zeros(s, n), staleness_link=zeros(s, n, n), rejected=zeros(s),
        quarantined=zeros(s), requests_served=zeros(s, n),
        serve_staleness=torch.full((s,), -1, dtype=torch.int32, device=device),
    )


def rows_changed(new: DagState, old: DagState) -> torch.Tensor:
    """(N,) i32 — rows of each stacked replica a round changed: its identity
    (publisher, publish_time) or its approval credit moved."""
    ch = ((new.publisher != old.publisher) | (new.publish_time != old.publish_time)
          | (new.approval_count != old.approval_count))
    return ch.sum(dim=-1, dtype=torch.int32)


def update(
    m: MetricsState,
    cfg: ObsConfig,
    t: torch.Tensor,                       # () f32 sample instant
    dags: DagState,                        # post-round stacked replicas
    rows_delta: torch.Tensor,              # (N,) i32 from rows_changed
    bstate: Optional[bank_lib.BankState] = None,
    digest: Optional[torch.Tensor] = None,
    rejects: Optional[torch.Tensor] = None,  # (N, N) i32 cumulative rejections
    quarantine_after: int = 0,
    serve_counts: Optional[torch.Tensor] = None,  # (N,) i32 cumulative requests served
    serve_stale: Optional[torch.Tensor] = None,   # () i32 gated staleness at admit
) -> MetricsState:
    """Accumulate one round and sample one series row, in place; returns ``m``.

    ``rejects`` is the fault layer's cumulative rejection matrix (faulted
    bank runs only); without it the rejected and quarantined samples stay
    zero. ``serve_counts`` and ``serve_stale`` are the serving layer's
    cumulative served counters and the largest staleness a batch admitted at
    this instant saw; without them the serving samples keep their initial
    values (zeros, and -1 for serve_staleness), as the reference writes.
    """
    m.rounds += 1
    m.rows_merged += rows_delta
    if bstate is not None:
        m.link_bytes = bstate.sent
    slot = m.cursor
    m.cursor += 1
    if slot >= m.t.shape[0]:          # past capacity: count, never wrap
        m.dropped += 1
        return m
    union = replica_lib.merge_all(dags)
    stale_node = replica_lib.missing_vs_union(dags, union)
    m.t[slot] = t
    m.tips[slot] = dag_lib.num_tips(union, t, cfg.tau_max)
    m.staleness[slot] = stale_node.max()
    m.rows_delta[slot] = rows_delta.sum(dtype=torch.int32)
    m.staleness_node[slot] = stale_node
    m.staleness_link[slot] = replica_lib.missing_vs_peer(dags)
    if bstate is not None:
        m.chunk_lag[slot] = bank_lib.missing_chunks(dags, bstate, digest).max()
        m.bytes_total[slot] = bstate.sent.sum()
    if rejects is not None:
        m.rejected[slot] = rejects.sum(dtype=torch.int32)
        m.quarantined[slot] = (rejects >= quarantine_after).sum(dtype=torch.int32)
    if serve_counts is not None:
        m.requests_served[slot] = serve_counts
    if serve_stale is not None:
        m.serve_staleness[slot] = serve_stale
    return m
