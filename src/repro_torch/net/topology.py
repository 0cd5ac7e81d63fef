"""Overlay topologies: neighbor masks plus per-link latency / drop / bandwidth.

Every constructor below returns a ``Topology`` of dense host-side numpy arrays
(``repro_torch.net.gossip.GossipNetwork`` moves them to its device once):

  adjacency  (N, N) bool   symmetric, zero diagonal
  latency    (N, N) f32    seconds per link; +inf off-link
  drop       (N, N) f32    per-message loss probability; 0 off-link
  bandwidth  (N, N) f32    bits/s per link (Table-I B); +inf = ideal wire,
                           0 off-link

Latency, drop, and bandwidth are drawn per *link* (symmetric), so a slow or
lossy edge is slow in both directions — message loss itself is still
sampled per directed message (see ``gossip._sample_edges``).

A numpy-only copy of the reference's ``repro.net.topology``: the same
arrays on the same seeds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Table-I prices one model transfer at phi / B with B = 100 Mbit/s; the
# sweep classes below bracket that wireless budget downward (the paper's
# motivating "wireless and resource-limited" devices). Values are bits/s,
# keyed the way benchmarks/examples report them.
TABLE1_LINK_CLASSES = {
    "ideal": float("inf"),          # payloads travel free
    "table1_100mbps": 100e6,        # Table I's B — campus WiFi / wired edge
    "lte_10mbps": 10e6,             # one order down — loaded LTE uplink
    "constrained_1mbps": 1e6,       # IoT-class uplink
}


class Topology(NamedTuple):
    adjacency: np.ndarray       # (N, N) bool
    latency: np.ndarray         # (N, N) f32, +inf where no link
    drop: np.ndarray            # (N, N) f32, 0 where no link
    bandwidth: np.ndarray       # (N, N) f32 bits/s, +inf = ideal, 0 off-link

    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]

    def degree(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)


def _finalize(
    adj: np.ndarray,
    link_latency: float,
    latency_jitter: float,
    drop: float,
    seed: int,
    bandwidth: float = float("inf"),
) -> Topology:
    n = adj.shape[0]
    adj = np.asarray(adj, bool).copy()
    np.fill_diagonal(adj, False)
    adj |= adj.T                                    # undirected overlay
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.0, latency_jitter, (n, n)) if latency_jitter else np.zeros((n, n))
    jitter = np.triu(jitter, 1)
    jitter = jitter + jitter.T                      # symmetric per-link draw
    latency = np.where(adj, link_latency + jitter, np.inf).astype(np.float32)
    drop_m = np.where(adj, float(drop), 0.0).astype(np.float32)
    bw = np.where(adj, float(bandwidth), 0.0).astype(np.float32)
    return Topology(adjacency=adj, latency=latency, drop=drop_m, bandwidth=bw)


def ring(n: int, link_latency: float = 0.0, latency_jitter: float = 0.0,
         drop: float = 0.0, seed: int = 0,
         bandwidth: float = float("inf")) -> Topology:
    """Cycle graph: node i ↔ i±1 (mod n). Diameter ⌊n/2⌋ — worst-case
    propagation, the stress topology for staleness experiments."""
    adj = np.zeros((n, n), bool)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    return _finalize(adj, link_latency, latency_jitter, drop, seed, bandwidth=bandwidth)


def k_regular(n: int, k: int, link_latency: float = 0.0,
              latency_jitter: float = 0.0, drop: float = 0.0,
              seed: int = 0, bandwidth: float = float("inf")) -> Topology:
    """Circulant k-regular graph: offsets ±1..±k//2, plus the antipode when
    k is odd (requires even n, the standard feasibility condition)."""
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    if (n * k) % 2 != 0:
        raise ValueError(f"no {k}-regular graph on {n} nodes (n*k must be even)")
    adj = np.zeros((n, n), bool)
    idx = np.arange(n)
    for off in range(1, k // 2 + 1):
        adj[idx, (idx + off) % n] = True
        adj[idx, (idx - off) % n] = True
    if k % 2 == 1:
        adj[idx, (idx + n // 2) % n] = True
    return _finalize(adj, link_latency, latency_jitter, drop, seed, bandwidth=bandwidth)


def erdos_renyi(n: int, p: float, link_latency: float = 0.0,
                latency_jitter: float = 0.0, drop: float = 0.0,
                seed: int = 0, bandwidth: float = float("inf")) -> Topology:
    """G(n, p) random overlay. May be disconnected — that is a feature
    (natural partitions); check with ``is_connected`` / ``components``."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.uniform(size=(n, n)) < p, 1)
    return _finalize(upper, link_latency, latency_jitter, drop, seed + 1, bandwidth=bandwidth)


def star(n: int, hub: int = 0, link_latency: float = 0.0,
         latency_jitter: float = 0.0, drop: float = 0.0,
         seed: int = 0, bandwidth: float = float("inf")) -> Topology:
    """Hub-and-spoke: every node ↔ ``hub``. Diameter 2, but the hub is a
    single point of failure — partitioning it isolates every spoke."""
    adj = np.zeros((n, n), bool)
    adj[hub, :] = True
    return _finalize(adj, link_latency, latency_jitter, drop, seed, bandwidth=bandwidth)


def full(n: int, link_latency: float = 0.0, latency_jitter: float = 0.0,
         drop: float = 0.0, seed: int = 0,
         bandwidth: float = float("inf")) -> Topology:
    """Complete graph — the shared-ledger limit of the overlay."""
    return _finalize(np.ones((n, n), bool), link_latency, latency_jitter, drop, seed, bandwidth=bandwidth)


def neighbor_table(adjacency: np.ndarray):
    """Static per-receiver candidate lists from an overlay adjacency.

    Returns ``(nbr_idx (N, D) int32, nbr_valid (N, D) bool)`` where D is the
    max degree + 1: each row lists the receiver itself plus its neighbors,
    padded (``nbr_valid`` false). Every sampled per-tick edge mask is a
    subset of the adjacency, so the table is computed ONCE host-side and the
    neighbour-list round (``impl="lax"``,
    ``repro_torch.kernels.gossip_merge.gossip_winner_nbr``) reduces over D
    candidates instead of all N senders — O(N * D * cap) work.
    """
    adj = np.asarray(adjacency, bool)
    n = adj.shape[0]
    m = adj | np.eye(n, dtype=bool)
    deg = int(m.sum(axis=1).max())
    order = np.argsort(~m, axis=1, kind="stable")[:, :deg].astype(np.int32)
    valid = np.take_along_axis(m, order, axis=1)
    return order, valid


# ---------------------------------------------------------------------------
# Connectivity / partition helpers
# ---------------------------------------------------------------------------


def components(adjacency: np.ndarray) -> np.ndarray:
    """(N,) int component label per node (BFS over the boolean mask)."""
    n = adjacency.shape[0]
    labels = np.full(n, -1, np.int64)
    current = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        frontier = np.zeros(n, bool)
        frontier[start] = True
        member = frontier.copy()
        while frontier.any():
            frontier = (adjacency[frontier].any(axis=0)) & ~member
            member |= frontier
        labels[member] = current
        current += 1
    return labels


def is_connected(adjacency: np.ndarray) -> bool:
    return int(components(adjacency).max()) == 0


def partition_matrix(assignment: np.ndarray) -> np.ndarray:
    """(N, N) bool mask keeping only intra-component edges."""
    a = np.asarray(assignment)
    return a[:, None] == a[None, :]


def split_halves(n: int) -> np.ndarray:
    """Assignment splitting nodes [0, n//2) from [n//2, n) — the canonical
    two-component partition scenario."""
    return (np.arange(n) >= n // 2).astype(np.int64)


def split_random(n: int, num_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_parts, n)


def path_latency_bound(top: Topology, sync_period: float) -> float:
    """Worst-case anti-entropy propagation time over the overlay.

    Each hop costs one sync tick, and a link with latency ℓ only fires every
    ``ceil(ℓ / sync_period)`` ticks (gossip's latency stride), so the
    effective per-edge delay is ``sync_period * max(1, ceil(ℓ / period))``.
    Floyd–Warshall over those weights; the max finite shortest path is the
    weighted diameter — an upper bound on how stale any replica can be in a
    healed, loss-free overlay.
    """
    period = max(sync_period, 1e-9)
    n = top.num_nodes
    w = np.where(
        top.adjacency,
        period * np.maximum(1.0, np.ceil(top.latency / period)),
        np.inf,
    ).astype(np.float64)
    np.fill_diagonal(w, 0.0)
    for k in range(n):
        w = np.minimum(w, w[:, k:k + 1] + w[k:k + 1, :])
    finite = w[np.isfinite(w)]
    return float(finite.max()) if finite.size else float("inf")
