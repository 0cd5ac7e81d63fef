"""Anti-entropy gossip over the overlay: device-resident, tick-batched sync.

A sync tick folds every node's active neighbours into its local replica with
the ``dag.merge`` row rule. Three interchangeable round implementations,
under the reference's names:

  ``impl="fused"``  the fast path: per-row winner selection over ALL senders
                    in one masked reduction (``repro_torch.kernels.
                    gossip_merge.gossip_winner``: the CUDA kernel on a card,
                    its plain version on the CPU), then one payload gather
                    (``dag.merge_select`` with the dense mask);
  ``impl="scan"``   the sequential fold of two-replica ``dag.merge``s over
                    senders in index order: the bitwise oracle;
  ``impl="lax"``    the neighbour-list form (``gossip_winner_nbr`` over each
                    receiver's candidate list, plain PyTorch).

Per-edge behaviour, as in the reference:

  message loss   each directed message is dropped i.i.d. with the link's
                 drop probability (``Topology.drop``);
  link latency   a link with latency l fires only every
                 ``ceil(l / sync_period)`` ticks;
  partitions     a ``PartitionSchedule`` suppresses cross-component edges
                 for t in [t_start, t_end), then heals.

Edge draws. The reference's n-th executed round draws ``uniform(sub_n,
(N, N))`` with ``key_{n+1}, sub_n = split(key_n)`` and ``key_0 =
PRNGKey(cfg.seed)``; PyTorch cannot reproduce threefry, so every round's
draw goes through one function, ``edge_draw(round_index) -> (N, N) f32`` in
[0, 1), where ``round_index`` counts the rounds that drew (``edge_draws``):
fast-forwarded ticks and the events engine's drain-only batches draw
nothing. The default (``torch_edge_draw``) is a ``torch.Generator`` on the
device seeded with ``cfg.seed``; the tests pass the reference's draws.

Continuous time: with ``GossipConfig(engine="events")`` ``advance`` runs
the ``repro_torch.net.events`` engine instead of the tick loop: per-edge
deliveries at each link's own latency, simultaneous deliveries merged as one
round, and with the bank, chunk drains with continuously accrued budget.
``converge`` is the engine-independent tick loop either way. In the
degenerate limit (every delay equal to a dyadic sync period) the two engines
are bitwise equal.

Bank gossip (``bank_cfg=BankGossipConfig(...)``, ``repro_torch.net.bank``):
every tick also moves model payload availability. Rows merge first, then
the chunk step runs on the post-merge replicas over the same edge mask,
priced per directed link; ``read_view`` gates a node's view on payload
arrival and ``converge`` also waits for every referenced chunk. With
unlimited capacity the whole trajectory is bitwise the bankless one. With
``bank_cfg.codec`` set (``repro_torch.kernels.delta_codec``) every tick
prices a chunk at its encoded size, ``chunk_bytes * wire_ratio()``; the
identity codec keeps the raw granule.

Telemetry (``obs_cfg=repro_torch.obs.ObsConfig(...)``): every executed
round, on either engine and in ``converge``, runs ``obs.observe_round`` on
the pre- and post-round replicas (the round bodies are functional, so the
loop's own pre-round state is the copy it reads); ``obs_report`` drains the
collectors. It reads only: the obs-on trajectory is bitwise the obs-off one.

Fault injection (``faults_cfg=repro_torch.net.faults.FaultConfig(...)``):
per-node adversary roles act inside every round of either engine and in
``converge`` (edge suppression before the merge, approver forgery after it)
and, with the bank gossiped, in the chunk service (spoofed payloads, digest
verification, back-off and quarantine); the fault draws go through
``fault_draw`` as the edge draws go through ``edge_draw``
(``repro_torch.net.faults``). An all-honest config is bitwise the
``faults_cfg=None`` run.

Inference serving (``serve_cfg=repro_torch.net.serve.ServeConfig(...)``,
events engine only): each node receives Poisson requests, batches them into
its slots and serves them from its gated view; the INFER batches run inside
the event loop beside the transport, never draw an edge uniform and read
the replicas only, so the training trajectory is the serve-free one.
``serve_report`` drains the counters; ``serve_draw`` replaces the arrival
draws as ``edge_draw`` does the edge draws. ``serve_cfg=None`` and a rate of
0 build nothing and are bitwise the serve-free run.

Both engines are ported, with or without bank gossip, its codec, telemetry,
fault injection and (events) serving; a mesh is not, and ``GossipNetwork``
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import dag as dag_lib
from repro_torch.core.dag import DagState
from repro_torch.kernels import chunk_transfer as chunk_kernel
from repro_torch.kernels import delta_codec
from repro_torch.kernels import gossip_merge as gossip_kernel
from repro_torch.net import bank as bank_lib
from repro_torch.net import faults as faults_lib
from repro_torch.net import replica as replica_lib
from repro_torch.net import serve as serve_lib
from repro_torch.net.bank import BankGossipConfig, BankState
from repro_torch.net.topology import Topology, neighbor_table, partition_matrix
from repro_torch.obs import hist as hist_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

EdgeDraw = Callable[[int], torch.Tensor]


@dataclass(frozen=True)
class PartitionSchedule:
    """Split the overlay into components for [t_start, t_end), then heal.

    ``assignment`` is an (N,) array of component labels; while active, only
    edges within a component deliver.
    """

    assignment: np.ndarray
    t_start: float
    t_end: float

    def active(self, t: float) -> bool:
        return self.t_start <= t < self.t_end


@dataclass(frozen=True)
class GossipConfig:
    """Anti-entropy knobs.

    ``sync_period <= 0`` means an ideal wire: every ``advance`` runs ticks
    until the replicas reach fixpoint — the shared-ledger limit.
    ``max_ticks_per_advance`` bounds work when one advance window spans many
    periods; the ticks past it are fast-forwarded: no round runs for them
    and no edge draw is made.
    ``impl``: "fused", "scan" or "lax" (see the module docstring).
    ``engine``: "ticks" (the quantised stride model) or "events" (the
    continuous-time engine, ``repro_torch.net.events``). Under "events"
    ``max_ticks_per_advance`` caps each delivery edge's fires per advance
    window (a longer backlog is elided, as the tick engine fast-forwards),
    and ``max_events_per_advance`` bounds one advance's event batches (what
    is left runs in the next advance).
    """

    sync_period: float = 1.0
    seed: int = 0
    max_ticks_per_advance: int = 64
    impl: str = "fused"
    engine: str = "ticks"
    max_events_per_advance: int = 8192


def torch_edge_draw(seed: int, num_nodes: int, device) -> EdgeDraw:
    """(N, N) uniforms in [0, 1) from one ``torch.Generator`` on ``device``,
    consumed in round order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(round_index: int) -> torch.Tensor:
        return torch.rand((num_nodes, num_nodes), generator=gen, device=device)

    return draw


# ---------------------------------------------------------------------------
# Round bodies
# ---------------------------------------------------------------------------


def trees_equal(a: DagState, b: DagState) -> torch.Tensor:
    """() bool tensor — leaf-wise exact equality of two ledgers."""
    return torch.stack([(x == y).all() for x, y in zip(a, b)]).all()


def _sample_edges(uniform, tick: int, part_mask, adj, drop, stride) -> torch.Tensor:
    """(N, N) bool active-edge mask for one tick; ``uniform`` is its draw."""
    live = adj & (torch.remainder(tick, stride) == 0) & part_mask
    return live & (uniform >= drop)


@functools.lru_cache(maxsize=64)
def _neighbor_table_cached(mask_bytes: bytes, r: int):
    m = np.frombuffer(mask_bytes, bool).reshape(r, r)
    return neighbor_table(m)


def _round_scan(dags: DagState, edge_active: torch.Tensor) -> DagState:
    """The sequential fold: every receiver merges sender 0, 1, ... in order,
    keeping the merge only where its edge is active. The receivers go
    together: one ``dag.merge`` per sender, broadcast over the stack."""
    out = dags
    for j in range(dags.publisher.shape[0]):
        merged = dag_lib.merge(out, DagState(*(x[j] for x in dags)))
        act = edge_active[:, j]
        out = DagState(*(
            torch.where(act.reshape(act.shape + (1,) * (m.dim() - 1)), m, c)
            for m, c in zip(merged, out)
        ))
    return out


def _round_fused(dags: DagState, edge_active: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_valid: torch.Tensor, impl: str) -> DagState:
    """One winner reduction + one payload gather per tick.

    "fused" runs the dense reduction over the whole sender axis (the kernel
    on a card); "lax" gathers each receiver's candidate list and reduces
    over the max degree.
    """
    r = dags.publisher.shape[0]
    dev = dags.publisher.device
    if impl == "fused":
        # the receiver is a candidate: merge_select's watermarks read it too
        mask = edge_active | torch.eye(r, dtype=torch.bool, device=dev)
        src, _ = gossip_kernel.gossip_winner(dags.publish_time, dags.publisher,
                                             dags.approval_count, mask)
        return dag_lib.merge_select(dags, src, mask=mask)
    if impl != "lax":
        raise ValueError(f"unknown gossip round impl: {impl!r}")
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    act = torch.gather(edge_active, 1, nbr_idx.long()) | (nbr_idx == rows[:, None])
    act = act & nbr_valid
    src, _ = gossip_kernel.gossip_winner_nbr(dags.publish_time, dags.publisher,
                                             dags.approval_count, nbr_idx, act)
    return dag_lib.merge_select(dags, src, nbr_idx=nbr_idx, nbr_act=act)


def _apply_round(dags: DagState, edge_active: torch.Tensor, nbr_idx, nbr_valid,
                 impl: str) -> DagState:
    if impl == "scan":
        return _round_scan(dags, edge_active)
    return _round_fused(dags, edge_active, nbr_idx, nbr_valid, impl)


def _bank_tick_single(dags: DagState, bstate: BankState, digest: torch.Tensor,
                      edges: torch.Tensor, nbr_idx, nbr_valid, cap_bytes: torch.Tensor,
                      chunk_bytes: float, impl: str):
    """One sync tick with the model bank gossiped.

    Rows merge first (the bankless round), then the chunk step runs on the
    post-merge replicas over the same edge mask: metadata and payload
    travel the same links in the same tick, so with unlimited bandwidth
    availability tracks visibility exactly and the dags trajectory is the
    bankless one. One ``chunk_dedup`` launch per tick.
    """
    dags = _apply_round(dags, edges, nbr_idx, nbr_valid, impl)
    sat = chunk_kernel.chunk_dedup(bstate.have, digest)
    return dags, bank_lib.chunk_step(dags, bstate, digest, sat, sat, edges, cap_bytes,
                                     chunk_bytes)


def make_gossip_round(impl: str = "fused", mesh=None):
    """(dags, edge_active) -> dags anti-entropy round.

    ``edge_active[i, j]``: receiver i hears sender j this tick. The "lax"
    impl derives its candidate table from the concrete mask (cached);
    ``GossipNetwork`` precomputes it from the static adjacency instead.
    """
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded round is not ported yet (ROADMAP A.12)")

    def round_fn(dags: DagState, edge_active: torch.Tensor) -> DagState:
        nbr_idx = nbr_valid = None
        if impl == "lax":
            m = edge_active.cpu().numpy().astype(bool)
            idx, valid = _neighbor_table_cached(m.tobytes(), m.shape[0])
            dev = edge_active.device
            nbr_idx, nbr_valid = torch.from_numpy(idx).to(dev), torch.from_numpy(valid).to(dev)
        return _apply_round(dags, edge_active, nbr_idx, nbr_valid, impl)

    return round_fn


def stride_matrix(top: Topology, sync_period: float, use_strides: bool = True) -> np.ndarray:
    """(N, N) int32 tick stride per link: a link with latency l fires every
    ``ceil(l / sync_period)`` ticks. ``use_strides=False`` (the ideal wire,
    ``sync_period <= 0``) delivers on every tick regardless of latency.
    Clipped to 2**30 so pathological latency/period ratios stay int32-safe."""
    n = top.num_nodes
    if not use_strides:
        return np.ones((n, n), np.int32)
    period = max(float(sync_period), 1e-9)
    finite_lat = np.where(np.isfinite(top.latency), top.latency, 0.0)
    stride = np.where(top.adjacency, np.maximum(1.0, np.ceil(finite_lat / period)), 1.0)
    return np.minimum(stride, 2.0 ** 30).astype(np.int32)


def tick_time(tick: int, period: float) -> float:
    """A tick's sample instant, the reference's f32 ``(tick + 1.0) * period``
    (``period`` is ``max(sync_period, 0)`` as an f32)."""
    return float((np.float32(tick) + np.float32(1.0)) * np.float32(period))


def _unported(**options) -> None:
    for name, (value, item) in options.items():
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet ({item})")


class GossipNetwork:
    """The overlay on the host side: replicas, the tick clock, schedule batching.

    The replicas live on the device of ``dag``. ``edge_draw``,
    ``fault_draw`` and ``serve_draw`` replace the default edge, fault and
    arrival draws (see the module docstrings of this module, of
    ``repro_torch.net.faults`` and of ``repro_torch.net.serve``).
    """

    def __init__(
        self,
        dag: DagState,
        bank: Any,
        top: Topology,
        cfg: GossipConfig = GossipConfig(),
        partition: Optional[PartitionSchedule] = None,
        mesh=None,
        bank_cfg: Optional[BankGossipConfig] = None,
        obs_cfg=None,
        faults_cfg=None,
        serve_cfg=None,
        edge_draw: Optional[EdgeDraw] = None,
        fault_draw: Optional[faults_lib.FaultDraw] = None,
        serve_draw: Optional[serve_lib.ServeDraw] = None,
    ):
        _unported(mesh=(mesh, "ROADMAP A.12"))
        # the effective serving config: None for serve_cfg=None and rate <= 0,
        # under which nothing of the serving layer is built or run
        serve_cfg = serve_lib.serve_key(serve_cfg)
        if serve_cfg is not None:
            serve_lib.validate_serve(serve_cfg, cfg.engine)
        if cfg.engine not in ("ticks", "events"):
            raise ValueError(f"unknown gossip engine: {cfg.engine!r}")
        if cfg.impl not in ("fused", "scan", "lax"):
            raise ValueError(f"unknown gossip round impl: {cfg.impl!r}")
        n = top.num_nodes
        dev = dag.publisher.device
        self.topology = top
        self.cfg = cfg
        self.partition = partition
        self.bank_cfg = bank_cfg
        self.device = dev
        self.faults_cfg = faults_cfg
        self._faults = None
        self._fstate = None          # the defense's carry: bank runs with faults only
        if faults_cfg is not None:
            faults_lib.validate_faults(faults_cfg, n, bank=bank_cfg is not None)
            self._faults = faults_lib.FaultLayer(
                faults_cfg, dev,
                fault_draw if fault_draw is not None else faults_lib.torch_fault_draw(cfg.seed,
                                                                                      dev),
                lambda: self.edge_draws)
        self.replicas = replica_lib.init_replicas(dag, bank, n)
        if bank_cfg is not None:
            self._init_bank(bank, top, cfg, bank_cfg)
        stride = stride_matrix(top, cfg.sync_period, use_strides=cfg.sync_period > 0)
        self._max_stride = int(stride[top.adjacency].max()) if top.adjacency.any() else 1
        self._adj = torch.from_numpy(np.asarray(top.adjacency, bool)).to(dev)
        self._drop = torch.from_numpy(np.asarray(top.drop, np.float32)).to(dev)
        self._stride = torch.from_numpy(stride).to(dev)
        nbr_idx, nbr_valid = neighbor_table(top.adjacency)
        self._nbr_idx = torch.from_numpy(nbr_idx).to(dev)
        self._nbr_valid = torch.from_numpy(nbr_valid).to(dev)
        self._all_mask = torch.ones((n, n), dtype=torch.bool, device=dev)
        self._part_mask = (
            torch.from_numpy(partition_matrix(partition.assignment)).to(dev)
            if partition is not None else self._all_mask
        )
        self._edge_draw = edge_draw if edge_draw is not None else torch_edge_draw(cfg.seed, n, dev)
        self.tick = 0                # global tick index (drives strides)
        self.rounds_run = 0          # ticks / event batches actually executed
        self.edge_draws = 0          # edge draws made: the next edge_draw's index
        self.device_calls = 0        # device entry points issued (_dispatch)
        self.dispatch_counts = {}    # per-entry-point breakdown
        self.events_processed = 0    # event batches fired (engine="events")
        self.events_capped = 0       # advances that stopped at max_events_per_advance
        period = cfg.sync_period
        self._next_tick_t = period if period > 0 else 0.0
        # a tick's f32 instant is (tick + 1) * _period: telemetry's samples
        # and the crash windows read it
        self._period = float(np.float32(max(period, 0.0)))
        self._serve = self._sstate = None
        if cfg.engine == "events":
            self._init_events(top, bank_cfg, partition, serve_cfg, serve_draw)
        self.obs_cfg = obs_cfg
        if obs_cfg is not None:
            self._init_obs(obs_cfg, n)

    def _init_bank(self, bank, top: Topology, cfg: GossipConfig, bank_cfg: BankGossipConfig):
        c = bank_cfg.chunks_per_slot
        slots = bank.rows.shape[0]
        slot_b = (bank_lib.slot_nbytes(bank) if bank_cfg.slot_bytes is None
                  else float(bank_cfg.slot_bytes))
        # the reference's f32 granule, held as the Python float of that value
        self._chunk_bytes = float(np.float32(max(slot_b / c, 1e-9)))
        # what a tick charges per chunk: the codec's encoded size, an f32
        # product as in the reference's _codec_tick; codec_key is None for
        # every codec that prices like raw bytes, which keeps the raw granule
        self._codec = delta_codec.codec_key(bank_cfg.codec)
        self._wire_chunk_bytes = (
            self._chunk_bytes if self._codec is None
            else float(np.float32(self._chunk_bytes) * np.float32(self._codec.wire_ratio())))
        self._digest = bank_lib.bank_digests(bank, c)
        # per-tick, per-directed-link byte budget: Table-I bits/s over one
        # sync period; sync_period <= 0 is the ideal wire, where payload
        # moves as freely as metadata whatever `bandwidth` says
        if cfg.sync_period > 0:
            cap = top.bandwidth / 8.0 * cfg.sync_period
        else:
            cap = np.where(top.adjacency, np.inf, 0.0)
        # converge()'s tick bound also covers draining payloads: a full slot
        # over the slowest finite link costs this many ticks
        finite = cap[top.adjacency & np.isfinite(cap) & (cap > 0)]
        self._drain_ticks = (int(min(np.ceil(slot_b / float(finite.min())), 256))
                             if finite.size else 0)
        self._cap_bytes = torch.from_numpy(np.asarray(cap, np.float32)).to(self.device)
        self.replicas = self.replicas._replace(
            bank_state=bank_lib.init_bank_state(top.num_nodes, slots, c, self.device))
        if self.faults_cfg is not None:
            self._fstate = faults_lib.init_fault_state(top.num_nodes, slots, c, self.device)

    def _init_events(self, top: Topology, bank_cfg, partition, serve_cfg, serve_draw) -> None:
        from repro_torch.net import events as events_lib

        period = self.cfg.sync_period
        self._equeue, self._eislot = events_lib.make_edge_queue(
            top, period if period > 0 else 1.0, drain_slots=bank_cfg is not None,
            device=self.device)
        # the partition window as f32 instants, compared with the f32 event clock
        if partition is not None:
            self._part_t0 = float(np.float32(partition.t_start))
            self._part_t1 = float(np.float32(partition.t_end))
        else:
            self._part_t0, self._part_t1 = float("inf"), float("-inf")
        if bank_cfg is not None:
            n = top.num_nodes
            self._last_srv = torch.zeros((n, n), dtype=torch.float32, device=self.device)
            self._bw_bytes = torch.from_numpy(
                np.asarray(top.bandwidth / 8.0, np.float32)).to(self.device)
        if serve_cfg is not None:
            n = top.num_nodes
            if serve_draw is None:
                serve_draw = serve_lib.torch_serve_draw(self.cfg.seed, serve_cfg.salt, n,
                                                        self.device)
            self._equeue, self._eislot, infer_base = serve_lib.extend_queue(
                self._equeue, self._eislot, n, serve_cfg, serve_draw)
            self._serve = serve_lib.ServeLayer(serve_cfg, serve_draw, infer_base)
            self._sstate = serve_lib.init_serve_state(n, serve_cfg, self.device)

    def _init_obs(self, obs_cfg, n: int) -> None:
        """The telemetry state on the device, and the host span buffer."""
        self._metrics = obs_lib.init_metrics(n, obs_cfg, self.device)
        self._ring = obs_lib.init_trace(obs_cfg.trace_capacity, self.device)
        self._host_events = []        # (t, kind, src, dst, arg) spans
        self._part_logged = [False, False]
        if obs_cfg.hist is not None:
            # the propagation latch starts from the actual initial state; the
            # queue-wait FIFO is sized by the serve queue (0 without serving)
            qcap = self._serve.cfg.queue_cap if self._serve is not None else 0
            self._metrics.hist = hist_lib.init_hist(obs_cfg.hist, self.replicas.dags,
                                                    queue_cap=qcap)

    # --- replica access ----------------------------------------------------

    @property
    def bank(self):
        return self.replicas.bank

    def read(self, i) -> DagState:
        """A copy of node i's replica: later writes and rounds leave it as it is."""
        return replica_lib.snapshot(replica_lib.read_replica(self.replicas, i))

    def write(self, i, dag: DagState, bank=None) -> None:
        """Write node i's replica in place (``replica.write_replica``)."""
        self.replicas = replica_lib.write_replica(self.replicas, i, dag)
        if bank is not None:
            self.replicas = self.replicas._replace(bank=bank)

    # --- bank transport (only when constructed with bank_cfg) ---------------

    @property
    def bank_state(self) -> Optional[BankState]:
        return self.replicas.bank_state

    def read_view(self, i) -> DagState:
        """Node i's usable view, a copy: with the bank gossiped, rows whose
        model chunks have not arrived are masked out (``bank.gate_view``, one
        ``chunk_dedup`` launch), so Algorithm 2 cannot select or approve a
        payload-less transaction; without bank gossip exactly ``read``."""
        dag = self.read(i)
        if self.bank_cfg is None:
            return dag
        return bank_lib.gate_view(dag, self.replicas.bank_state.have[i], self._digest)

    def bank_commit(self, node_id: int, slot: int, params) -> None:
        """Account a stage-4 commit in the transport state: the committer
        holds the new chunks, every other node's presence bits for the
        (ring-reused) slot reset, and the slot's digest is re-derived."""
        if self.bank_cfg is None:
            return
        bstate = self.replicas.bank_state
        have, self._digest = self._dispatch("bank_commit", bank_lib.commit_chunks,
                                            bstate.have, self._digest, params, slot, node_id)
        self.replicas = self.replicas._replace(bank_state=bstate._replace(have=have))

    def missing_chunks(self) -> np.ndarray:
        """(N,) referenced-but-unavailable chunks per node — the payload lag
        behind row visibility (all zeros without bank gossip)."""
        if self.bank_cfg is None:
            return np.zeros(self.topology.num_nodes, np.int32)
        return bank_lib.missing_chunks(self.replicas.dags, self.replicas.bank_state,
                                       self._digest).cpu().numpy()

    def bytes_sent(self) -> float:
        """Total payload bytes delivered so far (the Table-I traffic bill).

        An f32 sum, as the reference's, taken on the host: a sum on the card
        adds in another order, and with a codec's non-integral chunk prices
        (451,171.875 B for int8) the order shows in the total."""
        if self.bank_cfg is None:
            return 0.0
        return float(self.replicas.bank_state.sent.cpu().sum())

    def union(self) -> DagState:
        return replica_lib.merge_all(self.replicas.dags)

    def synced(self) -> bool:
        """Fully converged: row-identical replicas and, with the bank
        gossiped, every referenced payload delivered. The chunk count is read
        either way (one ``chunk_dedup`` launch), so a run's launches do not
        depend on whether its rows synced."""
        rows = bool(replica_lib.replicas_synced(self.replicas.dags))
        if self.bank_cfg is None:
            return rows
        return int(self.missing_chunks().max()) == 0 and rows

    def missing_rows(self, union: Optional[DagState] = None) -> np.ndarray:
        """(N,) rows each replica lacks vs the union view (0 = converged).
        Pass a precomputed ``union()`` to avoid re-folding the replicas."""
        return replica_lib.missing_vs_union(self.replicas.dags, union).cpu().numpy()

    # --- telemetry (only when constructed with obs_cfg) ---------------------

    def _observe(self, t: float, old: DagState, new: DagState, edges: torch.Tensor,
                 old_b: Optional[BankState] = None, new_b: Optional[BankState] = None,
                 old_f: Optional[faults_lib.FaultState] = None,
                 new_f: Optional[faults_lib.FaultState] = None,
                 serve: Optional[dict] = None) -> None:
        """The collector step after one executed round (``obs.observe_round``);
        a faulted bank run also passes its rejection state, a serving run its
        serve arguments."""
        bank = {} if new_b is None else dict(
            bytes_delta=new_b.sent - old_b.sent, bstate=new_b, digest=self._digest,
            old_have=old_b.have)
        if new_f is not None:
            bank.update(rejects=new_f.rejects, rejects_delta=new_f.rejects - old_f.rejects,
                        quarantine_after=self.faults_cfg.quarantine_after)
        self._metrics, self._ring = obs_lib.observe_round(
            self.obs_cfg, self._metrics, self._ring, t, old, new, live_edges=edges, **bank,
            **(serve or {}))

    def trace_host(self, t, kind, src, dst, arg=0.0) -> None:
        """Buffer a host-side trace span (PUBLISH/COMMIT/PARTITION: the FL
        loop knows them, so recording them costs no device work); merged
        with the device ring at drain. No-op without telemetry."""
        if self.obs_cfg is not None and self.obs_cfg.trace:
            self._host_events.append((float(t), int(kind), int(src), int(dst), float(arg)))

    def trace_device(self, t, kind, src, dst, arg=0.0) -> None:
        """Record a host-initiated span through the device trace ring (the
        ``ObsConfig.device_spans`` path): the record ``trace_host`` buffers,
        appended with ``trace.append_edges`` under a one-hot mask, so it
        shares the ring's capacity and drops; values take the ring's f32.
        No-op without telemetry or trace."""
        if self.obs_cfg is None or not self.obs_cfg.trace:
            return
        n = self.topology.num_nodes
        mask = torch.zeros((n, n), dtype=torch.bool, device=self.device)
        if 0 <= dst < n and 0 <= src < n:
            mask[dst, src] = True
        self._ring = self._dispatch("trace_device", obs_trace.append_edges, self._ring,
                                    float(np.float32(t)), kind, mask, float(np.float32(arg)))

    def trace_span(self, t, kind, src, dst, arg=0.0) -> None:
        """PUBLISH/COMMIT entry point for the FL loop: the device ring
        under ``ObsConfig.device_spans``, the host buffer otherwise."""
        if self.obs_cfg is not None and self.obs_cfg.device_spans:
            self.trace_device(t, kind, src, dst, arg)
        else:
            self.trace_host(t, kind, src, dst, arg)

    def _note_partition(self, t: float) -> None:
        """Record the partition's begin and heal once each, the first time
        the clock reaches them."""
        if self.obs_cfg is None or self.partition is None:
            return
        p = self.partition
        if not self._part_logged[0] and t >= p.t_start:
            self._part_logged[0] = True
            self.trace_host(p.t_start, obs_trace.KIND_PARTITION, -1, -1, 1.0)
        if not self._part_logged[1] and t >= p.t_end:
            self._part_logged[1] = True
            self.trace_host(p.t_end, obs_trace.KIND_PARTITION, -1, -1, 0.0)

    def obs_report(self):
        """Drain the collectors into a host-side ``ObsReport``: the series
        cut to the samples taken, the trace ring merged with the host spans,
        dispatch counts and final-state scalars. ``None`` without telemetry.
        The only place a run's telemetry is read back."""
        if self.obs_cfg is None:
            return None
        m = self._metrics
        taken = min(m.cursor, m.t.shape[0])
        series = {}
        for name in obs_metrics.SERIES:
            x = getattr(m, name)[:taken].cpu().numpy()
            series[name] = x.astype(np.float64 if x.dtype == np.float32 else np.int64)
        final = {
            "bytes_sent": self.bytes_sent(),
            "chunk_lag": float(self.missing_chunks().max()),
            "staleness": float(self.missing_rows().max()),
        }
        if self._fstate is not None:
            final["rejected"] = float(self._fstate.rejects.cpu().numpy().astype(np.int64).sum())
            final["quarantined"] = float(self.quarantined_links().sum())
        hist = (hist_lib.report_dict(m.hist, self.obs_cfg.hist)
                if self.obs_cfg.hist is not None else None)
        return obs_lib.ObsReport(
            num_nodes=self.topology.num_nodes,
            engine=self.cfg.engine,
            rounds=m.rounds,
            series=series,
            rows_merged=m.rows_merged.cpu().numpy().astype(np.int64),
            link_bytes=m.link_bytes.cpu().numpy().astype(np.float64),
            samples_dropped=m.dropped,
            trace=obs_trace.drain(self._ring, self._host_events),
            trace_dropped=int(self._ring.dropped),
            dispatch_counts=dict(self.dispatch_counts),
            final=final,
            hist=hist,
        )

    # --- fault injection (only when constructed with faults_cfg) ------------

    @property
    def fault_state(self) -> Optional[faults_lib.FaultState]:
        """The defense's carry (``rejects``, ``tainted``) on the device; None
        without faults or without bank gossip."""
        return self._fstate

    def quarantined_links(self) -> np.ndarray:
        """(N, N) bool — links the digest check has cut (``rejects >=
        quarantine_after``). All False without faults or without bank gossip
        (bankless faults carry no rejection state)."""
        n = self.topology.num_nodes
        if self._fstate is None:
            return np.zeros((n, n), bool)
        return faults_lib.quarantined(self._fstate, self.faults_cfg).cpu().numpy()

    def rejection_credit(self) -> Optional[np.ndarray]:
        """(N,) per-sender trust from cumulative digest rejections
        (``anomaly.rejection_credit``): 1.0 for clean senders, floored near 0
        for spoofers. None without a fault-state carry."""
        if self._fstate is None:
            return None
        from repro_torch.core import anomaly

        return anomaly.rejection_credit(self._fstate.rejects).cpu().numpy()

    def tainted_in_views(self) -> np.ndarray:
        """(N,) corrupted chunks referenced by rows visible in each node's
        gated view — the attack-success numerator. With digest verification
        on it is identically zero: corrupted payloads never set a presence
        bit, so ``gate_view`` never exposes a row backed by them."""
        n = self.topology.num_nodes
        out = np.zeros(n, np.int64)
        if self._fstate is None:
            return out
        tainted = self._fstate.tainted.cpu().numpy()
        for i in range(n):
            view = self.read_view(i)
            slots = view.model_slot.cpu().numpy()[view.publisher.cpu().numpy() >= 0]
            slots = np.unique(slots[slots >= 0])
            out[i] = int(tainted[i, slots, :].sum())
        return out

    def fault_report(self) -> Optional[dict]:
        """The adversary and defense state on the host: roles, the per-link
        rejection matrix, the quarantined-link count, per-node tainted-chunk
        counts, the attack-success numerator (``tainted_in_views``) and the
        rejection credit. None without fault injection."""
        if self.faults_cfg is None:
            return None
        report = {
            "roles": np.asarray(self.faults_cfg.roles, np.int32),
            "verify_digests": self.faults_cfg.verify_digests,
        }
        if self._fstate is not None:
            rejects = self._fstate.rejects.cpu().numpy()
            report.update(
                rejects=rejects,
                rejected_total=int(rejects.astype(np.int64).sum()),
                quarantined_links=int(self.quarantined_links().sum()),
                tainted_chunks=self._fstate.tainted.sum(dim=(1, 2), dtype=torch.int32)
                .cpu().numpy(),
                tainted_in_views=self.tainted_in_views(),
                rejection_credit=self.rejection_credit(),
            )
        return report

    # --- inference serving (only when constructed with an effective serve_cfg)

    @property
    def serve_state(self) -> Optional[serve_lib.ServeState]:
        """The serving counters and samples on the device; None when serving
        is off."""
        return self._sstate

    def serve_report(self) -> Optional[dict]:
        """The serving summary on the host (``serve.report``): per-node
        served, arrived, queued, in-flight, dropped and batch counts, and the
        staleness-at-admit samples and percentiles. None when serving is off.
        """
        if self._serve is None:
            return None
        return serve_lib.report(self._sstate, self._serve.cfg)

    # --- the clock ---------------------------------------------------------

    def _mask_at(self, t: float) -> torch.Tensor:
        if self.partition is not None and self.partition.active(t):
            return self._part_mask
        return self._all_mask

    def _dispatch(self, label: str, fn, *args):
        """Issue one state-advancing entry point through the counting funnel:
        ``device_calls`` counts them all, ``dispatch_counts`` by label. With
        telemetry on (``ObsConfig.annotate``), the call runs inside
        ``torch.profiler.record_function`` so profiles name the phase."""
        self.device_calls += 1
        self.dispatch_counts[label] = self.dispatch_counts.get(label, 0) + 1
        annotate = self.obs_cfg is not None and self.obs_cfg.annotate
        with (torch.profiler.record_function(f"repro_torch.net.{label}") if annotate
              else contextlib.nullcontext()):
            return fn(*args)

    def _next_uniform(self) -> torch.Tensor:
        """The next round's (N, N) edge draw."""
        uniform = self._edge_draw(self.edge_draws)
        self.edge_draws += 1
        return uniform

    def _round(self, dags: DagState, bstate: Optional[BankState],
               fstate: Optional[faults_lib.FaultState], tick: int, part_mask: torch.Tensor):
        """One executed round: the next edge draw, the sampled mask, the merge
        and, with the bank gossiped, the chunk step. With faults the mask is
        attacked before the merge, sybil rows are forged after it, and the
        bank's service is the fault-aware one. Returns (dags, bstate, fstate)."""
        uniform = self._next_uniform()
        self.rounds_run += 1
        edges = _sample_edges(uniform, tick, part_mask, self._adj, self._drop, self._stride)
        t = tick_time(tick, self._period)
        fl = self._faults
        newf = fstate
        if fl is not None:
            edges = fl.edges(t, edges)
            new = fl.inflate(_apply_round(dags, edges, self._nbr_idx, self._nbr_valid,
                                          self.cfg.impl))
            newb = None
            if bstate is not None:
                newb, newf, _pending = fl.service(new, bstate, fstate, self._digest, edges,
                                                  self._cap_bytes, self._wire_chunk_bytes)
        elif bstate is None:
            new, newb = _apply_round(dags, edges, self._nbr_idx, self._nbr_valid,
                                     self.cfg.impl), None
        else:
            new, newb = _bank_tick_single(dags, bstate, self._digest, edges, self._nbr_idx,
                                          self._nbr_valid, self._cap_bytes,
                                          self._wire_chunk_bytes, self.cfg.impl)
        if self.obs_cfg is not None:
            self._observe(t, dags, new, edges, bstate, newb, fstate, newf)
        return new, newb, newf

    def _advance_window(self, ticks, part_active) -> None:
        dags, bstate, fstate = self.replicas.dags, self.replicas.bank_state, self._fstate
        for tick, pact in zip(ticks, part_active):
            dags, bstate, fstate = self._round(dags, bstate, fstate, tick,
                                               self._part_mask if pact else self._all_mask)
        self.replicas = self.replicas._replace(dags=dags, bank_state=bstate)
        self._fstate = fstate

    def _run_ticks(self, ticks, part_active) -> None:
        """Execute a batch of sync ticks as one entry point."""
        label = "advance" if self.bank_cfg is None else "advance_bank"
        self._dispatch(label, self._advance_window, ticks, part_active)
        self.tick += len(ticks)

    def _tick_once(self, t: float) -> None:
        """One sync tick at simulation time ``t`` (a batch of one)."""
        pact = self.partition is not None and self.partition.active(t)
        self._run_ticks([self.tick], [pact])

    def _advance_events(self, t: float) -> None:
        """Run every continuous-time event at or before ``t`` (an f32
        instant) as one entry point (``repro_torch.net.events``). Delivery
        slots recycle in place, so the queue state persists across calls;
        fire counts start from zero in each call."""
        from repro_torch.net import events as events_lib

        horizon = float(np.float32(t))
        cfg = self.cfg
        window = (horizon, cfg.max_events_per_advance, cfg.max_ticks_per_advance,
                  self._part_mask, self._part_t0, self._part_t1, self._drop,
                  self._nbr_idx, self._nbr_valid)
        observe = self._observe if self.obs_cfg is not None else None
        # the reference names its serving programs apart
        suffix = "_serve" if self._serve is not None else ""
        if self.bank_cfg is not None:
            (dags, bstate, self._fstate, self._last_srv, qt, qv, done,
             self._sstate) = self._dispatch(
                "advance_events_bank" + suffix, events_lib.advance_events_bank,
                self.replicas.dags, self.replicas.bank_state, self._last_srv, self._digest,
                self._equeue, self._eislot, self._next_uniform, *window, self._bw_bytes,
                self._wire_chunk_bytes, cfg.impl, observe, self._faults, self._fstate,
                self._serve, self._sstate)
            self.replicas = self.replicas._replace(dags=dags, bank_state=bstate)
        else:
            dags, qt, qv, done, self._sstate = self._dispatch(
                "advance_events" + suffix, events_lib.advance_events, self.replicas.dags,
                self._equeue, self._eislot, self._next_uniform, *window, cfg.impl, observe,
                self._faults, self._serve, self._sstate)
            self.replicas = self.replicas._replace(dags=dags)
        self._equeue = self._equeue._replace(time=qt, valid=qv)
        self.tick += done
        self.rounds_run += done
        self.events_processed += done
        self.events_capped += int(done == cfg.max_events_per_advance)

    def advance(self, t: float) -> None:
        """Run every sync tick (or, on the events engine, every event)
        scheduled at or before simulation time ``t`` as one batched entry
        point."""
        self._note_partition(t)
        if self.cfg.sync_period <= 0:
            self.converge(at_time=t)
            return
        if self.cfg.engine == "events":
            self._advance_events(t)
            return
        ticks, pacts = [], []
        nt = self._next_tick_t
        while nt <= t and len(ticks) < self.cfg.max_ticks_per_advance:
            ticks.append(self.tick + len(ticks))
            pacts.append(self.partition is not None and self.partition.active(nt))
            nt += self.cfg.sync_period
        if ticks:
            self._run_ticks(ticks, pacts)
        self._next_tick_t = nt
        if self._next_tick_t <= t:     # window overflowed the cap: fast-forward
            periods_behind = int((t - self._next_tick_t) // self.cfg.sync_period) + 1
            self.tick += periods_behind
            self._next_tick_t += periods_behind * self.cfg.sync_period

    def _synced(self, dags: DagState, bstate: Optional[BankState]) -> bool:
        """The fixpoint predicate: rows synced and, with the bank gossiped,
        no referenced chunk missing anywhere."""
        if not bool(replica_lib.replicas_synced(dags)):
            return False
        return bstate is None or int(bank_lib.missing_chunks(dags, bstate, self._digest).max()) == 0

    def _converge_loop(self, part_mask: torch.Tensor, limit: int, stall_limit: int) -> bool:
        dags, bstate, fstate = self.replicas.dags, self.replicas.bank_state, self._fstate
        stalled = done = 0
        while done < limit and stalled < stall_limit and not self._synced(dags, bstate):
            new, newb, newf = self._round(dags, bstate, fstate, self.tick, part_mask)
            same = trees_equal(new, dags)
            if bstate is not None:      # credit accrual on a pending link is progress
                same = same & trees_equal(newb, bstate)
            if fstate is not None:      # so are rejections accruing toward quarantine
                same = same & trees_equal(newf, fstate)
            stalled = stalled + 1 if bool(same) else 0
            dags, bstate, fstate = new, newb, newf
            self.tick += 1
            done += 1
        self.replicas = self.replicas._replace(dags=dags, bank_state=bstate)
        self._fstate = fstate
        return self._synced(dags, bstate)

    def converge(self, at_time: float = float("inf")) -> bool:
        """Tick until the replicas reach fixpoint (ideal-wire flush / heal).

        Bounded by ``num_nodes * max_stride`` ticks (stride capped at 64), and
        with the bank gossiped by ``(num_nodes + drain_ticks) * max_stride``:
        rows cross in at most num_nodes strided hops, then chunks drain at
        the per-link budget. A full stride cycle of unchanged state (and
        transport state) is a fixpoint (partition active, overlay
        disconnected, or a dead link). Returns whether full sync was reached.

        The reference runs this as one ``lax.while_loop`` with its predicate
        on the device; here it is a Python loop whose predicate costs host
        reads every tick (synced, unchanged; with the bank the missing-chunk
        count, one ``chunk_dedup`` launch, once rows are synced). Keeping
        the loop on the device (CUDA graphs) is later work.
        """
        self._note_partition(at_time)
        stride = min(self._max_stride, 64)
        if self.bank_cfg is None:
            return self._dispatch("converge", self._converge_loop, self._mask_at(at_time),
                                  self.topology.num_nodes * stride, stride)
        return self._dispatch("converge_bank", self._converge_loop, self._mask_at(at_time),
                              (self.topology.num_nodes + self._drain_ticks) * stride, stride)
