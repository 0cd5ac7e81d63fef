"""Continuous-time event engine: the overlay without tick quantisation.

The §IV deployment model is asynchronous: nodes finish Eq. (5)-(7)
iterations on their own clocks (Poisson arrivals, per-node ``h_i``), and
messages cross each wireless link after that link's own latency. The tick
engine (``repro_torch.net.gossip``) approximates that on a global grid: a
link with latency l fires every ``ceil(l / sync_period)`` ticks. This
module is the port of the reference's discrete-event engine
(``repro.net.events``):

  queue    a fixed-capacity event queue stored as stacked tensors
           ``(time, kind, src, dst, seq)`` with a validity mask
           (``EventQueue``): no heap, no data-dependent shapes;
  pop      the queue head is a masked lexicographic argmin over
           ``(time, kind, seq)`` — ``repro_torch.kernels.event_pop`` (the
           CUDA kernel on a card, its plain version on the CPU);
  advance  a loop over event batches. Each iteration launches the pop
           once, reads back its small result once (the batch's only host
           sync), gathers every event firing at that instant, processes the
           batch and reschedules. It stops when nothing is valid, when the
           head lies past the horizon (an f32 comparison: the event clock
           is f32), or after ``limit`` batches. Each delivery edge fires at
           most ``fire_cap`` times per window; an overflowing backlog is
           elided (the edge jumps past the horizon) exactly as the ticks
           engine fast-forwards. The reference keeps the whole horizon in
           one ``lax.while_loop`` on the device; keeping this loop on the
           device is later work.

Event kinds (tie order at one instant: rows merge, then payloads settle,
then completions land, then new iterations read):

  ``KIND_DELIVER``  anti-entropy delivery on a directed edge, every
                    ``delivery_intervals`` seconds (the link's latency;
                    zero-latency links on the protocol's ``sync_period``).
                    Simultaneous deliveries merge as ONE fused round.
  ``KIND_DRAIN``    bank chunk-drain completion: a link whose byte budget
                    ran out mid-slot finishes its next whole chunk at
                    ``t + remaining / rate``; bandwidth accrues continuously
                    (``(t - last_serviced) * B/8``).
  ``KIND_PUBLISH``  iteration completion in the §IV in-system simulation.
  ``KIND_START``    iteration start in the §IV in-system simulation.
  ``KIND_INFER``    inference serving (``repro_torch.net.serve``): a
                    node's request arrival or batch completion.

Telemetry: both advances take an ``observe`` callback, called after every
batch with ``(t, old_dags, dags, live, old_bstate, bstate, old_fstate,
fstate)`` and, when serving, the keyword ``serve`` (the batch's serve
arguments to ``obs.observe_round``): the ``GossipNetwork``'s
``observe_round`` step; None runs nothing. The batch bodies are functional,
so the pre-batch state is the loop's own.

Serving: both advances take a ``repro_torch.net.serve.ServeLayer`` and its
``ServeState`` (None runs none of it: the serve-free loops). A batch whose
head is an INFER slot runs ``ServeLayer.step`` against the replicas' plain
staleness, or with the bank against the view gated by one ``chunk_dedup``
of the presence bitmaps; it makes no edge draw and runs no bank service,
and it counts in ``done`` as every batch does. Transport heads run the
serve-free body.

Faults: both advances take a ``repro_torch.net.faults.FaultLayer`` (None
runs none of it). A delivery batch's live mask is attacked after drop loss
(a suppressed delivery has still used its queue slot) and sybil rows are
forged after the merge; with the bank the fault-aware service replaces the
chunk step in every batch, a drain-only one too, and threads the
``FaultState``. A quarantined link gets no stripe, so its drain slot
disarms while its deliveries keep firing.
``simulate_insystem_tips(record_trace=True)`` records a PUBLISH span per
started iteration and a COMMIT per landed transaction in a device trace
ring, and ``InSystemTrace.to_report`` exports a run in the ``repro_torch.obs``
format.

Draws. Every delivery batch draws one (N, N) edge uniform, through the
caller's ``next_uniform()`` (``GossipNetwork`` indexes its ``edge_draw`` by
the delivery rounds drawn so far); a drain-only batch draws nothing, as in
the reference, whose key splits only in the round. The in-system simulation
makes all its draws through one ``TipDraw`` function.

Degenerate limit: with a uniform per-edge delay equal to a dyadic sync
period, deliveries fire in lockstep batches at exactly the tick times, one
draw per batch as the tick engine draws one per tick, and the merge
sequence is bitwise the ticks engine's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dag as dag_lib
from repro_torch.core import stability as stability_lib
from repro_torch.core.dag import DagState
from repro_torch.kernels import chunk_transfer as chunk_kernel
from repro_torch.kernels import event_pop as pop_kernel
from repro_torch.net import bank as bank_lib
from repro_torch.net import gossip as gossip_lib
from repro_torch.net import replica as replica_lib
from repro_torch.net import serve as serve_lib
from repro_torch.net.topology import Topology, neighbor_table, partition_matrix
from repro_torch.obs import trace as obs_trace

KIND_DELIVER = 0   # anti-entropy delivery on edge (src -> dst)
KIND_DRAIN = 1     # bank chunk-drain completion on edge (src -> dst)
KIND_PUBLISH = 2   # iteration completion: dst publishes its transaction
KIND_START = 3     # iteration start: a node reserves tips, begins h_i work
KIND_INFER = 4     # inference-serving slot (sorts after every transport kind)

_INT32_MAX = torch.iinfo(torch.int32).max

NextUniform = Callable[[], torch.Tensor]
Observe = Callable[..., None]


class EventQueue(NamedTuple):
    """Fixed-capacity event queue as stacked tensors.

    Invalid slots carry ``time = +inf``; ``seq`` is a unique per-slot
    tie-break (insertion order). ``time`` is float32, as the reference's.
    """

    time: torch.Tensor    # (Q,) f32, +inf on invalid slots
    kind: torch.Tensor    # (Q,) i32
    src: torch.Tensor     # (Q,) i32 sender (edge events) / acting node
    dst: torch.Tensor     # (Q,) i32 receiver (edge events) / acting node
    seq: torch.Tensor     # (Q,) i32 unique tie-break
    valid: torch.Tensor   # (Q,) bool


def delivery_intervals(top: Topology, sync_period: float) -> np.ndarray:
    """(N, N) f32 inter-delivery interval per directed edge: the link's
    latency, zero-latency links on the protocol's ``sync_period``; +inf
    off-link."""
    lat = np.where(np.isfinite(top.latency), top.latency, 0.0)
    iv = np.where(lat > 0, lat, float(sync_period))
    return np.where(top.adjacency, iv, np.inf).astype(np.float32)


def make_edge_queue(top: Topology, sync_period: float, drain_slots: bool = False,
                    device=None):
    """The perpetual edge-event slots of an overlay.

    One ``KIND_DELIVER`` slot per directed edge in ``np.nonzero(adjacency)``
    order (receiver-major), first firing one interval in and rescheduling
    itself forever. ``drain_slots=True`` adds one initially invalid
    ``KIND_DRAIN`` slot per directed edge. An edgeless overlay gets a single
    invalid slot.

    Returns ``(EventQueue, slot_interval (Q,) f32)`` — the per-slot delivery
    cadence (0 on drain slots).
    """
    iv = delivery_intervals(top, sync_period)
    dst, src = np.nonzero(top.adjacency)        # receiver i hears sender j
    e = len(dst)
    if e == 0:
        dst = src = np.zeros(1, np.int64)
        times = np.full(1, np.inf, np.float32)
        kinds = np.zeros(1, np.int32)
        valid = np.zeros(1, bool)
        interval = np.full(1, np.inf, np.float32)
    else:
        times = iv[dst, src].astype(np.float32)
        kinds = np.zeros(e, np.int32)
        valid = np.ones(e, bool)
        interval = times.copy()
        if drain_slots:
            dst = np.concatenate([dst, dst])
            src = np.concatenate([src, src])
            times = np.concatenate([times, np.full(e, np.inf, np.float32)])
            kinds = np.concatenate([kinds, np.full(e, KIND_DRAIN, np.int32)])
            valid = np.concatenate([valid, np.zeros(e, bool)])
            interval = np.concatenate([interval, np.zeros(e, np.float32)])

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

    queue = EventQueue(
        time=dev(times, np.float32), kind=dev(kinds, np.int32), src=dev(src, np.int32),
        dst=dev(dst, np.int32), seq=torch.arange(len(times), dtype=torch.int32, device=device),
        valid=dev(valid, bool),
    )
    return queue, dev(interval, np.float32)


def _edge_mask(n: int, qdst: torch.Tensor, qsrc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, N) bool — the queue-slot mask scattered onto directed-edge
    coordinates (a scatter-add, then ``> 0``)."""
    hits = torch.zeros((n, n), dtype=torch.int32, device=mask.device)
    return hits.index_put_((qdst, qsrc), mask.to(torch.int32), accumulate=True) > 0


def _queue_head_due(head_time: float, horizon: float) -> bool:
    """Is the head at or before the horizon? Both are f32 values held as
    Python floats, so this is the reference's f32 comparison (a NaN head is
    never due)."""
    return head_time <= horizon


def _partition_mask(t: float, part_mask: torch.Tensor, part_t0: float,
                    part_t1: float) -> torch.Tensor:
    """(N, N) bool — the partition's edge suppression at instant ``t``
    (active on ``t_start <= t < t_end``; all f32 values)."""
    if part_t0 <= t < part_t1:
        return part_mask
    return torch.ones_like(part_mask)


class Head(NamedTuple):
    idx: int                # the head's slot
    t: float                # its f32 time
    kind: int
    time: torch.Tensor      # () f32 on the queue's device: the same time


def _pop_head(qt, qkind, qseq, qv, horizon: float) -> Optional[Head]:
    """One ``pop_head``: the head kernel's launch and its one host sync (the
    words come back through a pinned mirror). None when the loop stops:
    nothing valid, or the head past ``horizon``."""
    idx, found, t, kind, head = pop_kernel.pop_head(qt, qkind, qseq, qv)
    if not found or not _queue_head_due(t, horizon):
        return None
    return Head(idx, t, kind, head[2].view(torch.float32))


def _deliver_round(dags: DagState, qt, fires, uniform, t: float, qv, qkind, qsrc, qdst, islot,
                   horizon: float, fire_cap: int, part_mask, part_t0: float, part_t1: float,
                   drop, nbr_idx, nbr_valid, impl: str, faults=None):
    """One fused anti-entropy round over every delivery firing at instant
    ``t`` — the one block all three loops run. ``uniform`` is the batch's
    (N, N) edge draw; ``faults`` (a ``FaultLayer``) attacks the live mask
    and forges sybil rows after the merge.

    Reschedule: a fired edge moves one interval out; an edge that has fired
    ``fire_cap`` times in this advance window instead jumps to its first
    fire time strictly past ``horizon`` (the ticks engine's fast-forward).
    ``qsrc``/``qdst`` are long tensors.

    Returns ``(dags, qt, fires, deliver, live, pm)``.
    """
    n = dags.publisher.shape[0]
    batch = qv & (qt == t) & (qkind == KIND_DELIVER)
    deliver = _edge_mask(n, qdst, qsrc, batch)
    pm = _partition_mask(t, part_mask, part_t0, part_t1)
    live = deliver & pm & (uniform >= drop)
    if faults is not None:
        live = faults.edges(t, live)
    dags = gossip_lib._apply_round(dags, live, nbr_idx, nbr_valid, impl)
    if faults is not None:
        dags = faults.inflate(dags)
    fires = fires + batch.to(torch.int32)
    elide = fires >= fire_cap
    skip = (torch.floor((horizon - qt) / islot) + 1.0) * islot
    qt = torch.where(batch, qt + torch.where(elide, skip, islot), qt)
    return dags, qt, fires, deliver, live, pm


# ---------------------------------------------------------------------------
# Engine A: GossipNetwork advance — deliveries (+ bank drains) to a horizon
# ---------------------------------------------------------------------------


def _serve_sample(serve, sstate) -> dict:
    """A transport batch's serve sample for ``observe``: the served counters
    (nothing without serving)."""
    return {} if serve is None else {"serve": {"serve_counts": sstate.served}}


def _infer_batch(serve, sstate, t: float, qt, qv, stale, observe, obs_args):
    """An INFER head's batch: ``serve.step`` at instant ``t`` against the
    gated staleness ``stale``, then ``observe(t, *obs_args)`` with the serve
    samples. Returns ``(sstate, qt, qv)``."""
    old = sstate
    sstate, qt, qv, admitted, batch_now, s_now = serve.step(sstate, t, qt, qv, stale)
    if observe is not None:
        observe(t, *obs_args,
                serve=serve_lib.observed(old, sstate, admitted, batch_now, s_now, stale))
    return sstate, qt, qv


def advance_events(dags: DagState, queue: EventQueue, islot, next_uniform: NextUniform,
                   horizon: float, limit: int, fire_cap: int, part_mask, part_t0: float,
                   part_t1: float, drop, nbr_idx, nbr_valid, impl: str,
                   observe: Optional[Observe] = None, faults=None, serve=None, sstate=None):
    """The event-driven ``advance`` without the bank (the reference's
    ``_advance_events_jit`` body, with ``faults`` its
    ``_advance_events_faults_jit``, with ``serve`` its
    ``_advance_events_serve_jit``): every transport batch is one
    ``_deliver_round``, an INFER batch one ``ServeLayer.step``, then
    ``observe`` when given. ``horizon``, ``part_t0`` and ``part_t1`` are f32
    values.

    Returns ``(dags, qt, qv, done, sstate)`` — ``done`` batches ran.
    """
    qt, qv = queue.time, queue.valid
    qsrc, qdst = queue.src.long(), queue.dst.long()
    fires = torch.zeros_like(queue.seq)         # per-window fire counts
    done = 0
    while done < limit:
        head = _pop_head(qt, queue.kind, queue.seq, qv, horizon)
        if head is None:
            break
        if serve is not None and head.kind == KIND_INFER:
            sstate, qt, qv = _infer_batch(serve, sstate, head.t, qt, qv,
                                          serve_lib.gated_staleness(dags), observe,
                                          (dags, dags, None))
            done += 1
            continue
        old = dags
        dags, qt, fires, _dlv, live, _pm = _deliver_round(
            dags, qt, fires, next_uniform(), head.t, qv, queue.kind, qsrc, qdst, islot,
            horizon, fire_cap, part_mask, part_t0, part_t1, drop, nbr_idx, nbr_valid, impl,
            faults)
        if observe is not None:
            observe(head.t, old, dags, live, **_serve_sample(serve, sstate))
        done += 1
    return dags, qt, qv, done, sstate


def advance_events_bank(dags: DagState, bstate: bank_lib.BankState, last_srv, digest,
                        queue: EventQueue, islot, next_uniform: NextUniform, horizon: float,
                        limit: int, fire_cap: int, part_mask, part_t0: float, part_t1: float,
                        drop, nbr_idx, nbr_valid, bw_bytes, chunk_bytes: float, impl: str,
                        observe: Optional[Observe] = None, faults=None, fstate=None,
                        serve=None, sstate=None):
    """The event-driven ``advance`` with the model bank gossiped (the
    reference's ``_advance_events_bank_jit`` plain body, or with ``faults``
    and its carry ``fstate`` its ``_advance_events_bank_faults_jit``).

    A batch whose head is a delivery runs ``_deliver_round`` (deliveries
    sort before drains at one instant, so the head's kind says whether the
    batch holds one); a drain-only batch skips the round and its draw. Then
    the bank services every edge whose delivery survived or whose drain
    fired (drains are partition-gated, not loss-gated), with a budget
    accrued continuously since the edge's last service; the clock resets on
    every scheduled edge. Serviced drain slots re-arm at the next
    whole-chunk instant if work is pending, clamped to the next f32 instant
    after ``t`` (so a drain always makes progress); fired drains that were suppressed
    retry one chunk-time later. ``chunk_bytes`` is the wire price of a
    chunk (an f32 value: ``chunk_bytes * wire_ratio()`` with a codec).
    ``observe``, when given, runs after every batch. With ``faults`` every
    batch's service is ``FaultLayer.service`` (its spoof draws indexed by
    the batch's count within this advance, INFER batches included) and
    ``fstate`` is threaded. With ``serve`` an INFER head serves against the
    gated view (one ``chunk_dedup``) and leaves the transport as it was.

    Returns ``(dags, bstate, fstate, last_srv, qt, qv, done, sstate)``.
    """
    n = dags.publisher.shape[0]
    qt, qv = queue.time, queue.valid
    qkind = queue.kind
    qsrc, qdst = queue.src.long(), queue.dst.long()
    is_drn = qkind == KIND_DRAIN
    rate = bw_bytes.clamp(min=1e-9)
    # chunk_bytes / rate as a tensor division: a Python scalar over a tensor
    # is a reciprocal times the scalar in PyTorch, not an IEEE division
    chunk_time = torch.full_like(rate, chunk_bytes) / rate
    fires = torch.zeros_like(queue.seq)
    done = 0
    while done < limit:
        head = _pop_head(qt, qkind, queue.seq, qv, horizon)
        if head is None:
            break
        t = head.t
        if serve is not None and head.kind == KIND_INFER:
            stale = serve_lib.gated_staleness(dags, chunk_kernel.chunk_dedup(bstate.have, digest))
            sstate, qt, qv = _infer_batch(serve, sstate, t, qt, qv, stale, observe,
                                          (dags, dags, None, bstate, bstate, fstate, fstate))
            done += 1
            continue
        old_dags, old_bstate, old_fstate = dags, bstate, fstate
        batch = qv & (qt == t)
        drain = _edge_mask(n, qdst, qsrc, batch & is_drn)
        if head.kind == KIND_DELIVER:
            dags, qt, fires, deliver, live, pm = _deliver_round(
                dags, qt, fires, next_uniform(), t, qv, qkind, qsrc, qdst, islot, horizon,
                fire_cap, part_mask, part_t0, part_t1, drop, nbr_idx, nbr_valid, impl, faults)
        else:
            deliver = live = torch.zeros((n, n), dtype=torch.bool, device=qt.device)
            pm = _partition_mask(t, part_mask, part_t0, part_t1)
        svc = live | (drain & pm)
        sched = deliver | drain
        accr = torch.where(svc, (t - last_srv) * bw_bytes, 0.0)
        if faults is None:
            sat = chunk_kernel.chunk_dedup(bstate.have, digest)
            bstate, pending = bank_lib.chunk_step(dags, bstate, digest, sat, sat, svc, accr,
                                                  chunk_bytes, return_pending=True)
        else:
            bstate, fstate, pending = faults.service(dags, bstate, fstate, digest, svc, accr,
                                                     chunk_bytes, batch=done)
        last_srv = torch.where(sched, t, last_srv)
        t_next = float(np.nextafter(np.float32(t), np.float32(np.inf)))
        e_next = torch.clamp(t + (chunk_bytes - bstate.credit) / rate, min=t_next)[qdst, qsrc]
        e_retry = torch.clamp(t + chunk_time, min=t_next)[qdst, qsrc]
        e_svc = svc[qdst, qsrc]
        e_pend = pending[qdst, qsrc]
        qv = torch.where(is_drn & e_svc, e_pend, qv)
        qt = torch.where(is_drn & e_svc, torch.where(e_pend, e_next, torch.inf), qt)
        qt = torch.where(batch & is_drn & ~e_svc, e_retry, qt)
        if observe is not None:
            observe(t, old_dags, dags, live, old_bstate, bstate, old_fstate, fstate,
                    **_serve_sample(serve, sstate))
        done += 1
    return dags, bstate, fstate, last_srv, qt, qv, done, sstate


# ---------------------------------------------------------------------------
# Engine B: the §IV in-system simulation — Eq. (4) inside the full overlay
# ---------------------------------------------------------------------------


class InSystemTrace(NamedTuple):
    """Trace of the in-system tip process (one sample per publish event).

    ``tips`` counts tips of the UNION view (the paper's omniscient external
    agent E) under the ``tip_mask`` rule Algorithm 2 samples from;
    ``staleness`` is the worst per-replica row lag behind that union at the
    same instants. ``union`` is the final union ledger; ``overflow`` counts
    dropped work (pending or trace capacity). ``trace`` holds the drained
    PUBLISH/COMMIT records of a ``record_trace=True`` run.
    """

    times: np.ndarray       # (P,) f64 publish instants
    tips: np.ndarray        # (P,) f64 union tip count after each publish
    staleness: np.ndarray   # (P,) f64 max rows any replica lags the union
    published: int          # transactions published (excl. genesis)
    overflow: int
    union: Optional[DagState]
    trace: Optional[dict] = None
    trace_dropped: int = 0

    def tail_mean(self, frac: float = 0.5) -> float:
        return stability_lib.tail_mean(self.tips, frac)

    def to_report(self):
        """This trace in the shared ``repro_torch.obs`` format: an
        ``ObsReport`` whose series are the per-publish ``t``/``tips``/
        ``staleness`` samples and whose trace is the PUBLISH/COMMIT record
        set (empty without ``record_trace``), so the JSONL and Chrome-trace
        writers work on tip-simulation runs. Needs the run's ``union`` (the
        node count is read from it) and raises ``ValueError`` without it."""
        from repro_torch.obs.export import ObsReport

        if self.union is None:
            raise ValueError("to_report needs the run's union ledger (InSystemTrace.union)")
        pub = self.union.publisher.cpu().numpy()
        occ = pub >= 0
        # genesis is published by the virtual node N: the largest occupied
        # publisher id is the node count until ring reuse overwrites the
        # genesis row (then N - 1), the reference's rule
        n = int(pub[occ].max()) if occ.any() else 0
        trace = self.trace if self.trace is not None else {
            "t": np.zeros((0,), np.float64),
            "kind": np.zeros((0,), np.int32),
            "src": np.zeros((0,), np.int32),
            "dst": np.zeros((0,), np.int32),
            "arg": np.zeros((0,), np.float64),
        }
        return ObsReport(
            num_nodes=n,
            engine="insystem",
            rounds=int(self.published),
            series={
                "t": np.asarray(self.times, np.float64),
                "tips": np.asarray(self.tips, np.float64),
                "staleness": np.asarray(self.staleness, np.float64),
            },
            rows_merged=np.zeros((n,), np.int64),
            link_bytes=np.zeros((n, n), np.float64),
            samples_dropped=int(self.overflow),
            trace=trace,
            trace_dropped=int(self.trace_dropped),
            final={"published": float(self.published)},
        )


TipDraw = Callable[[str, int], object]


def torch_tip_draw(seed: int, num_nodes: int, capacity: int, device) -> TipDraw:
    """The in-system simulation's draws from one ``torch.Generator`` on
    ``device``, consumed in call order. ``draw(what, index)``, ``index``
    the call's place in the run's one sequence of draws:

      ``"first"``  () f32 standard exponential (the first arrival, over λ);
      ``"start"``  (node () int64 in [0, N), (capacity,) f32 tip uniform in
                   [1e-9, 1), () f32 standard exponential gap);
      ``"edges"``  (N, N) f32 edge uniform in [0, 1).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def exponential():
        return torch.empty((), device=device).exponential_(generator=gen)

    def draw(what: str, index: int):
        if what == "edges":
            return torch.rand((num_nodes, num_nodes), generator=gen, device=device)
        if what == "first":
            return exponential()
        node = torch.randint(0, num_nodes, (), generator=gen, device=device)
        u = torch.rand((capacity,), generator=gen, device=device)
        return node, torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9), exponential()

    return draw


def _gather_replica(dags: DagState, node: torch.Tensor) -> DagState:
    """Replica ``node`` ((1,) long on the device) as copies, with no host read."""
    return DagState(*(x.index_select(0, node)[0] for x in dags))


def simulate_insystem_tips(
    top: Topology,
    h,                              # per-node Eq. (7) delay: (N,) or scalar
    arrival_rate: float,            # lambda — global Poisson iteration rate
    k: int,                         # approvals per transaction
    tau_max: float,
    horizon: float,
    capacity: int = 256,
    seed: int = 0,
    sync_period: float = 1.0,       # cadence for zero-latency links
    impl: str = "fused",
    partition=None,                 # Optional[gossip.PartitionSchedule]
    max_pending: int = 64,
    trace_cap: Optional[int] = None,
    record_trace: bool = False,
    device="cuda",
    draw: Optional[TipDraw] = None,
) -> InSystemTrace:
    """Measure the Eq. (4) tip process INSIDE the full gossip system.

    Per-node DAG replicas synced by the continuous-time engine: a START
    picks a node (uniform: the paper's global Poisson arrival), reserves k
    tips from that node's LOCAL replica view (Gumbel top-k) and schedules
    its PUBLISH ``h_i`` seconds out in the first free pending slot (none
    free: the iteration is dropped and counted in ``overflow``); a PUBLISH
    lands the transaction at the globally sequenced row of the publisher's
    replica, credits the reserved approvals and samples the union tip count
    and the worst replica lag. Deliveries batch as in engine A and never
    elide. ``draw`` replaces the default draws (``torch_tip_draw``).

    Runs on ``device`` (CUDA unless asked for the CPU). ``record_trace=True``
    also keeps a device trace ring of ``2 * trace_cap + 8`` records: a
    PUBLISH record (arg = h of the node) for each started iteration that
    found a pending slot and a COMMIT record (arg = the global sequence) for
    each landed transaction, drained into ``InSystemTrace.trace``.
    """
    from repro_torch.device import resolve_device

    if sync_period <= 0:
        raise ValueError("in-system tip sim needs a positive sync_period")
    if max_pending < 1:
        raise ValueError(f"need max_pending >= 1, got {max_pending}")
    dev = resolve_device(device)
    n = top.num_nodes
    h = torch.from_numpy(np.array(np.broadcast_to(np.asarray(h, np.float32), (n,)))).to(dev)
    dag = dag_lib.empty_dag(capacity, k, n + 1, device=dev)
    dag = dag_lib.publish(
        dag, torch.tensor(n, dtype=torch.int32, device=dev), torch.zeros((), device=dev),
        torch.full((k,), dag_lib.NO_TX, dtype=torch.int32, device=dev), 0.5, 0.0,
        torch.zeros((), dtype=torch.int32, device=dev))
    dags = replica_lib.stack(dag, n)
    if draw is None:
        draw = torch_tip_draw(seed, n, capacity, dev)

    base, islot_e = make_edge_queue(top, sync_period, device=dev)
    e = int(base.time.shape[0])
    p = int(max_pending)
    start_slot = e + p
    qt = torch.cat([base.time, torch.full((p + 1,), torch.inf, device=dev)])
    qkind = torch.cat([base.kind, torch.full((p,), KIND_PUBLISH, dtype=torch.int32, device=dev),
                       torch.full((1,), KIND_START, dtype=torch.int32, device=dev)])
    qsrc = torch.cat([base.src, torch.zeros((p + 1,), dtype=torch.int32, device=dev)]).long()
    qd = torch.cat([base.dst, torch.zeros((p + 1,), dtype=torch.int32, device=dev)]).long()
    qseq = torch.arange(e + p + 1, dtype=torch.int32, device=dev)
    qv = torch.cat([base.valid, torch.zeros((p,), dtype=torch.bool, device=dev),
                    torch.ones((1,), dtype=torch.bool, device=dev)])
    islot = torch.cat([islot_e, torch.zeros((p + 1,), device=dev)])
    pend = torch.full((e + p + 1, k), dag_lib.NO_TX, dtype=torch.int32, device=dev)

    if trace_cap is None:
        trace_cap = int(horizon * arrival_rate * 3) + 64
    trace_t = torch.zeros((trace_cap,), device=dev)
    trace_tips = torch.zeros((trace_cap,), device=dev)
    trace_stale = torch.zeros((trace_cap,), device=dev)

    iv = delivery_intervals(top, sync_period)
    deliveries = float((horizon / iv[top.adjacency]).sum()) if top.adjacency.any() else 0.0
    limit = int(min(deliveries + 4.0 * horizon * arrival_rate + p + 1024, 2.0 ** 31 - 1))
    if partition is not None:
        part_mask = torch.from_numpy(partition_matrix(partition.assignment)).to(dev)
        pt0, pt1 = float(np.float32(partition.t_start)), float(np.float32(partition.t_end))
    else:
        part_mask = torch.ones((n, n), dtype=torch.bool, device=dev)
        pt0, pt1 = float("inf"), float("-inf")
    nbr_idx, nbr_valid = (torch.from_numpy(x).to(dev) for x in neighbor_table(top.adjacency))
    drop = torch.from_numpy(np.asarray(top.drop, np.float32)).to(dev)
    rate = torch.full((), arrival_rate, dtype=torch.float32, device=dev)
    horizon = float(np.float32(horizon))
    no_fires = torch.zeros_like(qseq)
    # accuracy and auth tag of every publish, made on the device once (a
    # Python scalar would be copied to the card each time, and wait for it)
    accuracy = torch.full((), 0.5, device=dev)
    auth_tag = torch.zeros((), device=dev)

    ring = obs_trace.init_trace(2 * trace_cap + 8, dev) if record_trace else None

    def self_edge(node):        # (N, N) one-hot mask of node's own edge, on the device
        ids = torch.arange(n, device=dev)
        return (ids[:, None] == node) & (ids[None, :] == node)

    draws = 0

    def next_draw(what):
        nonlocal draws
        draws += 1
        return draw(what, draws - 1)

    qt[start_slot] = next_draw("first") / rate
    seqc, cur, dropped = 1, 0, 0
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    done = 0
    while done < limit:
        head = _pop_head(qt, qkind, qseq, qv, horizon)
        if head is None:
            break
        idx, t = head.idx, head.t
        if head.kind == KIND_DELIVER:
            # fire_cap = int32 max: the tip sim never elides (the horizon is one advance)
            dags, qt, _f, _dlv, _live, _pm = _deliver_round(
                dags, qt, no_fires, next_draw("edges"), t, qv, qkind, qsrc, qd, islot, horizon,
                _INT32_MAX, part_mask, pt0, pt1, drop, nbr_idx, nbr_valid, impl)
        elif head.kind == KIND_PUBLISH:
            node = qd[idx:idx + 1]
            dag_i = _gather_replica(dags, node)
            row, new_count = replica_lib.global_row(dag_i, seqc)
            dag_i = dag_lib.publish_at(dag_i, row, new_count, node, head.time, pend[idx],
                                       accuracy, auth_tag, row)
            for x, v in zip(dags, dag_i):
                x.index_copy_(0, node, v[None])
            qv[idx] = False
            qt[idx] = torch.inf
            union = replica_lib.merge_all(dags)
            slot = min(cur, trace_cap - 1)
            trace_t[slot] = t
            trace_tips[slot] = dag_lib.num_tips(union, head.time, tau_max).float()
            trace_stale[slot] = replica_lib.missing_vs_union(dags, union).max().float()
            dropped += int(cur >= trace_cap)
            cur = min(cur + 1, trace_cap)
            if ring is not None:
                obs_trace.append_edges(ring, head.time, obs_trace.KIND_COMMIT, self_edge(node),
                                       float(seqc))
            seqc += 1
        else:
            node, u, gap = next_draw("start")
            node = node.reshape(1).long()
            dag_i = _gather_replica(dags, node)
            rows, _nv = dag_lib.select_tips(dag_i, u, k, head.time, tau_max)
            free = torch.argmin(qv[e:e + p].to(torch.int32))       # first invalid slot
            slot = (e + free).reshape(1)
            has = ~qv[slot]
            qv[slot] = has | qv[slot]
            qt[slot] = torch.where(has, t + h[node], qt[slot])
            qd[slot] = torch.where(has, node, qd[slot])
            pend[slot] = torch.where(has[:, None], rows[None], pend[slot])
            qt[start_slot] = t + gap / rate
            ovf += (~has).to(torch.int32).sum()
            if ring is not None:
                # an iteration dropped for want of a pending slot never publishes
                obs_trace.append_edges(ring, head.time, obs_trace.KIND_PUBLISH,
                                       self_edge(node) & has, h[node])
        done += 1

    union = replica_lib.merge_all(dags)
    return InSystemTrace(
        times=trace_t[:cur].cpu().numpy().astype(np.float64),
        tips=trace_tips[:cur].cpu().numpy().astype(np.float64),
        staleness=trace_stale[:cur].cpu().numpy().astype(np.float64),
        published=seqc - 1,
        overflow=int(ovf) + dropped,
        union=union,
        trace=obs_trace.drain(ring) if ring is not None else None,
        trace_dropped=int(ring.dropped) if ring is not None else 0,
    )
