"""Poisson inference load served from availability-gated bank views (port of
``repro.net.serve``).

The paper's deployment story (§III, Algorithm 2): on-device nodes keep using
their local model while consensus proceeds, so training never blocks serving
and serving never waits for global sync. This module puts that load on the
continuous-time event engine (``repro_torch.net.events``):

  arrivals   each node receives inference requests as an independent
             Poisson process at ``ServeConfig.rate`` requests/s. Its gaps
             come from one ``ServeDraw`` (unit exponentials indexed by node
             and arrival count), never from the edge or fault draws, so a
             serving run makes the serve-free run's edge and fault draws.
  service    a fixed-slot batching model per node: an idle node admits up
             to ``slots`` queued requests as one batch and completes them
             ``service_time`` seconds later; requests arriving past
             ``queue_cap`` waiting are counted dropped.
  staleness  at every admit instant the node's availability-gated view is
             measured against the union ledger: with the bank gossiped a
             row whose chunks have not arrived counts as missing
             (``bank.gate_views``), so the lag a request sees is the
             transport's doing.

Event mechanics: ``extend_queue`` appends 2N ``KIND_INFER`` slots to the
edge queue — N arrival slots (self-rescheduling, like delivery edges) and N
batch-completion slots (armed at admit, disarmed at completion). INFER sorts
after every transport kind at an equal instant, so a same-instant delivery
batch runs first and the request is served from the post-merge view.

Draws. The reference folds a salted key per (node, count) and draws
``jax.random.exponential`` from it; PyTorch cannot reproduce threefry, so the
draws go through ``serve_draw(counts) -> (N,) f32`` unit exponentials, entry
i being node i's ``counts[i]``-th gap before the division by ``rate``. The
default, ``torch_serve_draw``, is counter-based: a pure function of (seed,
salt, node, count) made on the device from an integer hash and a lookup in
a host-made table, the same values on the CPU and on a card, with no
generator state and no host sync. The tests pass the reference's draws.

Arithmetic. The reference's engine rescheduling runs jitted, where XLA turns
the division by the constant ``rate`` into a product with its f32
reciprocal and fuses it with the add of the instant: the next arrival is
one fused multiply-add ``t + e * f32(1 / rate)``. Its first gaps
(``extend_queue``) and its host replay (``arrival_times``) run eagerly and
divide. The port follows each site: ``infer_step`` forms the exact f64
product and sum and rounds once to f32 (``obs.hist._fma``'s emulation), the
other two divide by a tensor (a Python scalar divisor is itself a
reciprocal product in PyTorch).

Degenerate limit: ``serve_key`` maps ``None`` and every ``rate <= 0`` config
to ``None``, under which ``GossipNetwork`` builds no INFER slot and runs the
literal serve-free loops: the run is bitwise the serve-free one.

Entry points: ``GossipNetwork(serve_cfg=ServeConfig(...))`` ->
``serve_report()``; ``run_dagfl_gossip(serve=...)`` ->
``extras["serve_report"]``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.net import bank as bank_lib
from repro_torch.net import replica as replica_lib

_SALT_SERVE = 13

ServeDraw = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Inference-load knobs.

    ``rate``             Poisson request arrivals per node per second;
                         ``rate <= 0`` serves nothing (``serve_key`` maps it
                         to ``None``).
    ``slots``            batch slots per node: an idle node admits up to
                         this many queued requests as one batch.
    ``service_time``     seconds one batch takes.
    ``queue_cap``        waiting requests a node buffers; arrivals past it
                         are counted in ``ServeState.dropped``.
    ``sample_capacity``  staleness-at-admit samples kept (the first K).
    ``salt``             the serve draws' salt.
    """

    rate: float = 1.0
    slots: int = 4
    service_time: float = 0.05
    queue_cap: int = 64
    sample_capacity: int = 4096
    salt: int = _SALT_SERVE


def serve_key(cfg: Optional[ServeConfig]) -> Optional[ServeConfig]:
    """The effective config: ``None`` for every config that serves nothing."""
    if cfg is None or cfg.rate <= 0:
        return None
    return cfg


def validate_serve(cfg: ServeConfig, engine: str, mesh=None) -> None:
    """Reject configs the event machinery cannot honour (effective configs
    only: ``None`` and rate 0 change nothing and are valid anywhere)."""
    if engine != "events":
        raise ValueError(
            "serve_cfg needs the continuous-time engine — construct with "
            "GossipConfig(engine='events') (Poisson arrivals have no tick "
            "grid to quantize onto)")
    if mesh is not None:
        raise NotImplementedError("inference serving on a mesh is not ported yet (ROADMAP A.12)")
    if cfg.slots < 1:
        raise ValueError("ServeConfig.slots must be >= 1")
    if cfg.queue_cap < 1:
        raise ValueError("ServeConfig.queue_cap must be >= 1")
    if cfg.service_time <= 0:
        raise ValueError("ServeConfig.service_time must be > 0")


class ServeState(NamedTuple):
    """Per-node serving counters and the staleness-at-admit samples, on the
    device.

    Counters are (N,) int32. The sample columns keep the first K admits
    (K = ``ServeConfig.sample_capacity``) and hold one slot more: admits
    past K write that last slot, which no reader sees, and count in
    ``sdropped``. The sample columns are written in place.
    """

    queued: torch.Tensor     # (N,) i32 requests waiting
    inflight: torch.Tensor   # (N,) i32 requests in the current batch
    served: torch.Tensor     # (N,) i32 requests completed
    arrivals: torch.Tensor   # (N,) i32 requests arrived (also the draws' counter)
    dropped: torch.Tensor    # (N,) i32 arrivals past queue_cap
    batches: torch.Tensor    # (N,) i32 batches admitted
    st: torch.Tensor         # (K + 1,) f32 admit instants
    snode: torch.Tensor      # (K + 1,) i32 admitting node (-1: none)
    sstale: torch.Tensor     # (K + 1,) i32 gated staleness at admit (-1: none)
    cursor: torch.Tensor     # () i32 samples attempted (monotone)
    sdropped: torch.Tensor   # () i32 samples past capacity


def init_serve_state(num_nodes: int, cfg: ServeConfig, device=None) -> ServeState:
    n, k = int(num_nodes), int(cfg.sample_capacity)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ServeState(
        queued=zeros(n), inflight=zeros(n), served=zeros(n), arrivals=zeros(n),
        dropped=zeros(n), batches=zeros(n), st=zeros(k + 1, dtype=torch.float32),
        snode=torch.full((k + 1,), -1, dtype=torch.int32, device=device),
        sstale=torch.full((k + 1,), -1, dtype=torch.int32, device=device),
        cursor=zeros(), sdropped=zeros())


# ---------------------------------------------------------------------------
# The draws: counter-based unit exponentials
# ---------------------------------------------------------------------------


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for 32-bit values held in int64 (tensors or ints),
    in 16-bit halves of ``c`` so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (the "lowbias32" finaliser), tensors or ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


_TABLE_BITS = 16


@functools.lru_cache(maxsize=None)
def _exponential_table(device: torch.device) -> torch.Tensor:
    """(2**16,) f32 ``-log((k + 0.5) / 2**16)``: the unit exponential at the
    midpoint of each of 2**16 equal slices of (0, 1), made on the host once
    (the same bits on every device)."""
    k = np.arange(1 << _TABLE_BITS, dtype=np.float64)
    return torch.from_numpy(-np.log((k + 0.5) / (1 << _TABLE_BITS))).float().to(device)


def torch_serve_draw(seed: int, salt: int, num_nodes: int, device) -> ServeDraw:
    """The default draws: entry i of ``draw(counts)`` hashes (seed, salt, i,
    counts[i]) to 32 bits on ``device`` and looks its top 16 bits up in a
    table of unit exponentials (so a gap lies on one of 2**16 values between
    7.6e-6 and 11.8). Integer operations and one gather: every device gives
    the same f32 values, about a dozen launches a call."""
    key = _mix32(_mix32(seed & _M32) ^ _mul32(salt & _M32, 0x9E3779B9))
    node_key = _mix32(torch.arange(num_nodes, dtype=torch.int64, device=device) ^ key)
    table = _exponential_table(torch.device(device))

    def draw(counts: torch.Tensor) -> torch.Tensor:
        x = _mix32((node_key + _mul32(counts.to(torch.int64) & _M32, 0x9E3779B9)) & _M32)
        return table[x >> (32 - _TABLE_BITS)]

    return draw


def _rate_tensor(cfg: ServeConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, cfg.rate)


def arrival_times(seed: int, cfg: ServeConfig, node: int, horizon: float,
                  serve_draw: Optional[ServeDraw] = None) -> np.ndarray:
    """Host replay of one node's arrival instants up to ``horizon``: the
    reference's f32 accumulation ``t = f32(t + gap)``, each gap a true f32
    division by ``rate`` (equal instants included). ``serve_draw`` is the
    network's draw (default ``torch_serve_draw`` on the CPU)."""
    if serve_draw is None:
        serve_draw = torch_serve_draw(seed, cfg.salt, node + 1, "cpu")
    t = np.float32(0.0)
    out, count = [], 0
    counts = torch.zeros((node + 1,), dtype=torch.int32)
    while True:
        counts[node] = count
        e = serve_draw(counts)[node:node + 1].cpu()
        gap = np.float32((e / _rate_tensor(cfg, e)).item())
        t = np.float32(t + gap)
        if float(t) > horizon:
            return np.asarray(out, np.float64)
        out.append(float(t))
        count += 1


# ---------------------------------------------------------------------------
# Queue extension: 2N perpetual KIND_INFER slots
# ---------------------------------------------------------------------------


def extend_queue(queue, islot: torch.Tensor, num_nodes: int, cfg: ServeConfig,
                 serve_draw: ServeDraw):
    """Append the serve slots to an edge queue built by
    ``events.make_edge_queue``.

    Slot ``infer_base + i`` is node i's arrival slot (valid, first firing at
    its count-0 gap); slot ``infer_base + N + i`` its batch-completion slot
    (invalid until a batch admits). ``seq`` becomes ``arange`` over the whole
    queue and ``islot`` gains zeros. Returns ``(EventQueue, islot,
    infer_base)``.
    """
    from repro_torch.net.events import KIND_INFER, EventQueue

    n = int(num_nodes)
    dev = queue.time.device
    e = serve_draw(torch.zeros((n,), dtype=torch.int32, device=dev))
    first = e / _rate_tensor(cfg, e)
    infer_base = int(queue.time.shape[0])
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ext = EventQueue(
        time=torch.cat([queue.time, first, torch.full((n,), torch.inf, device=dev)]),
        kind=torch.cat([queue.kind, torch.full((2 * n,), KIND_INFER, dtype=torch.int32,
                                               device=dev)]),
        src=torch.cat([queue.src, ids, ids]),
        dst=torch.cat([queue.dst, ids, ids]),
        seq=torch.arange(infer_base + 2 * n, dtype=torch.int32, device=dev),
        valid=torch.cat([queue.valid, torch.ones((n,), dtype=torch.bool, device=dev),
                         torch.zeros((n,), dtype=torch.bool, device=dev)]),
    )
    islot = torch.cat([islot, torch.zeros((2 * n,), dtype=torch.float32, device=dev)])
    return ext, islot, infer_base


# ---------------------------------------------------------------------------
# The INFER batch step
# ---------------------------------------------------------------------------


def gated_staleness(dags, sat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) i32 — rows each node's usable view lacks against the union ledger:
    plain replica staleness without the bank (``sat=None``), else against
    the view gated by the availability ``sat`` (R, S, C). The union's row
    identities are ``merge_all``'s (``replica.union_keys``)."""
    union = replica_lib.union_keys(dags)
    if sat is None:
        return replica_lib.missing_vs_union(dags, union)
    return replica_lib.missing_vs_union(bank_lib.gate_views(dags, sat), union)


def infer_step(cfg: ServeConfig, sstate: ServeState, t: float, qt: torch.Tensor,
               qv: torch.Tensor, infer_base: int, serve_draw: ServeDraw,
               recip: float, stale_now: torch.Tensor):
    """Process every INFER event firing at the f32 instant ``t`` of a queue
    that ``extend_queue`` built, with no host sync.

    Within the instant: completions land (inflight -> served, the server
    idles), arrivals enqueue (or drop past ``queue_cap``), then every idle
    node with waiting work admits a batch of up to ``slots``, sampling its
    gated staleness ``stale_now`` into the first-K buffer. A fired arrival
    slot moves to the node's next gap (``serve_draw`` of the post-increment
    count times ``recip``, the f32 reciprocal of ``rate``, added to ``t`` as
    one fused multiply-add); a touched
    node's completion slot arms at ``t + service_time`` if it admitted,
    else disarms. The queue's transport slots are left as they were: only
    INFER slots fire here.

    Returns ``(sstate, qt, qv, admitted (N,) bool, batch_now (N,) i32)``.
    """
    n = stale_now.shape[0]
    ib = int(infer_base)
    fired = qv[ib:] & (qt[ib:] == t)
    arr_fire, cmp_fire = fired[:n], fired[n:]

    # completions first: the batch finishes, the server idles
    served = sstate.served + torch.where(cmp_fire, sstate.inflight, 0)
    inflight = torch.where(cmp_fire, 0, sstate.inflight)
    # arrivals: count every one (the count also indexes the draws),
    # enqueue while there is room, drop past the cap
    arrivals = sstate.arrivals + arr_fire.to(torch.int32)
    room = sstate.queued < cfg.queue_cap
    queued = sstate.queued + (arr_fire & room).to(torch.int32)
    dropped = sstate.dropped + (arr_fire & ~room).to(torch.int32)
    # admission: idle with a backlog -> start a batch at this instant
    can = (inflight == 0) & (queued > 0)
    batch_now = torch.where(can, torch.clamp(queued, max=cfg.slots), 0)
    inflight = inflight + batch_now
    queued = queued - batch_now
    batches = sstate.batches + can.to(torch.int32)

    # staleness-at-admit samples: prefix-sum slots, first K, the rest to the
    # spare slot
    cap = sstate.st.shape[0] - 1
    fi = can.to(torch.int32)
    idx = sstate.cursor + (torch.cumsum(fi, 0, dtype=torch.int32) - fi)
    slot = torch.where(can & (idx < cap), idx, cap).long()
    dev = qt.device
    sstate.st.index_put_((slot,), torch.full((n,), t, dtype=torch.float32, device=dev))
    sstate.snode.index_put_((slot,), torch.arange(n, dtype=torch.int32, device=dev))
    sstate.sstale.index_put_((slot,), stale_now.to(torch.int32))
    cursor = sstate.cursor + fi.sum(dtype=torch.int32)
    sdropped = sstate.sdropped + (fi * (idx >= cap).to(torch.int32)).sum(dtype=torch.int32)

    # reschedule fired arrival slots at the next per-(node, count) gap
    # the f64 product of two f32 values is exact: one rounding, as the FMA
    next_arr = (serve_draw(arrivals).double() * recip + t).float()
    t_arr = torch.where(arr_fire, next_arr, qt[ib:ib + n])
    # completion slots: arm at t + service_time when a batch admitted,
    # disarm when the node went idle; untouched nodes keep their schedule
    touched = cmp_fire | can
    t_done = float(np.float32(t) + np.float32(cfg.service_time))
    t_cmp = torch.where(touched, torch.where(can, t_done, torch.inf), qt[ib + n:])
    v_cmp = torch.where(touched, can, qv[ib + n:])
    qt = torch.cat([qt[:ib], t_arr, t_cmp])
    qv = torch.cat([qv[:ib + n], v_cmp])
    out = ServeState(queued=queued, inflight=inflight, served=served, arrivals=arrivals,
                     dropped=dropped, batches=batches, st=sstate.st, snode=sstate.snode,
                     sstale=sstate.sstale, cursor=cursor, sdropped=sdropped)
    return out, qt, qv, can, batch_now


class ServeLayer:
    """A ``ServeConfig`` bound to one network's queue: its draw, the f32
    reciprocal of ``rate`` and the first INFER slot. The event advances call
    ``step`` on an INFER head."""

    def __init__(self, cfg: ServeConfig, serve_draw: ServeDraw, infer_base: int):
        self.cfg, self.draw, self.infer_base = cfg, serve_draw, int(infer_base)
        self.recip = float(np.float32(1.0) / np.float32(cfg.rate))

    def step(self, sstate: ServeState, t: float, qt, qv, stale_now):
        """``infer_step`` at instant ``t``, plus the max gated staleness any
        admitted batch saw (() i32, -1 when none admitted): the series'
        sample."""
        sstate, qt, qv, admitted, batch_now = infer_step(
            self.cfg, sstate, t, qt, qv, self.infer_base, self.draw, self.recip, stale_now)
        s_now = torch.where(admitted, stale_now, -1).max().to(torch.int32)
        return sstate, qt, qv, admitted, batch_now, s_now


def observed(old: ServeState, new: ServeState, admitted, batch_now, s_now,
             stale_now) -> dict:
    """An INFER batch's arguments to ``obs.observe_round``: the served
    counters and the sampled staleness (series), the admitting nodes and
    their batch sizes (INFER trace records), and the enqueued arrivals, the
    queue after admission and the per-node staleness (histograms)."""
    return dict(serve_counts=new.served, serve_stale=s_now, infer_nodes=admitted,
                infer_arg=batch_now, serve_enq=new.queued - old.queued + batch_now,
                serve_queued=new.queued, serve_stale_node=stale_now)


# ---------------------------------------------------------------------------
# Host-side report
# ---------------------------------------------------------------------------


def report(sstate: ServeState, cfg: ServeConfig) -> dict:
    """The serve counters on the host (the run's one read back of them).

    ``staleness_p50`` / ``staleness_p99`` are percentiles over the samples
    kept (NaN with no batch); the per-node arrays carry the served,
    arrived, dropped and batch accounting.
    """
    s = ServeState(*(x.cpu().numpy() for x in sstate))
    served = s.served.astype(np.int64)
    k = int(min(int(s.cursor), s.sstale.shape[0] - 1))
    stale = s.sstale.astype(np.int64)[:k]
    arrivals = s.arrivals.astype(np.int64)
    dropped = s.dropped.astype(np.int64)
    return {
        "rate": float(cfg.rate),
        "slots": int(cfg.slots),
        "service_time": float(cfg.service_time),
        "requests_served": served,
        "served_total": int(served.sum()),
        "arrivals": arrivals,
        "arrived_total": int(arrivals.sum()),
        "queued": s.queued.astype(np.int64),
        "inflight": s.inflight.astype(np.int64),
        "dropped": dropped,
        "dropped_total": int(dropped.sum()),
        "batches": s.batches.astype(np.int64),
        "samples": k,
        "samples_dropped": int(s.sdropped),
        "staleness_t": s.st.astype(np.float64)[:k],
        "staleness_node": s.snode.astype(np.int64)[:k],
        "staleness_samples": stale,
        "staleness_p50": float(np.percentile(stale, 50)) if k else float("nan"),
        "staleness_p99": float(np.percentile(stale, 99)) if k else float("nan"),
        "staleness_max": int(stale.max()) if k else 0,
    }
