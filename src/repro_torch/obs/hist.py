"""Streaming histograms for the gossip overlay (port of ``repro.obs.hist``).

The fixed-capacity series in ``repro_torch.obs.metrics`` keep the FIRST
``series_capacity`` samples; the paper's §IV claims (confirmation delays,
iteration delays) are statements about percentiles over every sample. This
module keeps fixed log-spaced bins of i32 counts on the device that never
drop a sample (values out of range fold into the first or the overflow bin).
They live in ``MetricsState.hist`` and ``observe_round`` updates them when
``ObsConfig.hist`` is set.

Bin layout (``bins`` regular bins + 1 overflow, counts of shape (bins+1,)):

  bin 0          v <= edges[1]           (underflow folds in)
  bin i          edges[i] < v <= edges[i+1]   for 1 <= i < bins
  bin ``bins``   v > edges[bins] = hi    (overflow)

with ``edges[i] = lo * (hi/lo)**(i/bins)``; a percentile is reported as its
bin's upper edge with the bin width as its error bound.

Histograms (all in one ``HistState``):

  ``merge_lat``    each (replica, row) whose row identity (publisher,
                   publish_time) changed in a round samples ``t -
                   publish_time``;
  ``commit_lat``   each row samples ``t - publish_time`` once, at the first
                   instant every replica agrees on its identity (``all_have``
                   latches what was already propagated);
  ``chunk_lat``    bank transport: each chunk newly held samples ``t -
                   publish_time`` of the receiver's row for the slot (weight
                   = chunks completed; a slot whose row has not merged skips);
  ``queue_wait``   per-request admission wait of the serving layer, from an
                   arrival-instant FIFO per node (``qwait_t``/``qwait_head``);
  ``serve_stale``  per-request staleness at serve (weight = batch size).

Binning. ``bin_index`` is the reference's ``ceil(log(v / lo) / ratio) - 1``
in f32. A latency of exactly 1.0 s lies on edge 32 of the default bins, and
an ulp of ``log`` moves such a value one bin, so the log here is the
reference's own: ``xla_log_f32`` computes XLA's f32 logarithm on the CPU
(the Cephes polynomial, every multiply-add fused) in elementwise PyTorch,
each fused multiply-add as an exact f64 product and an f64 sum rounded to
f32 (``_fma`` says where that can differ from a fused result). It runs as
the same IEEE operations on the CPU and on a card, so both give the same
bins.

Collection is a pure read of the simulation state: the round bodies are
functional, so the pre-round replicas are the loop's own, and nothing here
writes them. On a card ``record`` (binning, bincount and add) is one launch
of the CUDA kernel of ``repro_torch.kernels.hist_bincount``, which bins as
``bin_index`` does, bit for bit; on the CPU it is ``record_plain``, those
three steps in PyTorch. Unlike the reference's, ``HistConfig`` has no
``impl``, because the device of the counts already makes that choice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.dag import DagState
from repro_torch.kernels import hist_bincount as bincount_kernel

HIST_NAMES = ("merge_lat", "commit_lat", "chunk_lat", "queue_wait", "serve_stale")


@dataclass(frozen=True)
class HistConfig:
    """Histogram knobs: ``bins`` log-spaced bins over ``[lo, hi]`` plus one
    overflow bin."""

    bins: int = 64
    lo: float = 1e-4
    hi: float = 1e4


class HistState(NamedTuple):
    """The streaming-histogram state, on the device."""

    merge_lat: torch.Tensor    # (B+1,) i32 publish -> first-merge latency
    commit_lat: torch.Tensor   # (B+1,) i32 publish -> full propagation
    chunk_lat: torch.Tensor    # (B+1,) i32 chunk transfer-completion delay
    queue_wait: torch.Tensor   # (B+1,) i32 per-request admission wait
    serve_stale: torch.Tensor  # (B+1,) i32 per-request staleness at serve
    all_have: torch.Tensor     # (cap,) bool rows already fully propagated
    qwait_t: torch.Tensor      # (N, Q) f32 arrival-instant FIFO per node
    qwait_head: torch.Tensor   # (N,) i32 FIFO head (pops advance it mod Q)


def edges(cfg: HistConfig) -> np.ndarray:
    """(bins+1,) float64 log-spaced edges, ``edges[0]=lo .. edges[-1]=hi``."""
    b = int(cfg.bins)
    return cfg.lo * (cfg.hi / cfg.lo) ** (np.arange(b + 1) / b)


def _f32(bits: int) -> float:
    """The f32 whose bits are ``bits``, as a Python float."""
    return float(np.uint32(bits).view(np.float32))


# XLA's f32 log on the CPU: Cephes' polynomial, its constants as f32 bits
_MIN_NORMAL = _f32(0x00800000)
_SQRT_HALF = _f32(0x3F3504F3)
_P = [_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                        0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_Q1 = _f32(0xB95E8083)      # -2.12194440e-4
_Q2 = _f32(0x3F318000)      # 0.693359375


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` for f32 values held as f32 or f64 tensors or
    numbers: the f64 product of two f32 values is exact, and its f64 sum is
    then rounded to f32. That is two roundings, where a fused multiply-add
    rounds once, so a rare sum that lands halfway between two f32 values can
    differ from the fused result by an ulp. ``xla_log_f32`` equals XLA's log
    on the 85k values of ``tests/test_torch_hist.py``, which is evidence, not
    a proof; the card and the CPU run the same operations and agree always."""
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * b + c).float()


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive, normal, finite f32 ``x``, bit for bit XLA's
    f32 log on the CPU (what the reference's ``jnp.log`` computes there):
    the Cephes polynomial with every multiply-add fused, in XLA's order."""
    x = torch.clamp(x, min=_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)   # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    x1 = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = x1 * x1
    x1d, x3d = x1.double(), (x2 * x1).double()
    y1 = _fma(_fma(x1d, _P[0], _P[1]), x1d, _P[2])
    y2 = _fma(_fma(x1d, _P[3], _P[4]), x1d, _P[5])
    y3 = _fma(_fma(x1d, _P[6], _P[7]), x1d, _P[8])
    y = _fma(_fma(y1, x3d, y2), x3d, y3)
    s = _fma(y, x3d, e * _Q1)
    r = x1 - x2 * 0.5
    return _fma(e, _Q2, r + s)


def bin_params(cfg: HistConfig):
    """``(lo, ratio, bins)``: the binning's f32 constants (as Python floats)
    and its number of regular bins."""
    b = int(cfg.bins)
    return float(np.float32(cfg.lo)), float(np.float32(np.log(cfg.hi / cfg.lo) / b)), b


def bin_index(values: torch.Tensor, cfg: HistConfig) -> torch.Tensor:
    """i32 bin index in [0, bins] for each value, the reference's f32
    ``clip(ceil(log(max(v, lo) / lo) / ratio) - 1, 0, bins)``.

    ``v <= lo`` maps to 0, ``v > hi`` (+inf included) to the overflow bin, a
    NaN to 0, as the reference's saturating f32 -> i32 conversion gives them.
    """
    lo, ratio, b = bin_params(cfg)
    v = values.to(torch.float32)
    v = torch.where(torch.isnan(v), v, torch.clamp(v, min=lo))
    # divisions by tensors: a Python scalar divisor is a reciprocal multiply on a card
    q = v / torch.full_like(v, lo)
    x = xla_log_f32(torch.where(torch.isfinite(q), q, 1.0))
    x = x / torch.full_like(x, ratio)
    x = torch.where(torch.isnan(v), 0.0, torch.where(torch.isinf(q), b + 1.0, x))
    x = torch.clamp(x, max=b + 1.0)
    return (torch.ceil(x).to(torch.int32) - 1).clamp(0, b)


def record_plain(counts: torch.Tensor, values: torch.Tensor, weights: torch.Tensor,
                 cfg: HistConfig) -> torch.Tensor:
    """``record`` in PyTorch operations: ``bin_index``, the plain bincount,
    the add. The kernel's oracle and the CPU path."""
    idx = bin_index(values.reshape(-1), cfg)
    w = weights.reshape(-1).to(torch.int32)
    return counts + bincount_kernel.hist_bincount_plain(idx, w, int(cfg.bins) + 1)


def record(counts: torch.Tensor, values: torch.Tensor, weights: torch.Tensor,
           cfg: HistConfig) -> torch.Tensor:
    """``counts`` + the weighted bincount of ``values`` binned per ``cfg``: a
    fresh tensor, ``counts`` is not modified.

    ``values`` and ``weights`` flatten together; zero weights count nothing,
    which is how a masked batch keeps a fixed shape. On a card one kernel
    launch does it all (``kernels.hist_bincount.record_binned``, bitwise
    ``record_plain``); on the CPU ``record_plain``.
    """
    if counts.device.type == "cpu":
        return record_plain(counts, values, weights, cfg)
    lo, ratio, b = bin_params(cfg)
    return bincount_kernel.record_binned(counts, values.reshape(-1).to(torch.float32),
                                         weights.reshape(-1), lo, ratio, b)


def rows_propagated(dags: DagState) -> torch.Tensor:
    """(cap,) bool — rows whose identity (publisher, publish_time) every
    replica agrees on, replica 0 the reference; approval credit is not part
    of the predicate."""
    p0, t0 = dags.publisher[0], dags.publish_time[0]
    agree = ((dags.publisher == p0[None]) & (dags.publish_time == t0[None])).all(dim=0)
    return agree & (p0 >= 0)


def init_hist(cfg: HistConfig, dags: DagState, queue_cap: int = 0) -> HistState:
    """Fresh state for the stacked replicas ``dags``: ``all_have`` starts from
    the actual propagation (the genesis row is everywhere already);
    ``queue_cap`` sizes the serving FIFO (0 without serving)."""
    b = int(cfg.bins) + 1
    n = dags.publisher.shape[0]
    dev = dags.publisher.device

    def zeros():
        return torch.zeros((b,), dtype=torch.int32, device=dev)

    return HistState(
        merge_lat=zeros(), commit_lat=zeros(), chunk_lat=zeros(), queue_wait=zeros(),
        serve_stale=zeros(), all_have=rows_propagated(dags),
        qwait_t=torch.zeros((n, int(queue_cap)), dtype=torch.float32, device=dev),
        qwait_head=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def observe(
    cfg: HistConfig,
    h: HistState,
    t: torch.Tensor,                 # () f32 sample instant
    old_dags: DagState,              # stacked replicas before the round
    new_dags: DagState,              # stacked replicas after the round
    old_have: Optional[torch.Tensor] = None,        # (N, S, C) bool chunks before (bank)
    bstate=None,                                    # post-round BankState (bank runs)
    serve_enq: Optional[torch.Tensor] = None,       # (N,) i32 arrivals that found room
    serve_admit: Optional[torch.Tensor] = None,     # (N,) i32 batch sizes admitted now
    serve_queued: Optional[torch.Tensor] = None,    # (N,) i32 queue length after admission
    serve_stale_node: Optional[torch.Tensor] = None,  # (N,) i32 gated staleness per node
) -> HistState:
    """One histogram step (a pure read of its inputs); returns the new state."""
    # publish -> first merge: rows whose identity changed on some replica
    changed = ((new_dags.publisher != old_dags.publisher)
               | (new_dags.publish_time != old_dags.publish_time)) & (new_dags.publisher >= 0)
    lat = torch.clamp(t - new_dags.publish_time, min=0.0)
    merge_lat = record(h.merge_lat, lat, changed, cfg)

    # publish -> commit: the first instant all replicas agree; the latch
    # makes each row version sample once
    prop = rows_propagated(new_dags)
    newly = prop & ~h.all_have
    clat = torch.clamp(t - new_dags.publish_time[0], min=0.0)
    commit_lat = record(h.commit_lat, clat, newly, cfg)

    # chunk transfer completion, dated against the receiver's merged row
    chunk_lat = h.chunk_lat
    if bstate is not None and old_have is not None:
        arrived = (bstate.have & ~old_have).sum(dim=-1, dtype=torch.int32)    # (N, S)
        w = torch.where(new_dags.publisher >= 0, arrived, 0)
        slat = torch.clamp(t - new_dags.publish_time, min=0.0)
        chunk_lat = record(h.chunk_lat, slat, w, cfg)

    # per-request queue wait and staleness at serve: push the enqueued
    # arrivals at t, pop the admitted batch from the head
    queue_wait, serve_stale = h.queue_wait, h.serve_stale
    qwait_t, qwait_head = h.qwait_t, h.qwait_head
    qcap = qwait_t.shape[1]
    if serve_admit is not None and qcap > 0:
        n = qwait_t.shape[0]
        enq = serve_enq.to(torch.int32)
        adm = serve_admit.to(torch.int32)
        len_before = serve_queued.to(torch.int32) + adm - enq
        tail = torch.remainder(qwait_head + len_before, qcap).long()
        rows = torch.arange(n, device=qwait_t.device)
        qwait_t = qwait_t.clone()
        qwait_t[rows, tail] = torch.where(enq > 0, t, qwait_t[rows, tail])
        j = torch.arange(qcap, dtype=torch.int32, device=qwait_t.device)
        take = j[None, :] < adm[:, None]
        slots = torch.remainder(qwait_head[:, None] + j[None, :], qcap).long()
        waits = torch.clamp(t - torch.gather(qwait_t, 1, slots), min=0.0)
        queue_wait = record(queue_wait, waits, take, cfg)
        serve_stale = record(serve_stale, serve_stale_node.to(torch.float32), adm, cfg)
        qwait_head = torch.remainder(qwait_head + adm, qcap)

    return HistState(merge_lat=merge_lat, commit_lat=commit_lat, chunk_lat=chunk_lat,
                     queue_wait=queue_wait, serve_stale=serve_stale, all_have=prop,
                     qwait_t=qwait_t, qwait_head=qwait_head)


# ---------------------------------------------------------------------------
# Host-side percentiles
# ---------------------------------------------------------------------------


def percentile(counts: np.ndarray, cfg: HistConfig, q: float):
    """(value, err) — the q-th percentile with its bin-resolution bound: the
    upper edge of the bin holding the ceil(q/100 * total)-th sample, and its
    bin width (bin 0: the first edge; overflow: ``hi`` with err = inf).
    ``(nan, nan)`` on an empty histogram."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    if total == 0:
        return float("nan"), float("nan")
    rank = max(int(np.ceil(q / 100.0 * total)), 1)
    b = int(np.searchsorted(np.cumsum(counts), rank))
    e = edges(cfg)
    if b >= int(cfg.bins):
        return float(e[-1]), float("inf")
    value = float(e[b + 1])
    err = float(e[b + 1]) if b == 0 else float(e[b + 1] - e[b])
    return value, err


def summary(counts: np.ndarray, cfg: HistConfig, qs=(50.0, 95.0, 99.0)) -> dict:
    """{"samples", "p50", "p50_err", ...} for one histogram."""
    out = {"samples": int(np.asarray(counts).sum())}
    for q in qs:
        v, err = percentile(counts, cfg, q)
        key = f"p{q:g}".replace(".", "_")
        out[key] = v
        out[f"{key}_err"] = err
    return out


def report_dict(h: HistState, cfg: HistConfig) -> dict:
    """One ``HistState`` drained to a host dict for ``ObsReport.hist``."""
    counts = {name: getattr(h, name).cpu().numpy() for name in HIST_NAMES}
    return {
        "bins": int(cfg.bins),
        "lo": float(cfg.lo),
        "hi": float(cfg.hi),
        "edges": edges(cfg),
        "counts": counts,
        "percentiles": {name: summary(c, cfg) for name, c in counts.items()},
    }
