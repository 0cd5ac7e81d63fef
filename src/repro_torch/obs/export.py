"""Host-side export of drained telemetry: Chrome traces and JSONL metrics
(port of ``repro.obs.export``; the schema is ``docs/OBSERVABILITY.md``'s).

``ObsReport`` is the host-side snapshot ``GossipNetwork.obs_report()``
builds from the collectors (``repro_torch.obs.metrics`` /
``repro_torch.obs.trace``), all numpy, and what rides
``SimResult.extras["obs"]``. Two serializations:

  Chrome trace     ``chrome_trace`` / ``write_chrome_trace``: the Trace
                   Event Format JSON (``{"traceEvents": [...]}``) that
                   chrome://tracing and Perfetto load: one track (tid) per
                   node plus an "overlay" control track, iteration spans
                   from PUBLISH records (arg = duration), instantaneous
                   deliver/drain/commit slices, PARTITION begin/heal pairs
                   as spans. Timestamps are microseconds, events time-sorted.
                   With ``report.hist``, one ``"ph": "C"`` counter series per
                   non-empty histogram (``hist:<name>``): count against bin
                   index (ts = bin index, args.le = the bin's upper edge).
  JSONL metrics    one summary line (rounds, drops, dispatch counts, final
                   scalars), one ``"kind": "hist"`` line per histogram (bin
                   edges, counts, p50/p95/p99 with their bin-width bounds)
                   when histograms ran, then one line per metric sample.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import trace as trace_lib


@dataclass
class ObsReport:
    """Drained telemetry for one run (all host-side numpy)."""

    num_nodes: int
    engine: str
    rounds: int
    series: Dict[str, np.ndarray]         # t/tips/staleness/rows_delta/...
    rows_merged: np.ndarray               # (N,) per-node rows merged
    link_bytes: np.ndarray                # (N, N) payload bytes per link
    samples_dropped: int
    trace: Dict[str, np.ndarray]          # t/kind/src/dst/arg, time-sorted
    trace_dropped: int
    dispatch_counts: Dict[str, int] = field(default_factory=dict)
    final: Dict[str, float] = field(default_factory=dict)
    hist: Optional[dict] = None           # repro.obs.hist.report_dict

    @property
    def samples(self) -> int:
        return int(self.series["t"].shape[0])

    @property
    def trace_records(self) -> int:
        return int(self.trace["t"].shape[0])


_US = 1e6   # trace-event timestamps are microseconds


def chrome_trace(report: ObsReport,
                 latency: Optional[np.ndarray] = None) -> dict:
    """Trace Event Format dict for one report.

    ``latency`` (N, N) seconds, when given, back-dates each DELIVER slice
    by its link's wire time so the span covers the transfer; without it
    deliveries render as 1 us instants. Tracks: tid 0..N-1 = nodes, tid N
    = the overlay control track (partitions).
    """
    n = report.num_nodes
    events = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": f"dagfl-overlay[{report.engine}]"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": n,
         "args": {"name": "overlay"}},
    ]
    for i in range(n):
        events.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                       "args": {"name": f"node {i}"}})
    tr = report.trace
    slices = []
    part_open = None
    t_max = float(tr["t"][-1]) if len(tr["t"]) else 0.0
    for t, kind, src, dst, arg in zip(
        tr["t"], tr["kind"], tr["src"], tr["dst"], tr["arg"]
    ):
        t, kind, src, dst, arg = (
            float(t), int(kind), int(src), int(dst), float(arg)
        )
        if kind == trace_lib.KIND_DELIVER:
            dur = 0.0
            if latency is not None and 0 <= dst < n and 0 <= src < n:
                lat = float(latency[dst, src])
                dur = lat if np.isfinite(lat) else 0.0
            slices.append({
                "name": "deliver", "ph": "X", "pid": 0, "tid": dst,
                "ts": max(t - dur, 0.0) * _US, "dur": max(dur * _US, 1.0),
                "args": {"src": src, "rows": arg},
            })
        elif kind == trace_lib.KIND_DRAIN:
            slices.append({
                "name": "drain", "ph": "X", "pid": 0, "tid": dst,
                "ts": t * _US, "dur": 1.0,
                "args": {"src": src, "bytes": arg},
            })
        elif kind == trace_lib.KIND_PUBLISH:
            # arg = iteration duration: the span IS the node's h_i work
            slices.append({
                "name": "iteration", "ph": "X", "pid": 0, "tid": dst,
                "ts": t * _US, "dur": max(arg * _US, 1.0), "args": {},
            })
        elif kind == trace_lib.KIND_COMMIT:
            slices.append({
                "name": "commit", "ph": "X", "pid": 0, "tid": dst,
                "ts": t * _US, "dur": 1.0, "args": {"seq": int(arg)},
            })
        elif kind == trace_lib.KIND_REJECT:
            slices.append({
                "name": "reject", "ph": "X", "pid": 0, "tid": dst,
                "ts": t * _US, "dur": 1.0,
                "args": {"src": src, "chunks": arg},
            })
        elif kind == trace_lib.KIND_INFER:
            slices.append({
                "name": "infer", "ph": "X", "pid": 0, "tid": dst,
                "ts": t * _US, "dur": 1.0,
                "args": {"src": src, "batch": arg},
            })
        elif kind == trace_lib.KIND_PARTITION:
            if arg >= 0.5:
                part_open = t
            else:
                t0 = part_open if part_open is not None else 0.0
                part_open = None
                slices.append({
                    "name": "partition", "ph": "X", "pid": 0, "tid": n,
                    "ts": t0 * _US, "dur": max((t - t0) * _US, 1.0),
                    "args": {},
                })
    if part_open is not None:          # never healed within the horizon
        slices.append({
            "name": "partition", "ph": "X", "pid": 0, "tid": n,
            "ts": part_open * _US,
            "dur": max((t_max - part_open) * _US, 1.0), "args": {},
        })
    slices.sort(key=lambda e: e["ts"])
    counters = []
    if report.hist is not None:
        edges = report.hist["edges"]
        for hname, counts in report.hist["counts"].items():
            if int(np.asarray(counts).sum()) == 0:
                continue
            for b, c in enumerate(np.asarray(counts)):
                le = float(edges[b + 1]) if b + 1 < len(edges) else None
                counters.append({
                    "name": f"hist:{hname}", "ph": "C", "pid": 0, "tid": 0,
                    "ts": float(b),
                    "args": {"count": int(c), "le": le},
                })
    return {"traceEvents": events + slices + counters,
            "displayTimeUnit": "ms"}


def write_chrome_trace(report: ObsReport, path: str,
                       latency: Optional[np.ndarray] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(report, latency=latency), f)
    return path


def metrics_jsonl_lines(report: ObsReport) -> list:
    """Summary line + one line per metric sample (all plain JSON)."""
    lines = [json.dumps({
        "kind": "summary",
        "engine": report.engine,
        "num_nodes": report.num_nodes,
        "rounds": report.rounds,
        "samples": report.samples,
        "samples_dropped": report.samples_dropped,
        "trace_records": report.trace_records,
        "trace_dropped": report.trace_dropped,
        "dispatch_counts": report.dispatch_counts,
        "rows_merged": [int(x) for x in report.rows_merged],
        "final": {k: float(v) for k, v in report.final.items()},
    })]
    if report.hist is not None:
        for hname, counts in report.hist["counts"].items():
            lines.append(json.dumps({
                "kind": "hist",
                "name": hname,
                "bins": report.hist["bins"],
                "lo": report.hist["lo"],
                "hi": report.hist["hi"],
                "edges": [float(x) for x in report.hist["edges"]],
                "counts": [int(x) for x in counts],
                **{k: (v if np.isfinite(v) else None)
                   if isinstance(v, float) else v
                   for k, v in report.hist["percentiles"][hname].items()},
            }))
    keys = [k for k in report.series if k != "t"]
    for i, t in enumerate(report.series["t"]):
        row = {"kind": "sample", "t": float(t)}
        for k in keys:
            v = report.series[k][i]
            # vector-valued series (e.g. per-node staleness) emit a list
            row[k] = (float(v) if np.ndim(v) == 0
                      else [float(x) for x in np.ravel(v)])
        lines.append(json.dumps(row))
    return lines


def write_metrics_jsonl(report: ObsReport, path: str) -> str:
    with open(path, "w") as f:
        f.write("\n".join(metrics_jsonl_lines(report)) + "\n")
    return path
