"""Telemetry for the gossip overlay (port of ``repro.obs``).

Collectors that run inside every overlay loop — metric accumulators
(``repro_torch.obs.metrics``), the event trace ring
(``repro_torch.obs.trace``) and the streaming histograms
(``repro_torch.obs.hist``, whose bincount is a CUDA kernel on a card) — and
host-side export (``repro_torch.obs.export``: Chrome/Perfetto traces, JSONL
metrics).

Contract: collection is a pure read. An obs-on run makes the same draws and
ends in bitwise the same state as the obs-off run, and ``obs_cfg=None`` (the
default) runs none of this code. The collectors keep their state on the
device and never read it back during a run: only ``obs_report`` drains it.

Entry points: ``GossipNetwork(obs_cfg=ObsConfig(...))``,
``run_dagfl_gossip(obs=ObsConfig(...))`` -> ``SimResult.extras["obs"]`` (an
``ObsReport``), ``simulate_insystem_tips(record_trace=True)`` and
``InSystemTrace.to_report()``.
"""
import torch

from repro_torch.obs import hist as _hist_lib
from repro_torch.obs import metrics as _metrics_lib
from repro_torch.obs import trace as _trace_lib
from repro_torch.obs.export import (ObsReport, chrome_trace, metrics_jsonl_lines,
                                    write_chrome_trace, write_metrics_jsonl)
from repro_torch.obs.hist import HistConfig, HistState, init_hist
from repro_torch.obs.metrics import MetricsState, ObsConfig, init_metrics
from repro_torch.obs.trace import (KIND_COMMIT, KIND_DELIVER, KIND_DRAIN, KIND_INFER,
                                   KIND_PARTITION, KIND_PUBLISH, KIND_REJECT, TraceRing,
                                   init_trace)


def observe_round(
    cfg: ObsConfig,
    metrics: MetricsState,
    ring: TraceRing,
    t: float,                  # the sample instant, an f32 value
    old_dags,                  # stacked replicas before the round
    new_dags,                  # stacked replicas after the round
    live_edges=None,           # (N, N) bool deliveries that survived
    bytes_delta=None,          # (N, N) f32 payload bytes moved this round
    bstate=None,               # post-round BankState (bank runs only)
    digest=None,
    old_have=None,             # (N, S, C) bool chunk presence before the round
    rejects=None,              # (N, N) i32 cumulative digest rejections
    rejects_delta=None,        # (N, N) i32 rejections charged this round
    quarantine_after=0,
) -> tuple:
    """The collector step every obs-on loop runs after a round.

    One metrics accumulation and sample, one DELIVER trace append over the
    surviving edges (arg = rows the receiver merged) and, where payload
    moved, one DRAIN append (arg = bytes). Fault runs
    (``repro_torch.net.faults``) also pass their rejection state: the
    rejected and quarantined series sample from ``rejects``, and each link
    that rejected chunks this round appends one REJECT record (arg = its
    rejections). With ``cfg.hist`` the histograms take the round's
    publish->merge and publish->commit samples, and the chunk completions
    when the bank state and ``old_have`` are passed. A pure read of its
    inputs; returns ``(metrics, ring)``, both updated in place.
    """
    t = torch.full((), t, dtype=torch.float32, device=new_dags.publisher.device)
    delta = _metrics_lib.rows_changed(new_dags, old_dags)
    metrics = _metrics_lib.update(metrics, cfg, t, new_dags, delta, bstate, digest,
                                  rejects=rejects, quarantine_after=quarantine_after)
    if cfg.hist is not None:
        metrics.hist = _hist_lib.observe(cfg.hist, metrics.hist, t, old_dags, new_dags,
                                         old_have=old_have, bstate=bstate)
    if cfg.trace:
        if live_edges is not None:
            arg = delta[:, None].expand(live_edges.shape)
            ring = _trace_lib.append_edges(ring, t, KIND_DELIVER, live_edges, arg)
        if bytes_delta is not None:
            ring = _trace_lib.append_edges(ring, t, KIND_DRAIN, bytes_delta > 0, bytes_delta)
        if rejects_delta is not None:
            ring = _trace_lib.append_edges(ring, t, KIND_REJECT, rejects_delta > 0,
                                           rejects_delta.float())
    return metrics, ring


__all__ = [
    "ObsConfig", "ObsReport", "MetricsState", "TraceRing",
    "HistConfig", "HistState", "init_hist",
    "init_metrics", "init_trace", "observe_round",
    "chrome_trace", "write_chrome_trace",
    "metrics_jsonl_lines", "write_metrics_jsonl",
    "KIND_DELIVER", "KIND_DRAIN", "KIND_PUBLISH", "KIND_COMMIT",
    "KIND_PARTITION", "KIND_REJECT", "KIND_INFER",
]
