#!/usr/bin/env python3
"""Where telemetry's and the codec commit's time goes, by profiler ranges.

    python3 scripts/torch_cost_split.py [--src DIR]          # one CUDA card, full width
    python3 scripts/torch_cost_split.py --device cpu --nodes 8 --iterations 3

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), wraps
the functions named below in ``torch.profiler.record_function`` ranges for
the length of each run (from the outside: the package is not changed; a
name the tree lacks is skipped) and runs four of ``chip_smoke.py``'s
full-width paths under ``torch.profiler``:

  obs_ticks_main      the ticks gossip main path with ``obs`` on (2g)
  obs_events_c_int4   the events engine's path (c), 1 Mbit/s, 0.5 s links,
                      int4, with ``obs`` on (2g)
  commit_1mbps_int8   the ticks bank at 1 Mbit/s with the int8 codec (2d)
  commit_1mbps_int4   the same with int4 (2d)

Telemetry's ranges: ``observe_round`` (the whole collector step),
``metrics.update``, ``hist.observe``, ``hist.record``, ``hist.bin_index``,
``hist_bincount`` and ``record_binned`` (the kernel's wrappers, the second
where the tree has it), ``trace.append_edges``. The commit's:
``ledger.commit`` (the whole commit), ``codec.encode``,
``codec.encode_decode`` (where the tree has it), ``flatten_params``,
``quant_leaves``, ``quant_params``, ``layout.split``, ``codec.decode``,
``unflatten_params``, ``gossip_commit`` (the ledger row and the bank
write), ``net.write`` and ``bank_commit`` (the wire digest and the presence
reset).

Prints one JSON line per path: the run's wall ms and the device's idle
share (``chip_smoke.trace_summary``) and, per range, its calls, its host ms
(the range's CPU time, children included; the profiler slows the host) and
its device ms (the PyTorch operations' kernels launched inside it; the
hand-written kernels, launched through ctypes, are listed apart by name
with their launches and device ms). A range's host ms is its own cost plus
its children's: ``observe_round`` holds the others.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (the smoke's full-width configurations)

PREFIX = "split."
# the hand-written kernels of these paths: launched through ctypes, not by a
# PyTorch operation, so the profiler gives their time to no range; their
# totals by name come from the device timeline
KERNELS = ("hist_cluster", "hist_atomic", "hist_bincount", "quant_leaves", "quant_blocks",
           "gossip_winner", "chunk_dedup", "event_pop")


def ranges():
    """(label, owner, attribute) of every wrapped function."""
    from repro_torch import obs
    from repro_torch.fl import systems
    from repro_torch.kernels import delta_codec, hist_bincount
    from repro_torch.net import gossip
    from repro_torch.obs import hist, metrics, trace

    return [
        ("observe_round", obs, "observe_round"),
        ("metrics.update", metrics, "update"),
        ("hist.observe", hist, "observe"),
        ("hist.record", hist, "record"),
        ("hist.bin_index", hist, "bin_index"),
        ("hist_bincount", hist_bincount, "hist_bincount"),
        ("record_binned", hist_bincount, "record_binned"),
        ("trace.append_edges", trace, "append_edges"),
        ("ledger.commit", systems._GossipLedger, "commit"),
        ("codec.encode", delta_codec.DeltaCodec, "encode"),
        ("codec.encode_decode", delta_codec.DeltaCodec, "encode_decode"),
        ("codec.decode", delta_codec.DeltaCodec, "decode"),
        ("flatten_params", delta_codec, "flatten_params"),
        ("quant_leaves", delta_codec, "quant_leaves"),
        ("quant_params", delta_codec, "quant_params"),
        ("layout.split", delta_codec.BlockLayout, "split"),
        ("unflatten_params", systems, "unflatten_params"),
        ("gossip_commit", systems, "_gossip_commit"),
        ("net.write", gossip.GossipNetwork, "write"),
        ("bank_commit", gossip.GossipNetwork, "bank_commit"),
    ]


@contextlib.contextmanager
def wrapped():
    """Every function of ``ranges()`` the tree has, inside a range of its label."""
    saved = []

    def wrap(label, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return inner

    try:
        for label, owner, attr in ranges():
            fn = owner.__dict__.get(attr) if isinstance(owner, type) else getattr(owner, attr,
                                                                                    None)
            if fn is None:
                continue
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(label, fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def paths(nodes):
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.topology import full
    from repro_torch.obs import HistConfig, ObsConfig

    def bank(kind):
        return BankGossipConfig(chunks_per_slot=smoke.MAIN_CHUNKS,
                                slot_bytes=smoke.TABLE1_SLOT_BYTES, codec=DeltaCodec(kind))

    obs = ObsConfig(hist=HistConfig())
    slow = full(nodes, bandwidth=smoke.CONSTRAINED_BPS)
    return {
        "obs_ticks_main": dict(obs=obs),
        "obs_events_c_int4": dict(
            topology=full(nodes, link_latency=0.5, bandwidth=smoke.CONSTRAINED_BPS),
            bank_gossip=bank("int4"), engine="events", obs=obs),
        "commit_1mbps_int8": dict(topology=slow, bank_gossip=bank("int8")),
        "commit_1mbps_int4": dict(topology=slow, bank_gossip=bank("int4")),
    }


def run(options, device, nodes, iterations):
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = dataclasses.replace(CNN_TASK.dagfl, num_nodes=nodes)
    node_data, gval = smoke.paper_setup(nodes, 28)
    sim = SimConfig(iterations=iterations, eval_every=smoke.EVAL_EVERY,
                    minibatch=dcfg.minibatch)
    return run_dagfl_gossip(CNNTask(), node_data, dcfg, sim, gval, device=device, **options)


def profiled(options, device, nodes, iterations):
    """One run under the profiler with the ranges in place: wall ms, the
    trace's summary, and per range calls, host ms and device ms."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with wrapped():
        run(options, device, nodes, max(iterations // 10, 2))          # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            res = run(options, device, nodes, iterations)
            if device == "cuda":
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
    split = {}
    for e in prof.events():
        if not e.name.startswith(PREFIX) or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        s = split.setdefault(e.name[len(PREFIX):], {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += e.cpu_time_total / 1e3
        s["device_ms"] += e.device_time_total / 1e3
    summary = {"wall_ms": wall_ms}
    if device == "cuda":
        summary = smoke.trace_summary(prof, wall_ms)
        summary.pop("top_device_ms", None)
        spans = smoke.device_spans(prof)
        summary["kernels"] = {}
        for kernel in KERNELS:
            us = [end - start for start, end, name in spans if f"{kernel}_kernel" in name]
            summary["kernels"][kernel] = {"launches": len(us), "ms": sum(us) / 1e3}
    return {**summary, "rounds": res.extras.get("sync_rounds"),
            "events_processed": res.extras.get("events_processed"), "ranges": split}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree holding repro_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=smoke.MAIN_NODES)
    ap.add_argument("--iterations", type=int, default=smoke.PROFILED_ITERATIONS // 2)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_cost_split: no CUDA card", file=sys.stderr)
            return 2
        from repro_torch.device import resolve_device
        from repro_torch.kernels import cuda_build

        resolve_device("cuda")
        cuda_build.build(sorted(cuda_build.CSRC.glob("*.cu")))
        print(smoke.nvidia_smi_line())
    for name, options in paths(args.nodes).items():
        out = profiled(options, args.device, args.nodes, args.iterations)
        print(json.dumps({"path": name, "src": args.src, "device": args.device,
                          "nodes": args.nodes, "iterations": args.iterations, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
