#!/usr/bin/env python3
"""Where the telemetry's time goes in the PyTorch port: obs-on against
obs-off, and obs-on with one collector switched off at a time.

    python3 scripts/torch_obs_overhead.py                  # one CUDA card, full width
    python3 scripts/torch_obs_overhead.py --device cpu --nodes 8 --iterations 3

Runs ``run_dagfl_gossip`` at the paper's full width (the CNN with 1,663,370
parameters, 100 nodes, a 512-slot bank) on two paths of ``chip_smoke.py``'s
phase 2g: the ticks main path and the events engine's path (c) with int4
(1 Mbit/s, 0.5 s links), in these variants:

  off           ``obs=None``
  on            ``ObsConfig(hist=HistConfig())``, the default telemetry
  no_annotate   ``annotate=False``: no ``record_function`` ranges
  no_trace      ``trace=False``: no DELIVER/DRAIN appends
  no_sample     ``series_capacity=0``: every round counted as dropped, so no
                union fold, staleness or tip count is sampled
  no_hist       ``hist=None``: no histogram step at all
  no_binning    the histograms on, with ``bin_index`` replaced by a one-op
                stand-in (all samples in bin 0): the cost of the binning
                alone; its counts are wrong, so it is a timing variant only

Each variant runs twice per path, in forward then reverse order, and the
script prints one JSON line per path with every run's ms per iteration and
each variant's mean, and, per collector, the mean difference to ``on``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the smoke's full-width configurations)

VARIANTS = ("off", "on", "no_annotate", "no_trace", "no_sample", "no_hist", "no_binning")


def variant_options(name):
    from repro_torch.obs import HistConfig, ObsConfig

    return {
        "off": None,
        "on": ObsConfig(hist=HistConfig()),
        "no_annotate": ObsConfig(hist=HistConfig(), annotate=False),
        "no_trace": ObsConfig(hist=HistConfig(), trace=False),
        "no_sample": ObsConfig(hist=HistConfig(), series_capacity=0),
        "no_hist": ObsConfig(),
        "no_binning": ObsConfig(hist=HistConfig()),
    }[name]


def one_bin(values, cfg):
    """The timing stand-in for ``bin_index``: one op, every sample in bin 0."""
    return torch.zeros(values.shape, dtype=torch.int32, device=values.device)


def run(path_options, variant, device, nodes, iterations):
    """One ``run_dagfl_gossip``; returns wall ms per iteration."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask
    from repro_torch.obs import hist as hist_lib

    dcfg = dataclasses.replace(CNN_TASK.dagfl, num_nodes=nodes)
    node_data, gval = chip_smoke.paper_setup(nodes, 28)
    sim = SimConfig(iterations=iterations, eval_every=chip_smoke.EVAL_EVERY,
                    minibatch=dcfg.minibatch)
    obs = variant_options(variant)
    bin_index = hist_lib.bin_index
    if variant == "no_binning":
        hist_lib.bin_index = one_bin
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        run_dagfl_gossip(CNNTask(), node_data, dcfg, sim, gval, device=device, obs=obs,
                         **path_options)
        if device == "cuda":
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / iterations
    finally:
        hist_lib.bin_index = bin_index


def paths(nodes):
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.topology import full

    top = full(nodes, link_latency=0.5, bandwidth=chip_smoke.CONSTRAINED_BPS)
    return {
        "ticks_main": {},
        "events_c_1mbps_lat0.5_int4": dict(
            topology=top, engine="events", bank_gossip=BankGossipConfig(
                chunks_per_slot=chip_smoke.MAIN_CHUNKS, slot_bytes=chip_smoke.TABLE1_SLOT_BYTES,
                codec=DeltaCodec("int4"))),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=chip_smoke.MAIN_NODES)
    ap.add_argument("--iterations", type=int, default=chip_smoke.OBS_ITERATIONS)
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_obs_overhead: no CUDA card", file=sys.stderr)
            return 2
        from repro_torch.device import resolve_device
        from repro_torch.kernels import cuda_build

        resolve_device("cuda")
        cuda_build.build(sorted(cuda_build.CSRC.glob("*.cu")))
        print(chip_smoke.nvidia_smi_line())
    for name, options in paths(args.nodes).items():
        run(options, "on", args.device, args.nodes, max(args.iterations // 10, 1))   # warm-up
        ms = {v: [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for variant in order:
                ms[variant].append(run(options, variant, args.device, args.nodes,
                                       args.iterations))
        mean = {v: sum(x) / len(x) for v, x in ms.items()}
        print(json.dumps({
            "path": name, "device": args.device, "nodes": args.nodes,
            "iterations": args.iterations, "ms_per_iteration": ms, "mean": mean,
            "obs_overhead_ms": mean["on"] - mean["off"],
            "saved_ms": {v: mean["on"] - mean[v] for v in VARIANTS[2:]},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
