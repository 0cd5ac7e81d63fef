#!/usr/bin/env python3
"""Run the PyTorch port of DAG-FL on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and nvcc. It
builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (into
``build/kernels/``), then:

1. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others, and times the kernel, the plain
   version, one PyTorch library call computing the same function where there
   is one, and the least time the card could take (``bound_ms``);
2. drives the main path — ``run_dagfl`` (Algorithm 2 with the Algorithm-1
   controller) with the paper's full-width CNN on 28x28 images, 100 nodes,
   a 512-slot bank — and checks that it went through every kernel; then its
   second half, ``run_dagfl_gossip`` (each node on its own ledger replica,
   synced by anti-entropy gossip over the full overlay) at the same size;
   then (2c) the priced bank, ``run_dagfl_gossip(bank_gossip=...)``, once
   with unlimited bandwidth (which must equal the bankless run) and once at
   Table-I pricing (100 Mbit/s links, 7 MB models); then (2d) the wire
   codec: the Table-I run with the identity codec (which must equal the
   codec-less one) and the 1 Mbit/s class raw and with the int8, int4 and
   top-k codecs (one codec launch per commit); then (2e) the continuous-time
   event engine, ``run_dagfl_gossip(engine="events")``: (a) with the
   defaults, which must equal the ticks run bitwise, (b) with the unlimited
   bank, which must equal (a), (c) the 1 Mbit/s class with 0.5 s links, raw
   and int4, beside the ticks runs of the same config, (d) a jittered
   8-regular overlay, cut in depth; (2f) the §IV in-system tip
   simulation at Table-I size and at the reference's bench point; each
   path under ``torch.profiler`` too, shorter; and (2g) telemetry
   (``obs=ObsConfig(hist=HistConfig())``) on the ticks main path, the
   Table-I bank, int4 over 1 Mbit/s and the events engine's path (c), each
   run with telemetry off and on (bitwise the same run; the histogram
   bincount launched per round), the ticks path profiled with telemetry
   on, and the Table-I tip simulation with ``record_trace=True``; and (2h)
   fault injection (``faults=FaultConfig(...)``), each path beside its
   unfaulted run: an all-honest config on the gossip main path and the
   Table-I bank, ticks and events (bitwise the unfaulted runs), 10 spoofers
   against digest verification on the Table-I bank and on the events
   engine's path (c) with int4, a crash window with selective forwarders
   and sybils, and the model-space screen (``parameter_outlier_scores``,
   the model-distance kernel) on five candidates of a poisoned run's bank;
3. runs a small ``run_dagfl``, a small ``run_dagfl_gossip`` (a lossy ring
   with a partition), a small banked one (the same ring, starved) and the
   same with the int8 codec on the card and on the CPU with the same draws
   and checks that they agree; encodes the same full-width payloads on the
   card and on the CPU, bitwise; and (3e) the same small runs on the events
   engine (jittered links) and a small tip simulation, card against CPU;
   (3g) small runs with telemetry on (the ticks ring, the starved banked
   ticks ring raw and with int8, the banked events ring, a traced tip
   simulation): histogram counts and trace records of the card equal the
   CPU's bitwise; (3h) small faulted runs with telemetry on (spoofers on a
   starved banked ring, ticks and events with int4; crash, selective and
   sybil roles bankless): ledgers, fault reports and telemetry bitwise.

Phase 1 of the merge-winner, chunk-dedup, codec, event-queue, histogram
and model-distance kernels runs last, after phase 3 (1f also holds
``bin_index`` on the card against the CPU at every f32 edge and the
sync-period multiples); the digest check (bank table against one payload,
bitwise) runs before phase 2c.

Prints one JSON line of kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result, on
any failure, or where there is no CUDA card or no ``src/repro_torch``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

MAIN_P = 1_663_370          # CNNTask() parameters: the paper's full-width CNN
MAIN_SLOTS = 512            # DagFLConfig.capacity
MAIN_NODES = 100            # DagFLConfig.num_nodes: the gossip path's replicas
MAIN_CHUNKS = 4             # BankGossipConfig.chunks_per_slot
TABLE1_SLOT_BYTES = 7e6     # Table I: phi = 7 MB per model
CONSTRAINED_BPS = 1e6       # the constrained link class: 125 KB per link per tick
MAIN_CODEC_BLOCKS = 12_998  # the paper's CNN blocked leaf by leaf into 128-value blocks
CODEC_COPIES = 10           # payload copies a timed codec call cycles through (66 MB > L2)
# what parameters of two calls of the same path on the card may differ by:
# nothing, with cuDNN's deterministic algorithms (repro_torch.device)
CALL_NOISE_TOL = 0.0
# the quantisation kernel's least f32 work per value: abs, max, divide,
# round, and two clamps
QUANT_OPS_PER_VALUE = 6
# the winner's least work per admitted (receiver, sender, row) candidate:
# occupancy, time >, time ==, publisher >, publisher ==, counter max
GOSSIP_OPS_PER_CHECK = 6
F32_TOL = 1e-5              # kernel vs plain, f32: fma vs multiply-then-add
ITERATIONS = 200
EVAL_EVERY = 50
PROFILED_ITERATIONS = 40
MAIN_EDGES = MAIN_NODES * (MAIN_NODES - 1)   # directed edges of full(100): the delivery slots
EVENT_POP_BYTES_PER_SLOT = 13   # f32 time, i32 kind, i32 seq, bool valid
POP_COLD_BYTES = 64_000_000     # the queues a cold event_pop timing cycles through (> 50 MB L2)
# path (d), the jittered 8-regular overlay: ~550 single-link batches per
# simulated second, so its depth is cut to keep the phase near 90 s
JITTER_ITERATIONS = 60
TIP_SIM_F = 1.5e9               # the mean of Table I's f range: h = 2.08 s
TIP_SIM_HORIZON = 600.0
TIP_SIM_PENDING = 64            # simulate_insystem_tips' max_pending
TIP_SIM_SEEDS = (0, 1, 2, 3, 4, 5)
SPIN_CYCLES = 40_000_000    # about 20 ms at the H100's 1.98 GHz boost clock
HIST_BINS = 65              # HistConfig(): 64 log-spaced bins and the overflow bin
OBS_ITERATIONS = 100        # phase 2g's depth: each path runs twice (telemetry off, on)
FAULT_ITERATIONS = 100      # phase 2h's depth: each faulted path beside its unfaulted run
# the model distance, kernel vs plain: relative to each entry's sum of
# absolute terms sq_i + sq_j + 2 |x_i . x_j| (sums in another order; the
# diagonal cancels to near 0)
DIST_TOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def call_ms(fn, args_list, warmup=3):
    """Mean wall ms per call over ``args_list`` (one call per entry), by CUDA
    events, with the host in the loop: the wrapper's own cost included.

    Each entry gathers other bank rows, so the 50 MB L2 cache holds none of
    a call's inputs, as on the main path where the rows are seconds old.
    """
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(args_list)


def device_ms(fn, args_list, warmup=3):
    """Mean device ms per call: a spin kernel holds the queue while the host
    enqueues every call, so the events time the calls back to back on the
    device, without the host's per-call cost. Where the host took longer to
    enqueue than the spin lasted, the spin is made 4x longer and the run
    repeated, three times at most, then it fails."""
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    spin_cycles = SPIN_CYCLES
    for _ in range(4):
        spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin0.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t = time.perf_counter()
        for args in args_list:
            fn(*args)
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t)
        end.synchronize()
        if host_ms < spin0.elapsed_time(start):
            return start.elapsed_time(end) / len(args_list)
        spin_cycles *= 4
    raise SmokeFailure(f"enqueueing took {host_ms:.2f} ms, longer than a spin of "
                       f"{spin_cycles // 4} cycles")


def bf16_ulp(x):
    """One bf16 unit in the last place of each value of ``x`` (f32)."""
    mag = x.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def fedavg_case(fedavg, name, rows, k, n_notx, gen, reps=40):
    """One shape of the Eq.-(1) kernel: error against the plain version and times."""
    dev = rows.device
    n, P = rows.shape
    sets = []
    for _ in range(reps):
        slots = torch.randint(0, n, (k,), generator=gen, device=dev, dtype=torch.int32)
        slots[:n_notx] = -1                              # NO_TX entries
        w = torch.where(slots >= 0, torch.full((k,), 1.0 / k, device=dev), 0.0)
        w = w / torch.clamp(w.sum(), min=1e-9)           # bank_average's renormalisation
        sets.append((rows, slots.clamp(min=0), w.contiguous()))
    got = fedavg.fedavg_gather(*sets[0])
    want = fedavg.fedavg_gather_plain(*sets[0])
    torch.cuda.synchronize()
    check(got.shape == (P,) and got.dtype == rows.dtype, f"{name}: output {got.shape} {got.dtype}")
    err = (got.float() - want.float()).abs()
    max_abs_err = float(err.max())
    if rows.dtype == torch.bfloat16:
        # both sides round an f32 sum once; sums a hair apart may round to neighbours
        picked = rows[sets[0][1].long()].float()
        scale = (sets[0][2].abs()[:, None] * picked.abs()).sum(0)
        tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + 1e-6 * scale
        check(bool((err <= tol).all()), f"{name}: off by more than 1 bf16 ulp")
    else:
        check(max_abs_err <= F32_TOL, f"{name}: max abs err {max_abs_err} > {F32_TOL}")

    library = lambda r, s, w: w.to(r.dtype) @ r[s.long()]     # yardstick only
    ms = device_ms(fedavg.fedavg_gather, sets)
    plain_ms = device_ms(fedavg.fedavg_gather_plain, sets)
    library_ms = device_ms(library, sets)
    wrapper_call_ms = call_ms(fedavg.fedavg_gather, sets)
    # least bytes: each distinct row with a non-zero weight read once, the output written once
    slots, w = sets[0][1], sets[0][2]
    rows_read = len({int(s) for s, x in zip(slots.tolist(), w.tolist()) if x != 0.0})
    nbytes = (rows_read + 1) * P * rows.element_size()
    flops = 2 * rows_read * P
    bytes_s, flops_s = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {
        "case": name, "rows": n, "P": P, "k": k, "no_tx": n_notx, "dtype": str(rows.dtype),
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "call_ms": wrapper_call_ms,
        "bound_ms": 1e3 * max(bytes_s, flops_s),
        "bound_by": "bytes" if bytes_s >= flops_s else "operations",
    }


def phase_kernels(fedavg):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    rows = fedavg.alloc_rows(MAIN_SLOTS, MAIN_P, torch.float32, dev)
    rows.normal_(generator=gen)
    cases.append(fedavg_case(fedavg, "main_k2", rows, 2, 0, gen))
    cases.append(fedavg_case(fedavg, "main_k2_no_tx", rows, 2, 1, gen))
    cases.append(fedavg_case(fedavg, "main_k8", rows, 8, 0, gen))
    del rows
    rows = fedavg.alloc_rows(MAIN_SLOTS, 1_000_003, torch.float32, dev)
    rows.normal_(generator=gen)
    cases.append(fedavg_case(fedavg, "ragged_k2", rows, 2, 0, gen))
    del rows
    rows = fedavg.alloc_rows(MAIN_SLOTS, MAIN_P, torch.bfloat16, dev)
    rows.normal_(generator=gen)
    cases.append(fedavg_case(fedavg, "main_k2_bf16", rows, 2, 0, gen))
    del rows
    # the reference kernel's own (weights, models) signature: slot = arange(k)
    models = torch.randn((3, 1_000_003), generator=gen, device=dev)
    w = torch.tensor([0.2, 0.3, 0.5], device=dev)
    got, want = fedavg.fedavg(w, models), fedavg.fedavg_gather_plain(models, torch.arange(3, device=dev), w)
    torch.cuda.synchronize()
    check(float((got - want).abs().max()) <= F32_TOL, "fedavg(weights, models) disagrees")
    torch.cuda.empty_cache()
    return cases


def gossip_case(gm, name, r, rr, cap, offset, density, gen, reps=40):
    """One shape of the merge-winner kernel: bitwise against the plain
    version, then times. The state has key ties, equal times under other
    publishers and rows nobody holds."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    pub = torch.randint(-1, 4, (r, cap), dtype=torch.int32, **kw)
    pub[:, ::37] = -1
    t = torch.randint(0, 4, (r, cap), **kw).float() * 0.5
    ac = torch.randint(0, 6, (r, cap), dtype=torch.int32, **kw)
    mask = torch.rand((rr, r), **kw) < density
    row_ids = None if offset is None else offset + torch.arange(rr, device=dev)
    got = gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
    want = gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
    torch.cuda.synchronize()
    max_abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{name}: gossip_winner differs from its plain version (max abs err {max_abs_err})")

    kernel = lambda: gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
    plain = lambda: gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
    ms = device_ms(kernel, [()] * reps)
    # the plain version launches about 30 kernels a call: 40 calls queued
    # behind the spin would fill CUDA's launch queue and block the host
    plain_ms = device_ms(plain, [()] * 8)
    wrapper_call_ms = call_ms(kernel, [()] * reps)
    # least bytes: the three (R, cap) columns and the mask read once, the two
    # outputs written once; least operations: every admitted candidate
    # (the receiver always admitted) checked once
    nbytes = 3 * r * cap * 4 + rr * r + 2 * rr * cap * 4
    ids = (0 if offset is None else offset) + torch.arange(rr, device=dev)
    own = ids[:, None] == torch.arange(r, device=dev)[None, :]
    checks = int((mask | own).sum()) * cap
    ops = GOSSIP_OPS_PER_CHECK * checks
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return {
        "case": name, "R": r, "Rr": rr, "cap": cap, "row_offset": offset, "density": density,
        "candidate_checks": checks, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "call_ms": wrapper_call_ms, "library_ms": None,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def phase_gossip_kernel(gm):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return [
        gossip_case(gm, "main", MAIN_NODES, MAIN_NODES, MAIN_SLOTS, None, 0.5, gen),
        gossip_case(gm, "union", MAIN_NODES, 1, MAIN_SLOTS, None, 1.0, gen),
        gossip_case(gm, "block", MAIN_NODES, 25, MAIN_SLOTS, 50, 0.5, gen),
        gossip_case(gm, "ragged", MAIN_NODES, MAIN_NODES, 1000, None, 0.5, gen),
        gossip_case(gm, "scale", 400, 400, MAIN_SLOTS, None, 0.5, gen, reps=20),
    ]


def paper_setup(num_nodes, image_size, seed=0, **population):
    from repro_torch.data.synthetic import MnistLike
    from repro_torch.fl.nodes import build_population

    gen = MnistLike(image_size=image_size, seed=seed)
    nodes = build_population(gen, num_nodes, seed=seed, **population)
    gval = gen.balanced(np.random.default_rng(seed + 31), 256)
    return nodes, {"x": gval.x, "y": gval.y}


def phase_main_path(cuda_build):
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl                       # 100 nodes, capacity 512, alpha 5, k 2
    task = CNNTask()
    t = time.perf_counter()
    nodes, gval = paper_setup(dcfg.num_nodes, task.image_size)
    setup_s = time.perf_counter() - t
    sim = SimConfig(iterations=ITERATIONS, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl(task, nodes, dcfg, sim, gval, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)

    dag = res.extras["dag"]
    check(dag.publisher.is_cuda and dag.approvers.is_cuda, "ledger is not on the card")
    params = res.final_params
    check(all(p.is_cuda for p in params.values()), "final params are not on the card")
    check(sum(p.numel() for p in params.values()) == MAIN_P, "CNNTask() is not full width")
    check(int(dag.count) == ITERATIONS + 1, f"ledger count {int(dag.count)} != {ITERATIONS + 1}")
    check(len(res.accs) > 0 and bool(np.isfinite(res.accs).all()), f"accuracies {res.accs}")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()), "non-finite params")
    expected = ITERATIONS + res.extras["checks_with_tip"]
    check(launches.get("fedavg_gather", 0) == expected,
          f"fedavg_gather launched {launches.get('fedavg_gather', 0)} times, "
          f"expected {expected} (prepares + controller checks with a tip)")
    return {
        "iterations": ITERATIONS, "nodes": dcfg.num_nodes, "capacity": dcfg.capacity,
        "params": MAIN_P, "population_setup_s": setup_s, "run_s": wall_s,
        "stage_ms": res.extras["stage_ms"], "checks": res.extras["checks"],
        "checks_with_tip": res.extras["checks_with_tip"], "launches": launches,
        "accs": [float(a) for a in res.accs], "avg_latency_s": res.avg_latency,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }


def phase_gossip_main_path(cuda_build, label="gossip", iterations=ITERATIONS, **options):
    """The main path's second half: ``run_dagfl_gossip`` with its defaults
    (full overlay, sync period 1 s, ticks engine, fused round) at full width;
    ``options`` go to the entry point (the events engine, another overlay)."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    task = CNNTask()
    nodes, gval = paper_setup(dcfg.num_nodes, task.image_size)
    sim = SimConfig(iterations=iterations, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl_gossip(task, nodes, dcfg, sim, gval, device="cuda", **options)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)

    ex = res.extras
    union, replicas = ex["dag"], ex["replicas"].dags
    check(union.publisher.is_cuda and union.approvers.is_cuda, "union ledger is not on the card")
    check(replicas.publisher.is_cuda and replicas.approvers.is_cuda, "replicas are not on the card")
    check(tuple(replicas.publisher.shape) == (MAIN_NODES, MAIN_SLOTS),
          f"replicas {tuple(replicas.publisher.shape)}")
    check(int(union.count) == iterations + 1,
          f"{label}: union count {int(union.count)} != {iterations + 1}")
    check(ex["sync_rounds"] > 0, f"{label}: no sync round ran")
    check(len(res.accs) > 0 and bool(np.isfinite(res.accs).all()), f"{label}: accuracies {res.accs}")
    params = res.final_params
    check(sum(p.numel() for p in params.values()) == MAIN_P, "CNNTask() is not full width")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()), f"{label}: non-finite params")
    check_round_launches(label, ex, launches, iterations)
    return {
        "iterations": iterations, "nodes": dcfg.num_nodes, "capacity": dcfg.capacity,
        "params": MAIN_P, "engine": options.get("engine", "ticks"), "run_s": wall_s,
        "ms_per_iteration": 1e3 * wall_s / iterations, "stage_ms": ex["stage_ms"],
        "checks": ex["checks"], "checks_with_tip": ex["checks_with_tip"],
        "sync_rounds": ex["sync_rounds"], "events_processed": ex["events_processed"],
        "events_capped": ex["events_capped"], "edge_draws": ex["edge_draws"],
        "dispatch_counts": ex["dispatch_counts"], "launches": launches,
        "missing_rows_final_max": int(ex["missing_rows_final"].max()),
        "approvals_issued": ex["approvals_issued"], "approvals_in_union": ex["approvals_in_union"],
        "accs": [float(a) for a in res.accs], "avg_latency_s": res.avg_latency,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }, res_without_bank(res)


def res_without_bank(res):
    """The result with its replicas' 3.4 GB model bank dropped: what a
    later comparison needs, without holding the bank on the card."""
    res.extras["replicas"] = res.extras["replicas"]._replace(bank=None)
    return res


LEDGER_COLUMNS = ("publisher", "publish_time", "approvals", "approvers", "approval_count",
                  "model_slot", "count", "published_per_node", "contributing_m0",
                  "contributing_m1")


def check_same_run(what, a, b):
    """Two runs of the gossip path agree: curve, latency, and the union's
    and every replica's ledger columns (integer columns and times)."""
    check(a.avg_latency == b.avg_latency, f"{what}: avg latency differs")
    for name in ("iters", "times", "accs"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differ: {getattr(a, name)} vs {getattr(b, name)}")
    for part, da, db in (("union", a.extras["dag"], b.extras["dag"]),
                         ("replicas", a.extras["replicas"].dags, b.extras["replicas"].dags)):
        for name in LEDGER_COLUMNS:
            check(torch.equal(getattr(da, name).cpu(), getattr(db, name).cpu()),
                  f"{what}: {part} {name} differs")
    for key in ("sync_rounds", "approvals_issued", "approvals_in_union"):
        check(a.extras[key] == b.extras[key],
              f"{what}: {key} differs: {a.extras[key]} vs {b.extras[key]}")


def phase_digests():
    """The two digest paths agree bitwise on the card: the store's table
    (``bank_digests``, slot by slot) against one payload (``chunk_digests``
    of ``bank_read``), for the genesis slots and for a slot re-committed
    with identical content (a lazy republish, which must dedup)."""
    from repro_torch.core.bank import bank_read, bank_write, init_bank
    from repro_torch.fl.tasks import CNNTask
    from repro_torch.net import bank as bank_lib

    params0 = CNNTask().init(0, "cuda")
    bank = init_bank(params0, 8)                    # genesis: slot 0 the model, the rest zeros
    bank_write(bank, 0, params0)
    bank_write(bank, 1, CNNTask().init(1, "cuda"))
    table = bank_lib.bank_digests(bank, MAIN_CHUNKS)
    for slot in range(8):
        check(torch.equal(table[slot], bank_lib.chunk_digests(bank_read(bank, slot), MAIN_CHUNKS)),
              f"digests: slot {slot}: the bank table differs from the payload's digests")
    have = torch.ones((MAIN_NODES, 8, MAIN_CHUNKS), dtype=torch.bool, device="cuda")
    _, digest = bank_lib.commit_chunks(have, table, bank_read(bank, 0), 5, 0)
    check(torch.equal(digest[5], table[0]), "digests: an identical re-commit got other digests")
    check(bool(torch.isfinite(table).all()) and not torch.equal(table[0], table[1]),
          "digests: non-finite, or two different models share digests")
    return {"slots": 8, "chunks": MAIN_CHUNKS, "params": MAIN_P}


def bank_runs():
    """The two wires of the bank path: unlimited bandwidth, and Table-I
    pricing (B = 100 Mbit/s per link, phi = 7 MB: 12.5 MB a tick, 7 whole
    1.75 MB chunks)."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.topology import full

    dcfg = CNN_TASK.dagfl
    return {
        "unlimited": dict(topology=full(dcfg.num_nodes),
                          bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS)),
        "table1": dict(topology=full(dcfg.num_nodes, bandwidth=dcfg.bandwidth),
                       bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                                    slot_bytes=TABLE1_SLOT_BYTES)),
    }


def phase_bank_main_path(cuda_build, bankless):
    """The bank's path: ``run_dagfl_gossip(bank_gossip=...)`` at full width
    on each wire of ``bank_runs``; the unlimited one must be the bankless run
    of phase 2 bitwise. Returns the summaries and the runs' results."""
    out, results = {}, {}
    for name, options in bank_runs().items():
        out[name], results[name] = bank_run(cuda_build, name, options,
                                            bankless=bankless if name == "unlimited" else None)
    return out, results


def codec_kernel_name(codec):
    """The codec kernel a codec's commits launch, or None."""
    if codec is None or codec.is_identity:
        return None
    return "topk_blocks" if codec.kind == "topk" else "quant_blocks"


def check_round_launches(what, ex, launches, iterations=ITERATIONS):
    """The launches every gossip run makes: one winner per round that drew
    (a drain-only batch of the events engine draws and merges nothing) and
    per union fold (each check, and the mid-run snapshot); Eq. (1) per
    prepare and per check with a tip; on the events engine one queue-head
    pop per batch and one more per advance that ended at its horizon."""
    expected = ex["edge_draws"] + ex["checks"] + 1
    check(launches.get("gossip_winner", 0) == expected,
          f"{what}: gossip_winner launched {launches.get('gossip_winner', 0)} times, expected "
          f"{expected} ({ex['edge_draws']} rounds + {ex['checks']} checks + 1 snapshot)")
    expected = iterations + ex["checks_with_tip"]
    check(launches.get("fedavg_gather", 0) == expected,
          f"{what}: fedavg_gather launched {launches.get('fedavg_gather', 0)} times, "
          f"expected {expected}")
    advances = sum(v for k, v in ex["dispatch_counts"].items() if k.startswith("advance_events"))
    expected = ex["events_processed"] + advances - ex["events_capped"]
    check(launches.get("event_pop", 0) == expected,
          f"{what}: event_pop launched {launches.get('event_pop', 0)} times, expected {expected} "
          f"({ex['events_processed']} batches + {advances} advances - {ex['events_capped']} "
          "capped)")


def bank_run(cuda_build, name, options, bankless=None, same_as=None, iterations=ITERATIONS):
    """One full-width bank run, checked; returns its summary and its result
    without the bank. Nothing else of the run outlives the call, so the next
    run's peak memory is its own. ``bankless``: the run must equal this
    bankless run; ``same_as``: it must equal this bank run (the identity
    codec against no codec)."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28)
    sim = SimConfig(iterations=iterations, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl_gossip(CNNTask(), nodes, dcfg, sim, gval, device="cuda", **options)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    ex = res.extras
    bstate = ex["replicas"].bank_state
    check(bstate.have.is_cuda and bstate.have.shape == (MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS),
          f"bank {name}: presence {tuple(bstate.have.shape)} on {bstate.have.device}")
    check(int(ex["dag"].count) == iterations + 1, f"bank {name}: union count")
    check(len(res.accs) > 0 and bool(np.isfinite(res.accs).all()),
          f"bank {name}: accuracies {res.accs}")
    params = res.final_params
    check(sum(p.numel() for p in params.values()) == MAIN_P, "CNNTask() is not full width")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          f"bank {name}: non-finite params")
    lag = ex["bank_lag_curve"]
    check(lag.shape == (ex["checks"], 3) and bool(np.isfinite(lag).all()),
          f"bank {name}: lag curve {lag.shape}")
    check(ex["bank_bytes_sent"] > 0, f"bank {name}: no payload byte was sent")
    # one dedup per executed round or event batch, per prepare (the gated
    # view), per controller check (the lag sample), and two in extras (the
    # final missing count and the bank-aware synced)
    expected = ex["sync_rounds"] + iterations + ex["checks"] + 2
    check(launches.get("chunk_dedup", 0) == expected,
          f"bank {name}: chunk_dedup launched {launches.get('chunk_dedup', 0)} times, "
          f"expected {expected} ({ex['sync_rounds']} rounds + {iterations} prepares + "
          f"{ex['checks']} checks + 2)")
    check_round_launches(f"bank {name}", ex, launches)
    # one codec launch per commit, of the codec's own kernel only
    codec = options["bank_gossip"].codec
    for kernel in ("quant_blocks", "topk_blocks"):
        expected = iterations if kernel == codec_kernel_name(codec) else 0
        check(launches.get(kernel, 0) == expected,
              f"bank {name}: {kernel} launched {launches.get(kernel, 0)} times, expected "
              f"{expected} (one per commit of a lossy codec)")
    if bankless is not None:
        check(int(ex["bank_missing_final"].max()) == 0 and lag[:, 2].max() == 0,
              f"bank {name}: a payload lagged its row")
        check_same_run(f"bank {name} vs bankless", res, bankless)
    if same_as is not None:
        check_same_bank_run(f"bank {name}", res, same_as, CALL_NOISE_TOL)
    reference = bankless if bankless is not None else same_as
    return {
        "iterations": iterations, "nodes": dcfg.num_nodes, "capacity": dcfg.capacity,
        "params": MAIN_P, "chunks_per_slot": MAIN_CHUNKS,
        "slot_bytes": options["bank_gossip"].slot_bytes,
        "link_bytes_per_tick": float(options["topology"].bandwidth[0, 1]) / 8.0,
        "codec": None if codec is None else codec.kind,
        "engine": options.get("engine", "ticks"),
        "run_s": wall_s, "ms_per_iteration": 1e3 * wall_s / iterations,
        "stage_ms": ex["stage_ms"], "checks": ex["checks"],
        "sync_rounds": ex["sync_rounds"], "events_processed": ex["events_processed"],
        "delivery_batches": ex["edge_draws"],
        "drain_batches": ex["events_processed"] - ex["edge_draws"]
        if ex["events_processed"] else 0,
        "events_capped": ex["events_capped"], "dispatch_counts": ex["dispatch_counts"],
        "launches": launches, "bank_bytes_sent": ex["bank_bytes_sent"],
        "bank_lag_max": float(lag[:, 2].max()), "bank_lag_final": float(lag[-1, 2]),
        "bank_lag_curve": lag.tolist(),
        "bank_missing_final_max": int(ex["bank_missing_final"].max()),
        "synced_final": ex["synced_final"],
        "final_params_max_abs_diff_vs_reference_run": (
            max(float((params[k] - reference.final_params[k]).abs().max()) for k in params)
            if reference is not None else None),
        "accs": [float(a) for a in res.accs], "final_accuracy": float(res.accs[-1]),
        "peak_memory_bytes": peak,
    }, res_without_bank(res)


def check_same_bank_run(what, a, b, param_tol):
    """Two bank runs agree: everything ``check_same_run`` holds, the
    transport state, lag curve, missing chunks and byte bill bitwise, and
    the parameters within ``param_tol``."""
    check_same_run(what, a, b)
    for key in ("dispatch_counts", "bank_bytes_sent", "synced_final"):
        check(a.extras[key] == b.extras[key],
              f"{what}: {key} differs: {a.extras[key]} vs {b.extras[key]}")
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final"):
        check(np.array_equal(a.extras[key], b.extras[key]), f"{what}: {key} differs")
    for name in ("have", "credit", "sent"):
        check(torch.equal(getattr(a.extras["replicas"].bank_state, name).cpu(),
                          getattr(b.extras["replicas"].bank_state, name).cpu()),
              f"{what}: transport {name} differs")
    diff = max(float((a.final_params[k].cpu() - b.final_params[k].cpu()).abs().max())
               for k in a.final_params)
    check(diff <= param_tol, f"{what}: final params differ by {diff} > {param_tol}")
    return diff


def constrained_runs():
    """Phase 2d (b): the constrained link class at full width, full(100) at
    1 Mbit/s (125 KB per directed link per tick; phi = 7 MB, four 1.75 MB
    raw chunks), with raw chunks and with each lossy codec."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.topology import full

    top = full(CNN_TASK.dagfl.num_nodes, bandwidth=CONSTRAINED_BPS)
    return {kind or "raw": dict(topology=top, bank_gossip=BankGossipConfig(
        chunks_per_slot=MAIN_CHUNKS, slot_bytes=TABLE1_SLOT_BYTES,
        codec=None if kind is None else DeltaCodec(kind)))
        for kind in (None, "int8", "int4", "topk")}


def phase_codec_main_path(cuda_build, table1):
    """The codec's path at full width: (a) the Table-I bank run again with
    the identity codec, which must equal phase 2c's Table-I run; (b) the
    1 Mbit/s class raw and with int8, int4 and topk."""
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig

    options = dict(bank_runs()["table1"])
    options["bank_gossip"] = BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                              slot_bytes=TABLE1_SLOT_BYTES,
                                              codec=DeltaCodec("none"))
    out = {"table1_identity": bank_run(cuda_build, "table1 identity codec", options,
                                       same_as=table1)[0]}
    for name, options in constrained_runs().items():
        out[f"1mbps_{name}"] = bank_run(cuda_build, f"1 Mbit/s {name}", options)[0]
    return out


def phase_profile(system="run_dagfl", label=None, **options):
    """A path again, shorter, under ``torch.profiler``: the device's busy
    share and where its time goes. The profiler slows the host, so these
    times are not the main path's. ``options`` go to the entry point."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl import systems
    from repro_torch.fl.tasks import CNNTask
    from torch.profiler import ProfilerActivity, profile

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28)
    sim = systems.SimConfig(iterations=PROFILED_ITERATIONS, eval_every=EVAL_EVERY,
                            minibatch=dcfg.minibatch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = getattr(systems, system)(CNNTask(), nodes, dcfg, sim, gval, device="cuda",
                                       **options)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    # device events, without the ranges telemetry's annotations
    # (``repro_torch.net.<entry point>``) mirror onto the device timeline
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("repro_torch.")]
    label = label or system
    if not spans:
        return {"system": label, "iterations": PROFILED_ITERATIONS, "wall_ms": wall_ms,
                "device_busy_ms": "not measured (no device events in the trace)"}
    busy_us, cur_end = 0.0, float("-inf")
    by_name = {}
    for start, end, name in sorted(spans):
        busy_us += max(0.0, end - max(start, cur_end))
        cur_end = max(cur_end, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "system": label, "iterations": PROFILED_ITERATIONS, "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_ops": len(spans),
    }
    for kernel in ("fedavg_gather", "gossip_winner", "chunk_dedup", "quant_blocks",
                   "topk_blocks", "event_pop", "hist_bincount"):
        us = [end - start for start, end, name in spans if f"{kernel}_kernel" in name]
        out[f"{kernel}_in_loop"] = {"launches": len(us), "ms_total": sum(us) / 1e3,
                                    "ms_mean": sum(us) / 1e3 / max(len(us), 1)}
    out["top_device_ms"] = {name[:80]: us / 1e3 for name, us in top}
    # host syncs: stream synchronisations the runtime made (each read back of
    # a device value is one), over the window and per event batch
    syncs = sum(1 for e in prof.events() if e.name == "cudaStreamSynchronize")
    out["host_syncs"] = syncs
    batches = res.extras.get("events_processed", 0)
    if batches:
        out["event_batches"] = batches
        out["host_syncs_per_batch"] = syncs / batches
    return out


def phase_small_agreement():
    """A small run on the card and on the CPU, with the same draws."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl

    dcfg = default_dagfl_config(num_nodes=8)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)

    def draw_on(device):
        def draw(stream, index):
            rng = np.random.default_rng([0 if stream == "prepare" else 1, index])
            u = rng.uniform(1e-9, 1.0, dcfg.capacity).astype(np.float32)
            return torch.from_numpy(u).to(device)
        return draw

    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=8, seed=0)
        out[device] = run_dagfl(task, nodes, dcfg, sim, gval, device=device, draw=draw_on(device))
    g, c = out["cuda"], out["cpu"]
    check(g.avg_latency == c.avg_latency, "avg latency differs")
    check(np.array_equal(g.iters, c.iters) and np.array_equal(g.times, c.times), "curve times differ")
    check(np.array_equal(g.accs, c.accs), f"accuracies differ: {g.accs} vs {c.accs}")
    dg, dc = g.extras["dag"], c.extras["dag"]
    for name in ("publisher", "approvals", "approval_count", "model_slot", "count",
                 "published_per_node", "contributing_m0", "contributing_m1"):
        check(torch.equal(getattr(dg, name).cpu(), getattr(dc, name)), f"ledger {name} differs")
    diff = max(float((g.final_params[n].cpu() - c.final_params[n]).abs().max()) for n in c.final_params)
    check(diff <= 1e-4, f"final params differ by {diff}")
    return {"final_params_max_abs_diff": diff, "accs": [float(a) for a in g.accs]}


def small_draws(device, n, cap):
    """Tip-selection and edge draws made with numpy, the same on every device."""
    def draw(stream, index):
        rng = np.random.default_rng([0 if stream == "prepare" else 1, index])
        return torch.from_numpy(rng.uniform(1e-9, 1.0, cap).astype(np.float32)).to(device)

    def edge_draw(round_index):
        rng = np.random.default_rng([2, round_index])
        return torch.from_numpy(rng.random((n, n), dtype=np.float32)).to(device)
    return draw, edge_draw


def phase_small_gossip_agreement(engine="ticks"):
    """A small ``run_dagfl_gossip`` on the card and on the CPU, with the same
    tip-selection and edge draws: a lossy ring with strided links and a
    partition that heals; on the events engine with jittered latencies
    (0.5-1.5 s), each link at its own cadence."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)
    latency = dict(link_latency=1.5)
    what = "gossip"
    if engine == "events":
        latency = dict(link_latency=0.5, latency_jitter=1.0)
        what = "gossip events"

    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
        draw, edge_draw = small_draws(device, n, dcfg.capacity)
        out[device] = run_dagfl_gossip(
            task, nodes, dcfg, sim, gval, topology=ring(n, drop=0.3, **latency),
            partition=PartitionSchedule(split_halves(n), 5.0, 12.0), engine=engine,
            device=device, draw=draw, edge_draw=edge_draw)
    g, c = out["cuda"], out["cpu"]
    check_same_run(what, g, c)
    check(g.extras["events_processed"] == c.extras["events_processed"],
          f"{what}: events_processed differs")
    check(g.extras["dispatch_counts"] == c.extras["dispatch_counts"],
          f"{what}: dispatch_counts differ: {g.extras['dispatch_counts']} vs "
          f"{c.extras['dispatch_counts']}")
    check(np.array_equal(g.extras["divergence_curve"], c.extras["divergence_curve"]),
          f"{what}: divergence curve differs")
    check(g.extras["sync_rounds"] > 0, f"{what}: no sync round ran")
    diff = max(float((g.final_params[k].cpu() - c.final_params[k]).abs().max()) for k in c.final_params)
    check(diff <= 1e-4, f"{what}: final params differ by {diff}")
    return {"final_params_max_abs_diff": diff, "accs": [float(a) for a in g.accs],
            "sync_rounds": g.extras["sync_rounds"], "events_processed": g.extras["events_processed"],
            "dispatch_counts": g.extras["dispatch_counts"]}


def phase_small_bank_agreement(codec=None, engine="ticks"):
    """A small banked ``run_dagfl_gossip`` on the card and on the CPU with
    the same draws: a lossy ring with strided, starved links (10 Mbit/s, 7
    MB models, so credit rolls over and gating holds rows back) and a
    partition that heals; with ``codec`` every commit goes through it.

    The integer results (curve, ledgers, transport state, lag, bytes) must
    agree bitwise. Parameters within 1e-4, and with a quantising codec one
    quantisation step more (the largest block's scale): the two devices'
    training differs by about 1e-7, and a value that close to a rounding
    boundary moves its code by one.

    ``engine="events"``: the same on the continuous-time engine, with
    jittered latencies (0.5-1.5 s), so chunk drains arm between deliveries."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)
    what = "bank small" if codec is None else f"bank small {codec.kind}"
    latency = dict(link_latency=1.5)
    if engine == "events":
        what += " events"
        latency = dict(link_latency=0.5, latency_jitter=1.0)

    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
        draw, edge_draw = small_draws(device, n, dcfg.capacity)
        out[device] = run_dagfl_gossip(
            task, nodes, dcfg, sim, gval,
            topology=ring(n, drop=0.3, bandwidth=1e7, **latency),
            partition=PartitionSchedule(split_halves(n), 5.0, 12.0),
            bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                         slot_bytes=TABLE1_SLOT_BYTES, codec=codec),
            engine=engine, device=device, draw=draw, edge_draw=edge_draw)
    g, c = out["cuda"], out["cpu"]
    for key in ("events_processed", "edge_draws"):
        check(g.extras[key] == c.extras[key],
              f"{what}: {key} differs: {g.extras[key]} vs {c.extras[key]}")
    if engine == "events":
        check(g.extras["events_processed"] > g.extras["edge_draws"],
              f"{what}: no drain-only batch ran")
    tol = 1e-4
    if codec is not None and codec.kind in ("int8", "int4"):
        qmax = 127 if codec.kind == "int8" else 7
        tol += max(float(v.abs().max()) for v in c.final_params.values()) / qmax
    diff = check_same_bank_run(what, g, c, tol)
    lag = g.extras["bank_lag_curve"]
    check(lag[:, 2].max() > 0, f"{what}: no payload lagged its row (gating never bit)")
    return {"final_params_max_abs_diff": diff, "param_tolerance": tol,
            "accs": [float(a) for a in g.accs], "sync_rounds": g.extras["sync_rounds"],
            "events_processed": g.extras["events_processed"],
            "delivery_batches": g.extras["edge_draws"],
            "bank_bytes_sent": g.extras["bank_bytes_sent"], "bank_lag_curve": lag.tolist()}


def phase_codec_encode_agreement():
    """The same full-width payloads encoded on the card (one kernel launch
    each) and on the CPU (the plain versions): codes, scales and masked
    deltas bitwise, and the decoded payloads bitwise."""
    from repro_torch.fl.tasks import CNNTask
    from repro_torch.kernels.delta_codec import DeltaCodec

    gen = torch.Generator()
    gen.manual_seed(5)
    params = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
              for k, v in CNNTask().init(0, "cpu").items()}
    base = {k: v + 0.001 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    on_card = lambda tree: {k: v.to("cuda") for k, v in tree.items()}
    out = {}
    for kind in ("int8", "int4", "topk"):
        codec = DeltaCodec(kind)
        enc_g = codec.encode(on_card(params), on_card(base))
        enc_c = codec.encode(params, base)
        dec_g, dec_c = codec.decode(enc_g, on_card(base)), codec.decode(enc_c, base)
        torch.cuda.synchronize()
        values = 0
        for part in enc_c:
            for name in enc_c[part]:
                a, b = enc_g[part][name].cpu(), enc_c[part][name]
                check(a.dtype == b.dtype and a.shape == b.shape and same_bits(a, b),
                      f"codec encode {kind}: {part}/{name} differs between card and CPU")
                values += b.numel()
        for name in dec_c:
            check(same_bits(dec_g[name].cpu(), dec_c[name]),
                  f"codec decode {kind}: {name} differs between card and CPU")
        out[kind] = {"wire_values": values, "max_abs_err": 0.0}
    return out


def same_bits(a, b):
    """Equal bit patterns: int8 codes equal, f32 values equal bit for bit
    (NaN and -0.0 included)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bits_err(got, want):
    """max |got - want| over the values whose bits differ (0.0 when all
    agree; NaN where a NaN meets a number)."""
    differ = ~(got.view(torch.int32) == want.view(torch.int32)) if got.dtype == torch.float32 \
        else got != want
    if not bool(differ.any()):
        return 0.0
    return float((got.float() - want.float()).abs()[differ].max())


def codec_rows(gen, layout, case, qmax=127, copies=CODEC_COPIES):
    """(copies, P) f32 payloads blocked by ``layout``. ``case``: "random";
    "zero" (every other codec block all zero, half of them -0.0); "halves"
    (each block's amax is qmax * 2**e, so its scale is 2**e and x / scale
    lands on exact halves); "ties" (a few distinct values with NaN and
    -0.0 beside +0.0); "sparse" (a few nonzeros per block)."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    p, nb = layout.num_values, layout.num_blocks
    rows = torch.randn((copies, p), **kw) * 0.05
    if case in ("zero", "halves"):               # whole blocks of a dense layout
        check(p == nb * layout.block, f"{case}: needs a dense layout")
        blocks = rows.view(copies, nb, layout.block)
        if case == "zero":
            blocks[:, ::2] = torch.where(torch.rand((copies, (nb + 1) // 2, 1), **kw) < 0.5,
                                         -0.0, 0.0)
        else:
            e = torch.randint(-12, 12, (copies, nb, 1), **kw).float()
            m = torch.randint(-qmax, qmax, blocks.shape, **kw).float() + 0.5
            blocks.copy_(m * torch.exp2(e))
            blocks[:, :, 0] = qmax * torch.exp2(e[:, :, 0])
    if case in ("ties", "sparse"):
        rows = torch.randint(-2, 3, (copies, p), **kw).float()
        if case == "sparse":
            rows[torch.rand((copies, p), **kw) < 0.97] = 0.0
        rows[torch.rand((copies, p), **kw) < 0.02] = float("nan")
        zero = rows == 0
        rows[zero] = torch.where(torch.rand((copies, p), **kw) < 0.5, -0.0, 0.0)[zero]
    return rows


def codec_bound(nbytes, ops):
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return {"bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def quant_case(dc, name, layout, case, qmax, gen, reps=40):
    """One shape of the quantisation kernel: codes and scales bitwise against
    the plain version, then times."""
    rows = codec_rows(gen, layout, case, qmax)
    args = [(rows[i % len(rows)], layout, qmax) for i in range(reps)]
    plain = lambda x, layout, qmax: dc.quant_blocks_plain(dc.blocked(x, layout), qmax)
    codes, scales = dc.quant_leaves(*args[0])
    want_c, want_s = plain(*args[0])
    torch.cuda.synchronize()
    max_abs_err = max(bits_err(codes, want_c), bits_err(scales, want_s))
    check(same_bits(codes, want_c) and same_bits(scales, want_s),
          f"quant {name}: differs from its plain version (max abs err {max_abs_err})")
    ms = device_ms(dc.quant_leaves, args)
    plain_ms = device_ms(plain, args[:8])
    wrapper_call_ms = call_ms(dc.quant_leaves, args)
    # least bytes: the payload read once, codes and scales written once, the
    # leaf table read once; least operations: QUANT_OPS_PER_VALUE per value
    nb, p = layout.num_blocks, layout.num_values
    nbytes = 4 * p + nb * layout.block + 4 * nb + 16 * (len(layout.names) + 1)
    return {"case": name, "qmax": qmax, "values": p, "blocks": nb, "leaves": len(layout.names),
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "call_ms": wrapper_call_ms, **codec_bound(nbytes, QUANT_OPS_PER_VALUE * p)}


def topk_case(dc, name, layout, case, k, gen, reps=40, with_base=True):
    """One shape of the top-k kernel: the masked delta bitwise against the
    plain version, then times. With a base the kernel subtracts it in place;
    the library yardstick (``torch.topk`` of |d| along the block, then a
    scatter of the kept values) gets the delta already blocked."""
    rows = codec_rows(gen, layout, case)
    bases = codec_rows(gen, layout, "random") if with_base else [None] * len(rows)
    if k is None:                                # k = the most nonzeros of any block
        k = max(int((dc.blocked(x, layout) != 0).sum(dim=1).max()) for x in rows)
    args = [(rows[i % len(rows)], bases[i % len(rows)], layout, k) for i in range(reps)]

    def plain(x, base, layout, k):
        return dc.topk_blocks_plain(dc.blocked(x if base is None else x - base, layout), k)

    got = dc.topk_leaves(*args[0])
    want = plain(*args[0])
    torch.cuda.synchronize()
    max_abs_err = bits_err(got, want)
    check(same_bits(got, want), f"topk {name}: differs from its plain version "
                                f"(max abs err {max_abs_err})")
    if case == "sparse":                         # k >= nnz keeps every value (a -0.0
        d = dc.blocked(args[0][0], layout)       # past rank k becomes +0.0)
        check(bool(((got == d) | (got.isnan() & d.isnan())).all()),
              f"topk {name}: k >= nnz lost a value")

    def library(d, k):                           # timing only: ties go anywhere
        idx = torch.topk(d.abs(), k, dim=1).indices
        return torch.zeros_like(d).scatter_(1, idx, d.gather(1, idx))

    deltas = [dc.blocked(x if b is None else x - b, layout) for x, b, _, _ in args[:CODEC_COPIES]]
    ms = device_ms(dc.topk_leaves, args)
    # the plain version launches about 8 kernels per 1,024 blocks: one call,
    # or the queue behind the spin fills and blocks the host
    plain_ms = device_ms(plain, args[:1])
    library_ms = device_ms(library, [(d, min(k, layout.block)) for d in deltas])
    wrapper_call_ms = call_ms(dc.topk_leaves, args)
    # least bytes: payload (and base) read once, the masked delta written once,
    # the leaf table read once; operations: the dense rank's compares
    nb, p = layout.num_blocks, layout.num_values
    nbytes = (8 if with_base else 4) * p + 4 * nb * layout.block + 16 * (len(layout.names) + 1)
    return {"case": name, "k": k, "values": p, "blocks": nb, "leaves": len(layout.names),
            "with_base": with_base, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch.topk(|d|, k, dim=1) + scatter",
            "call_ms": wrapper_call_ms,
            **codec_bound(nbytes, nb * layout.block * layout.block)}


def phase_codec_kernel(dc):
    """Phase 1d: both codec kernels at the main path's shape (the paper's
    CNN blocked leaf by leaf), a ragged model, all-zero blocks, exact halves,
    ties with NaN and -0.0, k >= nnz and a 4x scale."""
    from repro_torch.core.aggregation import leaf_shapes
    from repro_torch.fl.tasks import CNNTask

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    main = dc.leaf_layout(leaf_shapes(CNNTask().init(0, "cpu")))
    check(main.num_blocks == MAIN_CODEC_BLOCKS and main.num_values == MAIN_P,
          f"the CNN blocks into {main.num_blocks} codec blocks, not {MAIN_CODEC_BLOCKS}")
    ragged = dc.leaf_layout(tuple((f"l{i}", (n,)) for i, n in
                                  enumerate((1, 127, 0, 129, 1_000_003, 77))))
    dense = dc.dense_layout(MAIN_CODEC_BLOCKS, dc.BLOCK)
    scale = dc.dense_layout(4 * MAIN_CODEC_BLOCKS, dc.BLOCK)
    quant, topk = [], []
    for kind, qmax in (("int8", 127), ("int4", 7)):
        quant += [
            quant_case(dc, f"main_{kind}", main, "random", qmax, gen),
            quant_case(dc, f"ragged_{kind}", ragged, "random", qmax, gen),
            quant_case(dc, f"zero_blocks_{kind}", dense, "zero", qmax, gen),
            quant_case(dc, f"halves_{kind}", dense, "halves", qmax, gen),
            quant_case(dc, f"scale_4x_{kind}", scale, "random", qmax, gen, reps=20),
        ]
    topk += [
        topk_case(dc, "main", main, "random", 8, gen),
        topk_case(dc, "ragged", ragged, "random", 8, gen),
        topk_case(dc, "ties_nan_zeros", dense, "ties", 8, gen, with_base=False),
        topk_case(dc, "k_ge_nnz", dense, "sparse", None, gen, with_base=False),
        topk_case(dc, "k_128", ragged, "random", 128, gen),
        topk_case(dc, "scale_4x", scale, "random", 8, gen, reps=20, with_base=False),
    ]
    torch.cuda.empty_cache()
    return quant, topk


def dedup_case(ck, name, r, s, c, classes, special, gen, reps=40):
    """One shape of the chunk-dedup kernel: bitwise against the plain
    version, then times. Digests fall into ``classes`` duplicate classes;
    ``special`` adds NaN and -0.0/+0.0 digests."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    dig = torch.randint(0, classes, (s, c), **kw).float()
    if special:
        dig[torch.rand((s, c), **kw) < 0.1] = float("nan")
        zero = torch.rand((s, c), **kw) < 0.1
        dig[zero] = torch.where(torch.rand((s, c), **kw) < 0.5, -0.0, 0.0)[zero]
    have = torch.rand((r, s, c), **kw) < 0.5
    got = ck.chunk_dedup(have, dig)
    want = ck.chunk_dedup_plain(have, dig)
    torch.cuda.synchronize()
    max_abs_err = int((got.int() - want.int()).abs().max())
    check(torch.equal(got, want), f"{name}: chunk_dedup differs from its plain version "
                                  f"({int((got != want).sum())} entries)")

    kernel = lambda: ck.chunk_dedup(have, dig)
    plain = lambda: ck.chunk_dedup_plain(have, dig)
    # yardstick only: one batched product of the presence (C, R, S) against a
    # precomputed equality table (C, S, S), which is the dense form's work
    pres = have.permute(2, 0, 1).float().contiguous()
    eq = (dig.t()[:, :, None] == dig.t()[:, None, :]).float()
    library = lambda: torch.bmm(pres, eq)
    ms = device_ms(kernel, [()] * reps)
    plain_ms = device_ms(plain, [()] * 8)
    library_ms = device_ms(library, [()] * reps)
    wrapper_call_ms = call_ms(kernel, [()] * reps)
    # least bytes: presence and digests read once, availability written once;
    # least operations: one class lookup per output (equal digests form a
    # class within a column, so O(R S C) work suffices)
    nbytes = 2 * r * s * c + 4 * s * c
    ops = r * s * c
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return {
        "case": name, "R": r, "S": s, "C": c, "digest_classes": classes, "nan_and_zeros": special,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "torch.bmm(presence (C,R,S) f32, equality table (C,S,S) f32)",
        "call_ms": wrapper_call_ms, "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def phase_dedup_kernel(ck):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    return [
        dedup_case(ck, "main", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen),
        dedup_case(ck, "gate", 1, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen),
        dedup_case(ck, "ragged", 37, 1000, 3, 100, False, gen),
        dedup_case(ck, "nan_and_zeros", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 8, True, gen),
        dedup_case(ck, "one_class", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 1, False, gen),
        dedup_case(ck, "scale", 400, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen, reps=20),
    ]


def pop_queue(gen, q, case):
    """(time, kind, seq, valid) on the card for one event_pop case.

    "deliver": the full overlay's delivery slots, every slot valid, times on
    a 0.5 s grid (many exact ties: seq decides). "bank": delivery slots, then
    as many drain slots, 30 % armed at times off the grid (and some on it).
    "tipsim": delivery slots, 64 publish slots (some armed) and the start
    slot. "ties": times, kinds and seqs from small sets, duplicates included
    (a full tie goes to the lowest index). "signed_zeros": -0.0 beside +0.0.
    "inf_nan": +inf and NaN on valid slots. "invalid": nothing valid."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    seq = torch.arange(q, dtype=torch.int32, device=dev)
    kind = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    time_ = torch.randint(1, 7, (q,), **kw).float() * 0.5
    if case == "bank":
        e = q // 2
        kind[e:] = 1
        valid[e:] = torch.rand((q - e,), **kw) < 0.3
        time_[e:] = torch.where(torch.rand((q - e,), **kw) < 0.9,
                                torch.rand((q - e,), **kw) * 3.0, time_[e:])
    elif case == "tipsim":
        e = q - 65
        kind[e:e + 64] = 2
        kind[q - 1] = 3
        valid[e:e + 64] = torch.rand((64,), **kw) < 0.2
        time_[e:] = torch.rand((65,), **kw) * 3.0
    elif case in ("ties", "signed_zeros", "inf_nan", "invalid"):
        choices = {"ties": [0.25, 1.0, 1.5], "signed_zeros": [-0.0, 0.0, 0.5],
                   "inf_nan": [float("inf"), 1.0, float("nan"), 1.0],
                   "invalid": [1.0]}[case]
        pick = torch.randint(0, len(choices), (q,), **kw)
        time_ = torch.tensor(choices, device=dev)[pick]
        kind = torch.randint(0, 4, (q,), dtype=torch.int32, **kw)
        seq = torch.randint(0, 6, (q,), dtype=torch.int32, **kw)
        valid = torch.rand((q,), **kw) < (0.0 if case == "invalid" else 0.7)
    return time_, kind, seq, valid


def pop_case(ep, name, q, case, gen, draws=5, reps=200, cold=False):
    """One shape of the event-queue head: the kernel's four words bitwise
    against the plain version on ``draws`` queues, then times: ``ms_hot``
    pops one queue again and again (it stays in L2); with ``cold`` the
    calls cycle through distinct queues of 64 MB in all, more than the 50
    MB L2, as in the event loop, where the round between two pops moves
    megabytes and the static kind and seq columns go cold. ``ms`` is the
    cold time where there is one."""
    for _ in range(draws):
        args = pop_queue(gen, q, case)
        got = ep.event_head(*args)
        want = ep.event_head_plain(*args)
        torch.cuda.synchronize()
        max_abs_err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"event_pop {name}: kernel {got.tolist()} != plain "
                                      f"{want.tolist()}")
    ms_hot = device_ms(ep.event_head, [args] * reps)
    ms_cold = None
    if cold:
        copies = -(-POP_COLD_BYTES // (EVENT_POP_BYTES_PER_SLOT * q))
        ms_cold = device_ms(ep.event_head, [pop_queue(gen, q, case) for _ in range(copies)])
    # the plain version launches about 15 kernels a call: 8 calls behind the spin
    plain_ms = device_ms(ep.event_head_plain, [args] * 8)
    # what the event loop pays per batch for its head: the launch, the
    # read back and the host's own work
    head_ms = call_ms(lambda *a: ep.read_head(ep.event_head(*a)), [args] * reps)
    # least bytes: each slot's time, kind, seq (4 B each) and valid (1 B)
    # read once, the four output words written once; its compares are far less
    nbytes = EVENT_POP_BYTES_PER_SLOT * q + 16
    return {"case": name, "Q": q, "queue": case, "max_abs_err": max_abs_err,
            "ms": ms_hot if ms_cold is None else ms_cold, "ms_hot": ms_hot, "ms_cold": ms_cold,
            "plain_ms": plain_ms, "pop_and_read_back_ms": head_ms, "library_ms": None,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "bound_bytes": nbytes}


def phase_event_pop_kernel(ep):
    """Phase 1e: the queue head at the engine's three queue sizes (the full
    overlay's 9,900 delivery slots; 19,800 with the bank's drain slots;
    9,965 in the tip simulation) and the edge cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    q_tip = MAIN_NODES * (MAIN_NODES - 1) + TIP_SIM_PENDING + 1
    return [
        pop_case(ep, "deliver", MAIN_EDGES, "deliver", gen, cold=True),
        pop_case(ep, "bank", 2 * MAIN_EDGES, "bank", gen, cold=True),
        pop_case(ep, "tipsim", q_tip, "tipsim", gen, cold=True),
        pop_case(ep, "ties", MAIN_EDGES, "ties", gen),
        pop_case(ep, "signed_zeros", MAIN_EDGES, "signed_zeros", gen),
        pop_case(ep, "inf_nan", q_tip, "inf_nan", gen),
        pop_case(ep, "invalid", MAIN_EDGES, "invalid", gen),
        pop_case(ep, "q1", 1, "ties", gen, draws=20),
        pop_case(ep, "q70", 70, "ties", gen, draws=20),
        pop_case(ep, "q1025", 1025, "signed_zeros", gen, draws=20),
    ]


def check_same_floats(what, a, b):
    """Two runs agree in their floats too: the union's and every replica's
    accuracy and tag columns, the divergence curve, the final parameters."""
    for part, da, db in (("union", a.extras["dag"], b.extras["dag"]),
                         ("replicas", a.extras["replicas"].dags, b.extras["replicas"].dags)):
        for name in ("accuracy", "auth_tag"):
            check(same_bits(getattr(da, name).cpu(), getattr(db, name).cpu()),
                  f"{what}: {part} {name} differs")
    check(np.array_equal(a.extras["divergence_curve"], b.extras["divergence_curve"]),
          f"{what}: divergence curve differs")
    for k in a.final_params:
        check(same_bits(a.final_params[k].cpu(), b.final_params[k].cpu()),
              f"{what}: final params {k} differ")


def events_constrained_runs():
    """Path (c): the constrained link class with honest latency,
    full(100, link_latency=0.5, bandwidth=1e6), phi = 7 MB, raw and int4."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.topology import full

    top = full(CNN_TASK.dagfl.num_nodes, link_latency=0.5, bandwidth=CONSTRAINED_BPS)
    return {kind or "raw": dict(topology=top, bank_gossip=BankGossipConfig(
        chunks_per_slot=MAIN_CHUNKS, slot_bytes=TABLE1_SLOT_BYTES,
        codec=None if kind is None else DeltaCodec(kind))) for kind in (None, "int4")}


def phase_events_main_path(cuda_build, bankless, unlimited):
    """Phase 2e, the events engine at full width.

    (a) ``run_dagfl_gossip(engine="events")`` with the defaults: every edge
        delivers every 1.0 s, so it must equal phase 2's ticks run bitwise,
        floats included; (b) the unlimited bank on the events engine must
        equal (a), and its transport state phase 2c's unlimited ticks run;
    (c) the 1 Mbit/s class with 0.5 s links, raw and int4, each beside the
        ticks run of the same config; (d) a jittered 8-regular overlay, many
        distinct delivery instants, cut in depth. Returns the summaries and
        (a)'s kernel launches."""
    from repro_torch.net.topology import k_regular

    out = {}
    out["a_degenerate"], events_a = phase_gossip_main_path(cuda_build, "events (a)",
                                                           engine="events")
    check_same_run("events (a) vs ticks", events_a, bankless)
    check_same_floats("events (a) vs ticks", events_a, bankless)
    check(events_a.extras["events_processed"] == bankless.extras["sync_rounds"],
          "events (a): a batch per tick expected")
    options = dict(bank_runs()["unlimited"], engine="events")
    out["b_unlimited_bank"], events_b = bank_run(cuda_build, "unlimited events", options,
                                                 bankless=events_a)
    check_same_floats("events (b) vs (a)", events_b, events_a)
    for name in ("have", "credit", "sent"):
        check(torch.equal(getattr(events_b.extras["replicas"].bank_state, name).cpu(),
                          getattr(unlimited.extras["replicas"].bank_state, name).cpu()),
              f"events (b): transport {name} differs from the ticks unlimited run")
    del events_b
    drains = 0
    for name, options in events_constrained_runs().items():
        for engine in ("events", "ticks"):
            key = f"c_1mbps_lat0.5_{name}_{engine}"
            out[key] = bank_run(cuda_build, f"1 Mbit/s 0.5 s {name} {engine}",
                                dict(options, engine=engine))[0]
            drains += out[key]["drain_batches"]
    check(drains > 0, "events (c): no drain-only batch ran")
    out["d_k_regular_jitter"] = phase_gossip_main_path(
        cuda_build, "events (d)", iterations=JITTER_ITERATIONS, engine="events",
        topology=k_regular(MAIN_NODES, 8, link_latency=0.5, latency_jitter=1.0, seed=0))[0]
    return out, out["a_degenerate"]["launches"]


def phase_tip_sims(cuda_build):
    """Phase 2f, the §IV in-system tip simulation on the card. (e) Table-I
    size: full(100), capacity 512, k = 2, h = Eq. (7) at f = 1.5 GHz, lambda
    = 1, 600 s, sync 0.25 s; nothing may overflow. Then the reference's
    bench point (full(16), capacity 256) for several seeds: one seed's tail
    mean spreads by about 10 %, so their mean must land within 15 % of
    Eq. (4)."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.core import stability
    from repro_torch.net.events import simulate_insystem_tips
    from repro_torch.net.topology import full

    dcfg = CNN_TASK.dagfl
    h = stability.iteration_delay(dcfg, TIP_SIM_F)
    eq4 = stability.equilibrium_tips(dcfg, TIP_SIM_F)
    out = {}
    for name, n, capacity, seeds in (("e_table1", MAIN_NODES, MAIN_SLOTS, (0,)),
                                     ("bench_point", 16, 256, TIP_SIM_SEEDS)):
        runs = []
        for seed in seeds:
            torch.cuda.synchronize()
            cuda_build.LAUNCHES.clear()
            t = time.perf_counter()
            trace = simulate_insystem_tips(
                full(n), h=h, arrival_rate=dcfg.arrival_rate, k=dcfg.k, tau_max=dcfg.tau_max,
                horizon=TIP_SIM_HORIZON, capacity=capacity, seed=seed, sync_period=0.25,
                max_pending=TIP_SIM_PENDING)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            launches = dict(cuda_build.LAUNCHES)
            check(trace.overflow == 0, f"tip sim {name} seed {seed}: overflow {trace.overflow}")
            check(trace.published > 0.6 * TIP_SIM_HORIZON * dcfg.arrival_rate,
                  f"tip sim {name} seed {seed}: only {trace.published} published")
            check(trace.union.publisher.is_cuda, f"tip sim {name}: union is not on the card")
            pub = trace.union.published_per_node[:n].sum()
            check(int(pub) == trace.published, f"tip sim {name}: per-node counters {int(pub)}")
            # one pop per batch: every publish is a batch, and so is its start
            check(launches.get("event_pop", 0) > 2 * trace.published,
                  f"tip sim {name}: event_pop launched {launches.get('event_pop', 0)} times")
            runs.append({"seed": seed, "published": trace.published, "overflow": trace.overflow,
                         "tail_mean": trace.tail_mean(0.5),
                         "staleness_max": float(trace.staleness.max()),
                         "wall_s": wall_s, "launches": launches})
        tail = float(np.mean([r["tail_mean"] for r in runs]))
        out[name] = {"nodes": n, "capacity": capacity, "h_s": h, "horizon_s": TIP_SIM_HORIZON,
                     "eq4_tips": eq4, "tail_mean": tail, "rel_to_eq4": tail / eq4 - 1.0,
                     "runs": runs}
    rel = out["bench_point"]["rel_to_eq4"]
    check(abs(rel) <= 0.15, f"tip sim bench point: mean tail {out['bench_point']['tail_mean']} "
                            f"is {rel:+.1%} off Eq. (4) = {eq4}")
    return out


def tip_draws(device, n, cap):
    """The tip simulation's draws made with numpy, the same on every device."""
    def draw(what, index):
        rng = np.random.default_rng([3, index])
        f32 = lambda x: torch.tensor(np.float32(x), device=device)
        if what == "edges":
            return torch.from_numpy(rng.random((n, n), dtype=np.float32)).to(device)
        if what == "first":
            return f32(rng.exponential())
        u = torch.from_numpy(rng.uniform(1e-9, 1.0, cap).astype(np.float32)).to(device)
        return (torch.tensor(int(rng.integers(n)), device=device), u,
                f32(rng.exponential()))
    return draw


def phase_small_tip_agreement():
    """A small tip simulation on the card and on the CPU with the same draws:
    a lossy jittered ring, per-node h, a partition, few pending slots (some
    starts find none). Trace, counts and union bitwise."""
    from repro_torch.net.events import simulate_insystem_tips
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves

    n, cap = 8, 64
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = simulate_insystem_tips(
            ring(n, link_latency=0.5, latency_jitter=1.0, drop=0.3),
            h=np.linspace(0.5, 6.0, n), arrival_rate=2.0, k=2, tau_max=20.0, horizon=60.0,
            capacity=cap, sync_period=0.5, partition=PartitionSchedule(split_halves(n), 10.0, 25.0),
            max_pending=4, device=device, draw=tip_draws(device, n, cap))
    g, c = out["cuda"], out["cpu"]
    for name in ("times", "tips", "staleness"):
        check(np.array_equal(getattr(g, name), getattr(c, name)), f"tip sim small: {name} differ")
    check((g.published, g.overflow) == (c.published, c.overflow),
          f"tip sim small: counts {(g.published, g.overflow)} vs {(c.published, c.overflow)}")
    for name in LEDGER_COLUMNS:
        check(torch.equal(getattr(g.union, name).cpu(), getattr(c.union, name)),
              f"tip sim small: union {name} differs")
    check(g.overflow > 0, "tip sim small: no start found every pending slot taken")
    return {"published": g.published, "overflow": g.overflow, "tail_mean": g.tail_mean(0.5)}


# ---------------------------------------------------------------------------
# telemetry: the histogram bincount (1f), obs at full width (2g), card vs CPU (3g)
# ---------------------------------------------------------------------------


def hist_batch(gen, case, num_bins=HIST_BINS):
    """(idx, w) i32 on the card shaped like one of the loop's bincounts:
    ``merge`` bins R * cap latencies of sync-period multiples, a few rows
    changed; ``commit`` the cap rows of replica 0, a few newly propagated;
    ``chunk`` R * S chunk completions of 0-4 chunks; ``uniform`` every bin,
    out-of-range and negative indices among them."""
    from repro_torch.obs import hist as hist_lib

    m = {"merge": MAIN_NODES * MAIN_SLOTS, "commit": MAIN_SLOTS,
         "chunk": MAIN_NODES * MAIN_SLOTS, "uniform": MAIN_NODES * MAIN_SLOTS}[case]
    if case == "uniform":
        idx = torch.randint(-3, num_bins + 3, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        w = torch.randint(1, 4, (m,), generator=gen, device="cuda", dtype=torch.int32)
        return idx, w
    lat = 0.25 * torch.randint(1, 33, (m,), generator=gen, device="cuda").float()
    idx = hist_lib.bin_index(lat, hist_lib.HistConfig(bins=num_bins - 1))
    p = {"merge": 0.02, "commit": 0.01, "chunk": 0.05}[case]
    w = (torch.rand((m,), generator=gen, device="cuda") < p).to(torch.int32)
    if case == "chunk":
        w *= torch.randint(1, MAIN_CHUNKS + 1, (m,), generator=gen, device="cuda",
                           dtype=torch.int32)
    return idx, w


def hist_case(hb, name, case, gen, reps=200):
    """One shape of the histogram bincount: the kernel bitwise against the
    plain version on the same card tensors, then times: the kernel, the
    plain version, ``torch.bincount`` (the library yardstick; it reads the
    largest index back to size its output, so it is timed with the host in
    the loop), and the byte bound."""
    args_list = [hist_batch(gen, case) for _ in range(8)]
    max_abs_err = 0
    for idx, w in args_list:
        got = hb.hist_bincount(idx, w, HIST_BINS)
        want = hb.hist_bincount_plain(idx, w, HIST_BINS)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"hist_bincount {name}: kernel != plain "
                                      f"({max_abs_err} off)")
    ms = device_ms(lambda i, w: hb.hist_bincount(i, w, HIST_BINS), args_list * (reps // 8))
    plain_ms = device_ms(lambda i, w: hb.hist_bincount_plain(i, w, HIST_BINS), args_list * 4)
    call = call_ms(lambda i, w: hb.hist_bincount(i, w, HIST_BINS), args_list * 8)
    lib_args = [(i.clamp(0, HIST_BINS).long(), w.float()) for i, w in args_list]
    library_ms = call_ms(lambda i, w: torch.bincount(i, weights=w, minlength=HIST_BINS + 1),
                         lib_args * 4)
    m = int(args_list[0][0].shape[0])
    nbytes = 4 * m + 4 * m + 4 * HIST_BINS       # idx and w read once, the bins written once
    return {"case": name, "batch": case, "m": m, "num_bins": HIST_BINS,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "call_ms": call,
            "library_ms": library_ms,
            "library": "torch.bincount(idx, weights=w, minlength=num_bins), host in the loop",
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "bound_bytes": nbytes}


def phase_hist_kernel(hb):
    """Phase 1f: the histogram bincount against its plain version at the
    loop's shapes, and ``bin_index`` on the card against the CPU, bitwise,
    at every f32 edge, its neighbours and the sync-period multiples."""
    from repro_torch.obs import hist as hist_lib

    cfg = hist_lib.HistConfig()
    e = hist_lib.edges(cfg).astype(np.float32)
    values = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                             np.nextafter(e, np.float32(-np.inf)),
                             np.arange(1, 33, dtype=np.float32) * np.float32(0.25),
                             np.float32([0.0, -1.0, np.inf, np.nan, 3e38])])
    rng = np.random.default_rng(7)
    values = np.concatenate([values, np.exp(rng.uniform(-12, 12, 100_000)).astype(np.float32)])
    cpu = hist_lib.bin_index(torch.from_numpy(values), cfg)
    card = hist_lib.bin_index(torch.from_numpy(values).cuda(), cfg).cpu()
    bad = (card != cpu).nonzero().flatten()
    check(bad.numel() == 0, f"bin_index: card differs from the CPU at "
                            f"{values[bad[:5].numpy()].tolist()}: {card[bad[:5]].tolist()} vs "
                            f"{cpu[bad[:5]].tolist()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    cases = [hist_case(hb, name, name, gen) for name in ("merge", "commit", "chunk", "uniform")]
    return {"bin_index_values_checked": int(values.shape[0]), "cases": cases}


def obs_runs():
    """Phase 2g's four paths, each run with telemetry off and on: the ticks
    main path, the Table-I bank, int4 over 1 Mbit/s, and the events engine's
    path (c) with int4."""
    return {
        "ticks_main": {},
        "bank_table1": bank_runs()["table1"],
        "codec_1mbps_int4": constrained_runs()["int4"],
        "events_c_1mbps_lat0.5_int4": dict(events_constrained_runs()["int4"], engine="events"),
    }


def full_width_run(cuda_build, iterations, **options):
    """One full-width ``run_dagfl_gossip`` with the launch counts set to 0
    just before it and read just after; returns (result without the bank,
    wall seconds, launches)."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28)
    sim = SimConfig(iterations=iterations, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl_gossip(CNNTask(), nodes, dcfg, sim, gval, device="cuda", **options)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    return res_without_bank(res), wall_s, dict(cuda_build.LAUNCHES)


def export_sizes(report, stem):
    """Write a report as JSONL and as a Chrome trace under build/obs/:
    seconds and bytes of each."""
    from repro_torch import obs as obs_lib

    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for kind, write, suffix in (("jsonl", obs_lib.write_metrics_jsonl, ".jsonl"),
                                ("chrome_trace", obs_lib.write_chrome_trace, ".trace.json")):
        path = out_dir / f"{stem}{suffix}"
        t = time.perf_counter()
        write(report, str(path))
        out[f"{kind}_s"] = time.perf_counter() - t
        out[f"{kind}_bytes"] = path.stat().st_size
    return out


def hist_percentiles(report):
    return {name: {k: s[k] for k in ("samples", "p50", "p95", "p99")}
            for name, s in report.hist["percentiles"].items() if s["samples"] > 0}


def obs_pair(cuda_build, name, options):
    """One path with telemetry off, then on: the two runs bitwise equal,
    floats included (telemetry only reads), and the obs-on run's launches
    those of the obs-off run plus, per sample taken, one union fold (a
    winner launch) and with the bank one chunk count (a dedup launch), and
    per round or event batch one bincount per histogram it feeds (merge and
    commit latency; chunk latency with the bank), and the report's final
    scalars one more fold and one more dedup."""
    from repro_torch.obs import HistConfig, ObsConfig
    from repro_torch.obs import trace as obs_trace

    cfg = ObsConfig(hist=HistConfig())
    off, off_s, off_launches = full_width_run(cuda_build, OBS_ITERATIONS, **options)
    on, on_s, on_launches = full_width_run(cuda_build, OBS_ITERATIONS, obs=cfg, **options)
    what = f"obs {name}"
    bank = "bank_gossip" in options
    if bank:
        check_same_bank_run(what, on, off, 0.0)
    else:
        check_same_run(what, on, off)
    check_same_floats(what, on, off)
    for key in ("edge_draws", "events_processed", "dispatch_counts"):
        check(on.extras[key] == off.extras[key], f"{what}: {key} differs")
    rep = on.extras["obs"]
    rounds = on.extras["sync_rounds"]
    taken = min(rounds, cfg.series_capacity)
    check(rep.rounds == rounds and rep.samples == taken
          and rep.samples_dropped == rounds - taken,
          f"{what}: {rep.rounds} rounds, {rep.samples} samples for {rounds} rounds")
    expected = dict(off_launches)
    expected["gossip_winner"] = expected.get("gossip_winner", 0) + taken + 1
    if bank:
        expected["chunk_dedup"] = expected.get("chunk_dedup", 0) + taken + 1
    expected["hist_bincount"] = rounds * (3 if bank else 2)
    for kernel in set(expected) | set(on_launches):
        check(on_launches.get(kernel, 0) == expected.get(kernel, 0),
              f"{what}: {kernel} launched {on_launches.get(kernel, 0)} times, expected "
              f"{expected.get(kernel, 0)}")
    kinds = rep.trace["kind"]
    commits = int((kinds == obs_trace.KIND_COMMIT).sum())    # the ledger's host spans
    check(commits == OBS_ITERATIONS, f"{what}: {commits} COMMIT records")
    check(rep.hist["counts"]["merge_lat"].sum() > 0
          and rep.hist["counts"]["commit_lat"].sum() > 0, f"{what}: empty latency histograms")
    if bank:
        check(rep.hist["counts"]["chunk_lat"].sum() > 0, f"{what}: no chunk completion sampled")
        # the ring keeps its first records: at full width the first rounds'
        # 9,900 deliveries fill it before any payload moves
        check(rep.trace_dropped > 0 or (kinds == obs_trace.KIND_DRAIN).any(),
              f"{what}: no DRAIN record, none dropped")
    out = {
        "iterations": OBS_ITERATIONS, "engine": options.get("engine", "ticks"),
        "ms_per_iteration_obs_off": 1e3 * off_s / OBS_ITERATIONS,
        "ms_per_iteration_obs_on": 1e3 * on_s / OBS_ITERATIONS,
        "rounds": rounds, "samples": rep.samples, "samples_dropped": rep.samples_dropped,
        "trace_records": rep.trace_records, "trace_dropped": rep.trace_dropped,
        "hist": hist_percentiles(rep), "launches_obs_on": on_launches,
        "launches_obs_off": off_launches,
    }
    if name == "ticks_main":
        out["export"] = export_sizes(rep, name)
    return out


def phase_obs_main_path(cuda_build, tip_table1):
    """Phase 2g: telemetry at full width on four paths (``obs_pair``), the
    ticks main path profiled with telemetry on, and the Table-I tip
    simulation with ``record_trace=True``, which must be phase 2f's run
    (same seed) with its PUBLISH/COMMIT records beside it."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.core import stability
    from repro_torch.net.events import simulate_insystem_tips
    from repro_torch.net.topology import full
    from repro_torch.obs import HistConfig, ObsConfig
    from repro_torch.obs import trace as obs_trace

    out = {}
    for name, options in obs_runs().items():
        t = time.perf_counter()
        out[name] = obs_pair(cuda_build, name, options)
        out[name]["pair_s"] = time.perf_counter() - t
    out["profile_ticks_main_obs_on"] = phase_profile(
        "run_dagfl_gossip", label="run_dagfl_gossip(obs=ObsConfig(hist=HistConfig()))",
        obs=ObsConfig(hist=HistConfig()))

    dcfg = CNN_TASK.dagfl
    torch.cuda.synchronize()
    t = time.perf_counter()
    trace = simulate_insystem_tips(
        full(MAIN_NODES), h=stability.iteration_delay(dcfg, TIP_SIM_F),
        arrival_rate=dcfg.arrival_rate, k=dcfg.k, tau_max=dcfg.tau_max, horizon=TIP_SIM_HORIZON,
        capacity=MAIN_SLOTS, seed=0, sync_period=0.25, max_pending=TIP_SIM_PENDING,
        record_trace=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    check(trace.published == tip_table1["published"]
          and trace.tail_mean(0.5) == tip_table1["tail_mean"],
          f"tip sim with its trace: {trace.published} published, tail {trace.tail_mean(0.5)}, "
          f"not phase 2f's {tip_table1['published']}, {tip_table1['tail_mean']}")
    kinds = trace.trace["kind"]
    commits = int((kinds == obs_trace.KIND_COMMIT).sum())
    publishes = int((kinds == obs_trace.KIND_PUBLISH).sum())
    check(trace.trace_dropped == 0 and commits == trace.published
          and trace.published <= publishes <= trace.published + TIP_SIM_PENDING,
          f"tip sim trace: {publishes} PUBLISH, {commits} COMMIT, {trace.trace_dropped} dropped "
          f"for {trace.published} published")
    report = trace.to_report()
    check(report.samples == len(trace.times) and report.trace_records == commits + publishes,
          f"tip sim report: {report.samples} samples, {report.trace_records} records")
    out["tip_sim_trace"] = {"published": trace.published, "commit_records": commits,
                            "report_num_nodes": report.num_nodes,
                            "publish_records": publishes, "trace_dropped": trace.trace_dropped,
                            "wall_s": wall_s, "export": export_sizes(report, "tip_sim")}
    return out


def check_same_report(what, a, b):
    """Two ``ObsReport``s of the same run on two devices: counters, every
    integer series, the trace records and the histogram counts bitwise; the
    f32 byte sums within 1e-6 relative (a sum's order differs by device)."""
    check((a.rounds, a.samples_dropped, a.trace_dropped) == (b.rounds, b.samples_dropped,
                                                             b.trace_dropped),
          f"{what}: counters differ")
    for name in a.series:
        x, y = a.series[name], b.series[name]
        same = (np.allclose(x, y, rtol=1e-6, atol=0) if name == "bytes_total"
                else np.array_equal(x, y))
        check(same, f"{what}: series {name} differs")
    for name in a.trace:
        check(np.array_equal(a.trace[name], b.trace[name]), f"{what}: trace {name} differs")
    for name, counts in a.hist["counts"].items():
        check(np.array_equal(counts, b.hist["counts"][name]), f"{what}: hist {name} differs")
    check(np.array_equal(a.rows_merged, b.rows_merged), f"{what}: rows_merged differs")


def phase_small_obs_agreement():
    """Phase 3g: small runs with telemetry on, on the card and on the CPU
    with the same draws: the lossy ring with a partition on the ticks
    engine, bankless and with phase 3c's starved bank raw and with phase
    3d's int8 codec (chunk latencies and DRAIN records), the starved
    jittered ring with the bank on the events engine, and a small tip
    simulation with its trace. Reports bitwise (byte sums within 1e-6)."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.events import simulate_insystem_tips
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves
    from repro_torch.obs import KIND_DRAIN, HistConfig, ObsConfig

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)

    def starved(codec=None):
        return BankGossipConfig(chunks_per_slot=MAIN_CHUNKS, slot_bytes=TABLE1_SLOT_BYTES,
                                codec=codec)

    starved_ring = ring(n, drop=0.3, link_latency=1.5, bandwidth=1e7)
    arms = {
        "ticks": dict(topology=ring(n, drop=0.3, link_latency=1.5)),
        "ticks_bank": dict(topology=starved_ring, bank_gossip=starved()),
        "ticks_bank_int8": dict(topology=starved_ring, bank_gossip=starved(DeltaCodec("int8"))),
        "events_bank": dict(topology=ring(n, drop=0.3, link_latency=0.5, latency_jitter=1.0,
                                          bandwidth=1e7), engine="events",
                            bank_gossip=starved()),
    }
    out = {}
    for arm, options in arms.items():
        reps = {}
        for device in ("cuda", "cpu"):
            task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
            draw, edge_draw = small_draws(device, n, dcfg.capacity)
            res = run_dagfl_gossip(
                task, nodes, dcfg, sim, gval,
                partition=PartitionSchedule(split_halves(n), 5.0, 12.0), device=device,
                draw=draw, edge_draw=edge_draw, obs=ObsConfig(hist=HistConfig()), **options)
            reps[device] = res.extras["obs"]
        check_same_report(f"obs small {arm}", reps["cuda"], reps["cpu"])
        rep = reps["cuda"]
        if "bank_gossip" in options:
            check(rep.hist["counts"]["chunk_lat"].sum() > 0
                  and (rep.trace["kind"] == KIND_DRAIN).any(),
                  f"obs small {arm}: no chunk latency sampled or no DRAIN record")
        out[arm] = {"rounds": rep.rounds, "trace_records": rep.trace_records,
                    "hist_samples": {k: int(v.sum()) for k, v in rep.hist["counts"].items()}}
    cap = 64
    traces = {}
    for device in ("cuda", "cpu"):
        traces[device] = simulate_insystem_tips(
            ring(n, link_latency=0.5, latency_jitter=1.0, drop=0.3),
            h=np.linspace(0.5, 6.0, n), arrival_rate=2.0, k=2, tau_max=20.0, horizon=60.0,
            capacity=cap, sync_period=0.5, max_pending=4, record_trace=True, device=device,
            draw=tip_draws(device, n, cap))
    for name in traces["cpu"].trace:
        check(np.array_equal(traces["cuda"].trace[name], traces["cpu"].trace[name]),
              f"obs small tip sim: trace {name} differs")
    out["tip_sim"] = {"trace_records": int(traces["cuda"].trace["t"].shape[0])}
    return out


# ---------------------------------------------------------------------------
# fault injection: the model distance (1h), faulted paths at full width (2h),
# card vs CPU (3h)
# ---------------------------------------------------------------------------


def distance_scale(x):
    """(k, k) f64 sq_i + sq_j + 2 |x_i . x_j|: the sum of the absolute terms
    of each distance, what its rounding error scales with."""
    x = x.double()
    sq = (x * x).sum(1)
    return sq[:, None] + sq[None, :] + 2.0 * (x @ x.T).abs()


def distance_case(md, name, k, n, gen, zero_row=False, reps=40):
    """One shape of the model-distance kernel: within DIST_TOL of the sum of
    the absolute terms of its plain version on the same card tensors, the
    same bits from call to call, then times: the kernel, the plain version,
    ``torch.cdist`` (the library yardstick; it gives the root of the
    distance, computed through a matrix product) and the byte bound.
    Each timed call reads other models (copies cycled past the 50 MB L2), as
    a screen of freshly gathered candidates would."""
    nbytes = 4 * k * n + 4 * k * k          # the models read once, the distances written once
    copies = min(16, max(1, -(-120_000_000 // nbytes)))
    args_list = []
    for i in range(copies):
        x = torch.randn((k, n), generator=gen, device="cuda")
        x *= torch.rand((k, 1), generator=gen, device="cuda") * 10
        if zero_row and i == 0:
            x[k // 2] = 0.0
        args_list.append((x,))
    max_abs_err = 0.0
    for (x,) in args_list[:3]:
        got, again = md.model_distance(x), md.model_distance(x)
        want = md.model_distance_plain(x)
        torch.cuda.synchronize()
        check(got.shape == (k, k) and got.dtype == torch.float32, f"distance {name}: {got.shape}")
        check(torch.equal(got, again), f"distance {name}: two calls differ")
        err = (got.double() - want.double()).abs()
        max_abs_err = max(max_abs_err, float(err.max()))
        check(bool((err <= DIST_TOL * distance_scale(x)).all()),
              f"distance {name}: kernel off plain by {float(err.max())}")
    rounds = max(1, reps // copies)
    ms = device_ms(md.model_distance, args_list * rounds)
    plain_ms = device_ms(md.model_distance_plain, args_list * rounds)
    library_ms = device_ms(lambda x: torch.cdist(x, x, compute_mode="use_mm_for_euclid_dist"),
                           args_list * rounds)
    call = call_ms(md.model_distance, args_list * rounds)
    flops = k * (k + 1) * n             # the k(k+1)/2 dot products, an fma each per column
    bytes_s, flops_s = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {"case": name, "k": k, "N": n, "zero_row": zero_row, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "call_ms": call, "library_ms": library_ms,
            "library": "torch.cdist(x, x, compute_mode='use_mm_for_euclid_dist') (the root)",
            "bound_ms": 1e3 * max(bytes_s, flops_s),
            "bound_by": "bytes" if bytes_s >= flops_s else "operations",
            "bound_bytes": nbytes, "timed_copies": copies}


def phase_distance_kernel(md):
    """Phase 1h: the model-distance kernel against its plain version at the
    screen's shapes (alpha = 5 candidates of the paper's CNN, and 16) and at
    small odd ones (k = 1, N not a multiple of a chunk, a row of zeros)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    cases = [distance_case(md, "main_k5", 5, MAIN_P, gen),
             distance_case(md, "main_k16", 16, MAIN_P, gen),
             distance_case(md, "k1", 1, 4_097, gen, reps=20),
             distance_case(md, "k7_n33_zero_row", 7, 33, gen, zero_row=True, reps=20),
             distance_case(md, "k32_ragged", 32, 100_003, gen, zero_row=True, reps=20)]
    with_zero = torch.zeros((3, 1_000), device="cuda")
    check(int(md.model_distance(with_zero).abs().sum()) == 0, "distance of zeros is not 0")
    try:
        md.model_distance(torch.zeros((md.MAX_K + 1, 8), device="cuda"))
        check(False, "k past MAX_K was not refused")
    except ValueError:
        pass
    return cases


def fault_runs():
    """Phase 2h's fault configurations at full width (100 nodes)."""
    from repro_torch.net import faults

    n = MAIN_NODES
    spoof = tuple(faults.ROLE_SPOOF if i % 10 == 3 else faults.ROLE_HONEST for i in range(n))
    mixed = [faults.ROLE_HONEST] * n
    for i in range(5, n, 10):
        mixed[i] = faults.ROLE_SELECTIVE                  # 10 selective forwarders
    for i in range(7, n // 2, 10):
        mixed[i] = faults.ROLE_SYBIL                      # 5 sybils
    mixed[1] = mixed[2] = faults.ROLE_CRASH               # dark for [20, 60) s
    return {
        "honest": faults.FaultConfig(roles=(faults.ROLE_HONEST,) * n),
        "spoof": faults.FaultConfig(roles=spoof, spoof_rate=1.0, verify_digests=True,
                                    quarantine_after=3),
        "mixed": faults.FaultConfig(roles=tuple(mixed), crash_start=20.0, crash_end=60.0,
                                    forward_prob=0.5),
    }


def check_fault_run(what, res, cfg):
    """The defense's claims on a SPOOF run: no tainted chunk in any gated
    view, rejections charged to spoofers only, every quarantined link's
    sender a spoofer, a clean sender's credit exactly 1.0 and a charged
    one's below it. (A spoofer nobody fetched from is never charged.)"""
    rep = res.extras["fault_report"]
    roles = np.asarray(cfg.roles)
    spoofers, honest = roles == 4, roles != 4
    check(int(rep["tainted_in_views"].sum()) == 0, f"{what}: a tainted chunk is in a view")
    check(rep["rejected_total"] > 0, f"{what}: nothing was rejected")
    check(int(rep["rejects"][:, honest].sum()) == 0, f"{what}: an honest sender was charged")
    q = rep["rejects"] >= cfg.quarantine_after
    check(not q[:, honest].any(), f"{what}: quarantine cut {int(q[:, honest].sum())} honest links")
    credit = rep["rejection_credit"]
    charged = rep["rejects"].sum(axis=0) > 0
    check(bool((credit[honest] == 1.0).all()) and bool((credit[charged] < 1.0).all()),
          f"{what}: credit {credit}")
    return {"rejected": rep["rejected_total"], "quarantined_links": rep["quarantined_links"],
            "quarantined_links_from_spoofers": int(q[:, spoofers].sum()),
            "spoofers_charged": int(charged.sum()), "spoofers": int(spoofers.sum()),
            "credit_spoofers_mean": float(credit[spoofers].mean()),
            "credit_charged_mean": float(credit[charged].mean()),
            "credit_others_mean": float(credit[honest].mean()),
            "tainted_in_views": int(rep["tainted_in_views"].sum())}


def fault_summary(res, wall_s, launches):
    ex = res.extras
    out = {"ms_per_iteration": 1e3 * wall_s / FAULT_ITERATIONS, "run_s": wall_s,
           "sync_rounds": ex["sync_rounds"], "events_processed": ex["events_processed"],
           "launches": launches, "final_accuracy": float(res.accs[-1]),
           "stage_ms": ex["stage_ms"]}
    if "bank_bytes_sent" in ex:
        lag = ex["bank_lag_curve"]
        out.update(bank_bytes_sent=ex["bank_bytes_sent"], bank_lag_max=float(lag[:, 2].max()),
                   bank_lag_final=float(lag[-1, 2]))
    return out


def phase_fault_main_path(cuda_build):
    """Phase 2h: faulted paths at full width (``CNNTask()``, 100 nodes,
    capacity 512, FAULT_ITERATIONS iterations), each beside its unfaulted run
    in this call:

    (a) an all-honest ``FaultConfig`` on the gossip main path and on the
        Table-I bank, ticks and events: each bitwise the unfaulted run;
    (b) 10 SPOOF nodes (verification on, quarantine after 3) on the Table-I
        bank (ticks) and on events path (c) with int4 (``check_fault_run``);
    (c) bankless, ticks: a crash window, 10 SELECTIVE (p = 0.5), 5 SYBIL;
    (d) ``parameter_outlier_scores`` on alpha = 5 candidates read from the
        bank of a run with 10 poisoning nodes, card against the CPU."""
    from repro_torch.core import anomaly

    cfgs = fault_runs()
    table1 = bank_runs()["table1"]
    events_table1 = dict(table1, engine="events")
    events_c_int4 = dict(events_constrained_runs()["int4"], engine="events")
    out = {}
    plain = {}
    for name, options in (("gossip_ticks", {}), ("gossip_events", dict(engine="events")),
                          ("table1_ticks", table1), ("table1_events", events_table1)):
        off, off_s, off_launches = full_width_run(cuda_build, FAULT_ITERATIONS, **options)
        on, on_s, on_launches = full_width_run(cuda_build, FAULT_ITERATIONS,
                                               faults=cfgs["honest"], **options)
        what = f"faults honest {name}"
        if "bank_gossip" in options:
            check_same_bank_run(what, on, off, 0.0)
        else:
            check_same_run(what, on, off)
        check_same_floats(what, on, off)
        # the same launches, but the fault report's attack-success count
        # (one gated view, one dedup, per node) after a banked run
        expected = dict(off_launches)
        if "bank_gossip" in options:
            expected["chunk_dedup"] = expected.get("chunk_dedup", 0) + MAIN_NODES
        check(on_launches == expected, f"{what}: launches {on_launches} vs {expected}")
        check(on.extras["fault_report"].get("rejected_total", 0) == 0, f"{what}: rejections")
        out[f"a_honest_{name}"] = {"unfaulted": fault_summary(off, off_s, off_launches),
                                   "honest": fault_summary(on, on_s, on_launches)}
        if name in ("gossip_ticks", "table1_ticks"):
            plain[name] = out[f"a_honest_{name}"]["unfaulted"]
        del on, off
    for name, options, base in (("b_spoof_table1_ticks", table1, plain["table1_ticks"]),
                                ("b_spoof_events_c_int4", events_c_int4, None)):
        if base is None:
            off, off_s, off_launches = full_width_run(cuda_build, FAULT_ITERATIONS, **options)
            base = fault_summary(off, off_s, off_launches)
            del off
        res, wall_s, launches = full_width_run(cuda_build, FAULT_ITERATIONS,
                                               faults=cfgs["spoof"], **options)
        out[name] = {"unfaulted": base, "faulted": fault_summary(res, wall_s, launches),
                     "defense": check_fault_run(name, res, cfgs["spoof"])}
        del res
    res, wall_s, launches = full_width_run(cuda_build, FAULT_ITERATIONS, faults=cfgs["mixed"])
    union = res.extras["dag"]
    sybil = np.asarray(cfgs["mixed"].roles) == 5
    pub = union.publisher.cpu().numpy()
    ac = union.approval_count.cpu().numpy()
    forged = sybil[np.clip(pub, 0, MAIN_NODES - 1)] & (pub >= 0) & (pub < MAIN_NODES)
    check(not forged.any() or int(ac[forged].max()) >= MAIN_NODES,
          "faults mixed: a sybil row does not carry the forged approver set")
    out["c_crash_selective_sybil"] = {
        "unfaulted": plain["gossip_ticks"], "faulted": fault_summary(res, wall_s, launches),
        "approval_count_max": int(ac.max()),
        "approval_count_max_honest_rows": int(ac[(pub >= 0) & ~forged].max()),
        "sybil_rows": int(forged.sum())}
    del res

    # (d) the model-space screen on the bank of a poisoning population
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28, abnormal="poisoning",
                              num_abnormal=dcfg.num_nodes // 10)
    sim = SimConfig(iterations=FAULT_ITERATIONS, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)
    res = run_dagfl_gossip(CNNTask(), nodes, dcfg, sim, gval, device="cuda")
    union, bank = res.extras["dag"], res.extras["replicas"].bank
    poisoned = np.array([nd.behavior == "poisoning" for nd in nodes])
    pub = union.publisher.cpu().numpy()
    slot = union.model_slot.cpu().numpy()
    seq = np.argsort(-union.publish_time.cpu().numpy(), kind="stable")
    rows = [r for r in seq if 0 <= pub[r] < MAIN_NODES and slot[r] >= 0]
    # alpha = 5 candidates: the latest two poisoning publications, the latest normal ones
    bad = [r for r in rows if poisoned[pub[r]]][:2]
    good = [r for r in rows if not poisoned[pub[r]]][:dcfg.alpha - len(bad)]
    check(len(bad) >= 1 and len(bad) + len(good) == dcfg.alpha,
          f"screen: {len(bad)} poisoning and {len(good)} normal rows published")
    pick = bad + good
    x = bank.rows.index_select(0, torch.as_tensor(slot[pick], device="cuda").long())
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    scores = anomaly.parameter_outlier_scores(x)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    cpu = anomaly.parameter_outlier_scores(x.cpu())
    scale = distance_scale(x.cpu())
    row_scale = (scale.sum(1) - scale.diagonal()) / max(len(pick) - 1, 1)
    err = (scores.cpu().double() - cpu.double()).abs()
    check(bool((err <= DIST_TOL * row_scale).all()), f"screen: card off the CPU by {err.max()}")
    check(launches.get("model_distance", 0) == 1, f"screen: launches {launches}")
    out["d_outlier_screen"] = {
        "alpha": len(pick), "params": int(x.shape[1]), "launches": launches,
        "scores_poisoning": scores[:len(bad)].cpu().tolist(),
        "scores_normal": scores[len(bad):].cpu().tolist(),
        "max_abs_err_vs_cpu": float(err.max()),
        "publishers": [int(pub[r]) for r in pick]}
    del res, bank, x
    torch.cuda.empty_cache()
    return out


def phase_small_fault_agreement():
    """Phase 3h: small faulted runs with telemetry on, on the card and on the
    CPU with the same tip, edge and fault draws (numpy-made): (b) spoofers on
    the starved ring's bank, ticks, and on the jittered ring's bank with
    int4, events; (c) a crash window, selective forwarders and a sybil,
    bankless ticks. Ledgers, transport and fault state, fault reports and
    telemetry reports (rejected and quarantined series, REJECT records)
    bitwise; the f32 byte sums within 1e-6."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.kernels.delta_codec import DeltaCodec
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.faults import FaultConfig
    from repro_torch.net.topology import ring
    from repro_torch.obs import KIND_REJECT, HistConfig, ObsConfig

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)
    spoof = FaultConfig(roles=(4, 0, 0, 0, 4, 0, 0, 0), quarantine_after=2, spoof_rate=0.8)
    arms = {
        "b_ticks_bank": dict(topology=ring(n, drop=0.3, link_latency=1.5, bandwidth=1e7),
                             bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                                          slot_bytes=TABLE1_SLOT_BYTES),
                             faults=spoof),
        "b_events_bank_int4": dict(
            topology=ring(n, drop=0.3, link_latency=0.5, latency_jitter=1.0, bandwidth=1e6),
            bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                         slot_bytes=TABLE1_SLOT_BYTES, codec=DeltaCodec("int4")),
            engine="events", faults=spoof),
        "c_ticks_mixed": dict(topology=ring(n, drop=0.3, link_latency=1.5),
                              faults=FaultConfig(roles=(1, 0, 3, 0, 5, 0, 3, 0), crash_start=5.0,
                                                 crash_end=12.0, forward_prob=0.5)),
    }

    def fault_draw_on(device):
        def draw(stream, index, shape):
            key = [4, ("edges", "spoof", "spoof_batch").index(stream), *np.atleast_1d(index)]
            rng = np.random.default_rng([int(v) for v in key])
            return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
        return draw

    out = {}
    for arm, options in arms.items():
        res = {}
        for device in ("cuda", "cpu"):
            task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
            draw, edge_draw = small_draws(device, n, dcfg.capacity)
            res[device] = run_dagfl_gossip(task, nodes, dcfg, sim, gval, device=device,
                                           draw=draw, edge_draw=edge_draw,
                                           fault_draw=fault_draw_on(device),
                                           obs=ObsConfig(hist=HistConfig()), **options)
        g, c = res["cuda"], res["cpu"]
        what = f"faults small {arm}"
        codec = options.get("bank_gossip") and options["bank_gossip"].codec
        tol = 1e-4 + (max(float(v.abs().max()) for v in c.final_params.values()) / 7
                      if codec is not None else 0.0)
        if "bank_gossip" in options:
            diff = check_same_bank_run(what, g, c, tol)
        else:
            check_same_run(what, g, c)
            diff = max(float((g.final_params[k].cpu() - c.final_params[k]).abs().max())
                       for k in c.final_params)
            check(diff <= tol, f"{what}: final params differ by {diff}")
        rg, rc = g.extras["fault_report"], c.extras["fault_report"]
        check(rg.keys() == rc.keys(), f"{what}: fault report keys")
        for key in rc:
            check(np.array_equal(np.asarray(rg[key]), np.asarray(rc[key])),
                  f"{what}: fault report {key} differs")
        check_same_report(what, g.extras["obs"], c.extras["obs"])
        rep = g.extras["obs"]
        summary = {"final_params_max_abs_diff": diff, "rounds": rep.rounds,
                   "events_processed": g.extras["events_processed"]}
        if "bank_gossip" in options:
            check(rg["rejected_total"] > 0 and (rep.trace["kind"] == KIND_REJECT).any()
                  and rep.series["rejected"][-1] > 0,
                  f"{what}: no rejection recorded")
            summary.update(rejected=rg["rejected_total"], quarantined=rg["quarantined_links"],
                           reject_records=int((rep.trace["kind"] == KIND_REJECT).sum()))
        out[arm] = summary
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import chunk_transfer, cuda_build, delta_codec, event_pop, fedavg
    from repro_torch.kernels import gossip_merge, hist_bincount, model_distance

    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    try:
        t = time.perf_counter()
        sources = sorted(cuda_build.CSRC.glob("*.cu"))
        libs = cuda_build.build(sources)
        build_s = time.perf_counter() - t
        for lib in libs:
            log = lib.with_suffix(".log")
            report = log.read_text().strip() if log.exists() else "(built earlier)"
            print(f"[build] {lib.name} ({build_s:.1f} s)\n{report}")

        t = time.perf_counter()
        cases = phase_kernels(fedavg)
        print(json.dumps({"fedavg_cases": cases}))
        print(f"[phase 1] kernel vs plain: {time.perf_counter() - t:.1f} s")

        main_path = phase_main_path(cuda_build)
        print(json.dumps({"main_path": main_path}))
        print(json.dumps({"profile": phase_profile()}))
        gossip_path, bankless = phase_gossip_main_path(cuda_build)
        print(json.dumps({"gossip_main_path": gossip_path}))
        print(json.dumps({"profile_gossip": phase_profile("run_dagfl_gossip")}))

        print(json.dumps({"digests": phase_digests()}))
        bank_paths, bank_results = phase_bank_main_path(cuda_build, bankless)
        table1 = bank_results.pop("table1")
        print(json.dumps({"bank_main_path": bank_paths}))
        print(json.dumps({"profile_bank": phase_profile(
            "run_dagfl_gossip", label="run_dagfl_gossip(bank_gossip, Table I)",
            **bank_runs()["table1"])}))

        codec_paths = phase_codec_main_path(cuda_build, table1)
        del table1
        print(json.dumps({"codec_main_path": codec_paths}))
        print(json.dumps({"profile_codec": phase_profile(
            "run_dagfl_gossip", label="run_dagfl_gossip(bank_gossip, 1 Mbit/s, int4)",
            **constrained_runs()["int4"])}))

        t = time.perf_counter()
        events_paths, events_launches = phase_events_main_path(cuda_build, bankless,
                                                               bank_results["unlimited"])
        del bankless, bank_results
        print(json.dumps({"events_main_path": events_paths}))
        print(f"[phase 2e] events engine paths: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        tip_sims = phase_tip_sims(cuda_build)
        print(json.dumps({"tip_sims": tip_sims}))
        print(f"[phase 2f] tip simulations: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        obs_paths = phase_obs_main_path(cuda_build, tip_sims["e_table1"]["runs"][0])
        print(json.dumps({"obs_main_path": obs_paths}))
        print(f"[phase 2g] telemetry paths: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        fault_paths = phase_fault_main_path(cuda_build)
        print(json.dumps({"fault_main_path": fault_paths}))
        print(f"[phase 2h] fault injection paths: {time.perf_counter() - t:.1f} s")
        print(json.dumps({"profile_events": phase_profile(
            "run_dagfl_gossip",
            label="run_dagfl_gossip(engine=events, 1 Mbit/s, 0.5 s links, int4)",
            engine="events", **events_constrained_runs()["int4"])}))

        small = phase_small_agreement()
        print(json.dumps({"small_agreement": small}))
        small_gossip = phase_small_gossip_agreement()
        print(json.dumps({"small_gossip_agreement": small_gossip}))
        small_bank = phase_small_bank_agreement()
        print(json.dumps({"small_bank_agreement": small_bank}))
        small_codec = phase_small_bank_agreement(delta_codec.DeltaCodec("int8"))
        print(json.dumps({"small_codec_agreement": small_codec}))
        print(json.dumps({"codec_encode_agreement": phase_codec_encode_agreement()}))
        t = time.perf_counter()
        print(json.dumps({"small_events_agreement": phase_small_gossip_agreement("events")}))
        print(json.dumps({"small_events_bank_agreement": phase_small_bank_agreement(
            engine="events")}))
        print(json.dumps({"small_events_codec_agreement": phase_small_bank_agreement(
            delta_codec.DeltaCodec("int8"), engine="events")}))
        print(json.dumps({"small_tip_agreement": phase_small_tip_agreement()}))
        print(f"[phase 3e] events engine, card against CPU: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_obs_agreement": phase_small_obs_agreement()}))
        print(f"[phase 3g] telemetry, card against CPU: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_fault_agreement": phase_small_fault_agreement()}))
        print(f"[phase 3h] fault injection, card against CPU: {time.perf_counter() - t:.1f} s")
        gossip_cases = phase_gossip_kernel(gossip_merge)
        print(json.dumps({"gossip_cases": gossip_cases}))
        dedup_cases = phase_dedup_kernel(chunk_transfer)
        print(json.dumps({"dedup_cases": dedup_cases}))
        t = time.perf_counter()
        quant_cases, topk_cases = phase_codec_kernel(delta_codec)
        print(json.dumps({"quant_cases": quant_cases}))
        print(json.dumps({"topk_cases": topk_cases}))
        print(f"[phase 1d] codec kernels vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        pop_cases = phase_event_pop_kernel(event_pop)
        print(json.dumps({"event_pop_cases": pop_cases}))
        print(f"[phase 1e] event_pop vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        hist_cases = phase_hist_kernel(hist_bincount)
        print(json.dumps({"hist_bincount_cases": hist_cases}))
        print(f"[phase 1f] hist_bincount vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        distance_cases = phase_distance_kernel(model_distance)
        print(json.dumps({"model_distance_cases": distance_cases}))
        print(f"[phase 1h] model_distance vs plain: {time.perf_counter() - t:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    main_case = next(c for c in cases if c["case"] == "main_k2")
    kernels = [{
        "name": "fedavg_gather",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedavg.cu",
        "replaces": "src/repro/kernels/fedavg.py:27",
        "launches": main_path["launches"].get("fedavg_gather", 0),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    gossip_main = next(c for c in gossip_cases if c["case"] == "main")
    kernels.append({
        "name": "gossip_winner",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gossip_merge.cu",
        "replaces": "src/repro/kernels/gossip_merge.py:92",
        "launches": gossip_path["launches"].get("gossip_winner", 0),
        "max_abs_err": max(c["max_abs_err"] for c in gossip_cases),
        "ms": gossip_main["ms"],
        "kernel_ms": gossip_main["ms"],
        "call_ms": gossip_main["call_ms"],
        "plain_ms": gossip_main["plain_ms"],
        "bound_ms": gossip_main["bound_ms"],
        "bound_by": gossip_main["bound_by"],
        "library_ms": None,          # no single PyTorch call computes the winner
    })
    dedup_main = next(c for c in dedup_cases if c["case"] == "main")
    kernels.append({
        "name": "chunk_dedup",
        "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_dedup.cu",
        "replaces": "src/repro/kernels/chunk_transfer.py:63",
        "launches": bank_paths["table1"]["launches"].get("chunk_dedup", 0),
        "max_abs_err": max(c["max_abs_err"] for c in dedup_cases),
        "ms": dedup_main["ms"],
        "kernel_ms": dedup_main["ms"],
        "call_ms": dedup_main["call_ms"],
        "plain_ms": dedup_main["plain_ms"],
        "bound_ms": dedup_main["bound_ms"],
        "bound_by": dedup_main["bound_by"],
        "library_ms": dedup_main["library_ms"],   # torch.bmm against the equality table
    })
    for name, cases, main_name, run, line in (
            ("quant_blocks", quant_cases, "main_int8", "1mbps_int8", 76),
            ("topk_blocks", topk_cases, "main", "1mbps_topk", 123)):
        main_case = next(c for c in cases if c["case"] == main_name)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/delta_codec.cu",
            "replaces": f"src/repro/kernels/delta_codec.py:{line}",
            "launches": codec_paths[run]["launches"].get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"],
            "kernel_ms": main_case["ms"],
            "call_ms": main_case["call_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],   # quant: none; topk: torch.topk + scatter
        })
    pop_main = next(c for c in pop_cases if c["case"] == "deliver")
    kernels.append({
        "name": "event_pop",
        "route": "cuda",
        "source": "src/repro_torch/csrc/event_pop.cu",
        "replaces": "src/repro/kernels/event_pop.py:73",
        "launches": events_launches.get("event_pop", 0),
        "max_abs_err": max(c["max_abs_err"] for c in pop_cases),
        "ms": pop_main["ms"],
        "kernel_ms": pop_main["ms"],
        "call_ms": pop_main["pop_and_read_back_ms"],
        "plain_ms": pop_main["plain_ms"],
        "bound_ms": pop_main["bound_ms"],
        "bound_by": pop_main["bound_by"],
        "library_ms": None,          # no single PyTorch call takes a lexicographic argmin
    })
    hist_main = next(c for c in hist_cases["cases"] if c["case"] == "merge")
    kernels.append({
        "name": "hist_bincount",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_bincount.cu",
        "replaces": "src/repro/kernels/hist_bincount.py:52",
        "launches": obs_paths["ticks_main"]["launches_obs_on"].get("hist_bincount", 0),
        "max_abs_err": max(c["max_abs_err"] for c in hist_cases["cases"]),
        "ms": hist_main["ms"],
        "kernel_ms": hist_main["ms"],
        "call_ms": hist_main["call_ms"],
        "plain_ms": hist_main["plain_ms"],
        "bound_ms": hist_main["bound_ms"],
        "bound_by": hist_main["bound_by"],
        "library_ms": hist_main["library_ms"],   # torch.bincount, host in the loop
    })
    distance_main = next(c for c in distance_cases if c["case"] == "main_k5")
    kernels.append({
        "name": "model_distance",
        "route": "cuda",
        "source": "src/repro_torch/csrc/model_distance.cu",
        "replaces": "src/repro/kernels/model_distance.py:32",
        "launches": fault_paths["d_outlier_screen"]["launches"].get("model_distance", 0),
        "max_abs_err": max(c["max_abs_err"] for c in distance_cases),
        "ms": distance_main["ms"],
        "kernel_ms": distance_main["ms"],
        "call_ms": distance_main["call_ms"],
        "plain_ms": distance_main["plain_ms"],
        "bound_ms": distance_main["bound_ms"],
        "bound_by": distance_main["bound_by"],
        "library_ms": distance_main["library_ms"],   # torch.cdist (the root), via a product
    })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
