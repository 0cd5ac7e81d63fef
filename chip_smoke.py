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
   Table-I pricing (100 Mbit/s links, 7 MB models); each path under
   ``torch.profiler`` too, shorter;
3. runs a small ``run_dagfl``, a small ``run_dagfl_gossip`` (a lossy ring
   with a partition) and a small banked one (the same ring, starved) on the
   card and on the CPU with the same draws and checks that they agree.

Phase 1 of the merge-winner and chunk-dedup kernels runs last, after phase
3; the digest check (bank table against one payload, bitwise) runs before
phase 2c.

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
# the winner's least work per admitted (receiver, sender, row) candidate:
# occupancy, time >, time ==, publisher >, publisher ==, counter max
GOSSIP_OPS_PER_CHECK = 6
F32_TOL = 1e-5              # kernel vs plain, f32: fma vs multiply-then-add
ITERATIONS = 200
EVAL_EVERY = 50
PROFILED_ITERATIONS = 40
SPIN_CYCLES = 40_000_000    # about 20 ms at the H100's 1.98 GHz boost clock


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


def paper_setup(num_nodes, image_size, seed=0):
    from repro_torch.data.synthetic import MnistLike
    from repro_torch.fl.nodes import build_population

    gen = MnistLike(image_size=image_size, seed=seed)
    nodes = build_population(gen, num_nodes, seed=seed)
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


def phase_gossip_main_path(cuda_build):
    """The main path's second half: ``run_dagfl_gossip`` with its defaults
    (full overlay, sync period 1 s, ticks engine, fused round) at full width."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    task = CNNTask()
    nodes, gval = paper_setup(dcfg.num_nodes, task.image_size)
    sim = SimConfig(iterations=ITERATIONS, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl_gossip(task, nodes, dcfg, sim, gval, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)

    ex = res.extras
    union, replicas = ex["dag"], ex["replicas"].dags
    check(union.publisher.is_cuda and union.approvers.is_cuda, "union ledger is not on the card")
    check(replicas.publisher.is_cuda and replicas.approvers.is_cuda, "replicas are not on the card")
    check(tuple(replicas.publisher.shape) == (MAIN_NODES, MAIN_SLOTS),
          f"replicas {tuple(replicas.publisher.shape)}")
    check(int(union.count) == ITERATIONS + 1, f"union count {int(union.count)} != {ITERATIONS + 1}")
    check(ex["sync_rounds"] > 0, "no sync round ran")
    check(len(res.accs) > 0 and bool(np.isfinite(res.accs).all()), f"accuracies {res.accs}")
    params = res.final_params
    check(sum(p.numel() for p in params.values()) == MAIN_P, "CNNTask() is not full width")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()), "non-finite params")
    # one winner launch per executed round, one per union fold: each
    # controller check folds once, and so does the mid-run counter snapshot
    expected = ex["sync_rounds"] + ex["checks"] + 1
    check(launches.get("gossip_winner", 0) == expected,
          f"gossip_winner launched {launches.get('gossip_winner', 0)} times, expected {expected} "
          f"({ex['sync_rounds']} rounds + {ex['checks']} checks + 1 snapshot)")
    expected = ITERATIONS + ex["checks_with_tip"]
    check(launches.get("fedavg_gather", 0) == expected,
          f"fedavg_gather launched {launches.get('fedavg_gather', 0)} times, expected {expected}")
    return {
        "iterations": ITERATIONS, "nodes": dcfg.num_nodes, "capacity": dcfg.capacity,
        "params": MAIN_P, "run_s": wall_s, "stage_ms": ex["stage_ms"], "checks": ex["checks"],
        "checks_with_tip": ex["checks_with_tip"], "sync_rounds": ex["sync_rounds"],
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
    """The slice's path: ``run_dagfl_gossip(bank_gossip=...)`` at full
    width on each wire of ``bank_runs``; the unlimited one must be the
    bankless run of phase 2 bitwise."""
    return {name: bank_run(cuda_build, name, options, bankless)
            for name, options in bank_runs().items()}


def bank_run(cuda_build, name, options, bankless):
    """One full-width bank run, checked; returns its summary. Nothing of the
    run outlives the call, so the next run's peak memory is its own."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28)
    sim = SimConfig(iterations=ITERATIONS, eval_every=EVAL_EVERY, minibatch=dcfg.minibatch)
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
    check(int(ex["dag"].count) == ITERATIONS + 1, f"bank {name}: union count")
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
    # one dedup per executed round, per prepare (the gated view), per
    # controller check (the lag sample), and two in extras (the final
    # missing count and the bank-aware synced)
    expected = ex["sync_rounds"] + ITERATIONS + ex["checks"] + 2
    check(launches.get("chunk_dedup", 0) == expected,
          f"bank {name}: chunk_dedup launched {launches.get('chunk_dedup', 0)} times, "
          f"expected {expected} ({ex['sync_rounds']} rounds + {ITERATIONS} prepares + "
          f"{ex['checks']} checks + 2)")
    expected = ex["sync_rounds"] + ex["checks"] + 1
    check(launches.get("gossip_winner", 0) == expected,
          f"bank {name}: gossip_winner launched {launches.get('gossip_winner', 0)} times, "
          f"expected {expected}")
    expected = ITERATIONS + ex["checks_with_tip"]
    check(launches.get("fedavg_gather", 0) == expected,
          f"bank {name}: fedavg_gather launched {launches.get('fedavg_gather', 0)} times, "
          f"expected {expected}")
    if name == "unlimited":
        check(int(ex["bank_missing_final"].max()) == 0 and lag[:, 2].max() == 0,
              "bank unlimited: a payload lagged its row")
        check_same_run("bank unlimited vs bankless", res, bankless)
    return {
        "iterations": ITERATIONS, "nodes": dcfg.num_nodes, "capacity": dcfg.capacity,
        "params": MAIN_P, "chunks_per_slot": MAIN_CHUNKS,
        "slot_bytes": options["bank_gossip"].slot_bytes,
        "link_bytes_per_tick": float(options["topology"].bandwidth[0, 1]) / 8.0,
        "run_s": wall_s, "ms_per_iteration": 1e3 * wall_s / ITERATIONS,
        "stage_ms": ex["stage_ms"], "checks": ex["checks"],
        "sync_rounds": ex["sync_rounds"], "dispatch_counts": ex["dispatch_counts"],
        "launches": launches, "bank_bytes_sent": ex["bank_bytes_sent"],
        "bank_lag_max": float(lag[:, 2].max()),
        "bank_lag_curve": lag.tolist(),
        "bank_missing_final_max": int(ex["bank_missing_final"].max()),
        "synced_final": ex["synced_final"],
        "final_params_max_abs_diff_vs_bankless": (
            max(float((params[k] - bankless.final_params[k]).abs().max()) for k in params)
            if name == "unlimited" else None),
        "accs": [float(a) for a in res.accs],
        "peak_memory_bytes": peak,
    }


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
        getattr(systems, system)(CNNTask(), nodes, dcfg, sim, gval, device="cuda", **options)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
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
    for kernel in ("fedavg_gather", "gossip_winner", "chunk_dedup"):
        us = [end - start for start, end, name in spans if f"{kernel}_kernel" in name]
        out[f"{kernel}_in_loop"] = {"launches": len(us), "ms_total": sum(us) / 1e3,
                                    "ms_mean": sum(us) / 1e3 / max(len(us), 1)}
    out["top_device_ms"] = {name[:80]: us / 1e3 for name, us in top}
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


def phase_small_gossip_agreement():
    """A small ``run_dagfl_gossip`` on the card and on the CPU, with the same
    tip-selection and edge draws: a lossy ring with strided links and a
    partition that heals."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)

    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
        draw, edge_draw = small_draws(device, n, dcfg.capacity)
        out[device] = run_dagfl_gossip(
            task, nodes, dcfg, sim, gval, topology=ring(n, link_latency=1.5, drop=0.3),
            partition=PartitionSchedule(split_halves(n), 5.0, 12.0), device=device, draw=draw,
            edge_draw=edge_draw)
    g, c = out["cuda"], out["cpu"]
    check_same_run("gossip", g, c)
    check(g.extras["dispatch_counts"] == c.extras["dispatch_counts"],
          f"gossip: dispatch_counts differ: {g.extras['dispatch_counts']} vs "
          f"{c.extras['dispatch_counts']}")
    check(np.array_equal(g.extras["divergence_curve"], c.extras["divergence_curve"]),
          "gossip: divergence curve differs")
    check(g.extras["sync_rounds"] > 0, "gossip: no sync round ran")
    diff = max(float((g.final_params[k].cpu() - c.final_params[k]).abs().max()) for k in c.final_params)
    check(diff <= 1e-4, f"gossip: final params differ by {diff}")
    return {"final_params_max_abs_diff": diff, "accs": [float(a) for a in g.accs],
            "sync_rounds": g.extras["sync_rounds"], "dispatch_counts": g.extras["dispatch_counts"]}


def phase_small_bank_agreement():
    """A small banked ``run_dagfl_gossip`` on the card and on the CPU with
    the same draws: a lossy ring with strided, starved links (10 Mbit/s, 7
    MB models, so credit rolls over and gating holds rows back) and a
    partition that heals."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.topology import ring, split_halves

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=20, eval_every=5, seed=0)

    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
        draw, edge_draw = small_draws(device, n, dcfg.capacity)
        out[device] = run_dagfl_gossip(
            task, nodes, dcfg, sim, gval,
            topology=ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
            partition=PartitionSchedule(split_halves(n), 5.0, 12.0),
            bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS,
                                         slot_bytes=TABLE1_SLOT_BYTES),
            device=device, draw=draw, edge_draw=edge_draw)
    g, c = out["cuda"], out["cpu"]
    check_same_run("bank small", g, c)
    for key in ("dispatch_counts", "bank_bytes_sent", "synced_final"):
        check(g.extras[key] == c.extras[key],
              f"bank small: {key} differs: {g.extras[key]} vs {c.extras[key]}")
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final"):
        check(np.array_equal(g.extras[key], c.extras[key]), f"bank small: {key} differs")
    for name in ("have", "credit", "sent"):
        check(torch.equal(getattr(g.extras["replicas"].bank_state, name).cpu(),
                          getattr(c.extras["replicas"].bank_state, name)),
              f"bank small: transport {name} differs")
    lag = g.extras["bank_lag_curve"]
    check(lag[:, 2].max() > 0, "bank small: no payload lagged its row (gating never bit)")
    diff = max(float((g.final_params[k].cpu() - c.final_params[k]).abs().max()) for k in c.final_params)
    check(diff <= 1e-4, f"bank small: final params differ by {diff}")
    return {"final_params_max_abs_diff": diff, "accs": [float(a) for a in g.accs],
            "sync_rounds": g.extras["sync_rounds"], "bank_bytes_sent": g.extras["bank_bytes_sent"],
            "bank_lag_curve": lag.tolist()}


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
    from repro_torch.kernels import chunk_transfer, cuda_build, fedavg
    from repro_torch.kernels import gossip_merge

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
        bank_paths = phase_bank_main_path(cuda_build, bankless)
        del bankless
        print(json.dumps({"bank_main_path": bank_paths}))
        print(json.dumps({"profile_bank": phase_profile(
            "run_dagfl_gossip", label="run_dagfl_gossip(bank_gossip, Table I)",
            **bank_runs()["table1"])}))

        small = phase_small_agreement()
        print(json.dumps({"small_agreement": small}))
        small_gossip = phase_small_gossip_agreement()
        print(json.dumps({"small_gossip_agreement": small_gossip}))
        small_bank = phase_small_bank_agreement()
        print(json.dumps({"small_bank_agreement": small_bank}))
        gossip_cases = phase_gossip_kernel(gossip_merge)
        print(json.dumps({"gossip_cases": gossip_cases}))
        dedup_cases = phase_dedup_kernel(chunk_transfer)
        print(json.dumps({"dedup_cases": dedup_cases}))
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
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
