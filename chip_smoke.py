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
   path under ``torch.profiler`` too, shorter; (2l) inference serving,
   ``run_dagfl_gossip(serve=ServeConfig())`` on path (c) raw (100 nodes
   at 1 request/s each): the run repeats bitwise, rate 0 and no serving
   are one run, serving leaves the ledgers and transport as they were,
   requests are conserved, no batch exceeds its slots, every node's
   arrivals equal the host replay of its draws, the gated staleness is
   positive, one union fold and one dedup an INFER batch; then with the
   histograms (queue wait, staleness at serve) and a profiled window of
   serving and serve-free runs (device operations and host syncs an INFER
   batch); (3l) a small banked serving run card against CPU and the default
   draws on both devices; and (2g) telemetry
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
   and (2i) the model zoo's dense transformer served at full width:
   qwen3-0.6b in bf16 from a seeded init, ``prefill`` of 8,192 tokens and
   ``forward`` of 8,193 (``decode_step``'s logits on the last token within
   the reference's 2e-2 of forward's in an f32 twin of the same draws; in
   bf16 prefill's within it, decode's no farther from the f32 forward than
   bf16's own forward is), 16 ``decode_step``s of a batch of 8
   against a 32k cache (``decode_32k``'s context, its batch cut from 128 to
   8), a profiled window of 8 more, and the ``SlotServer`` (4 slots, 8
   requests of 512 prompt tokens, 32 new each); every attention layer
   launches its kernel once; and (2j) the RWKV6 family served at full
   width: rwkv6-7b in bf16 from a seeded init (7,534,952,448 parameters),
   ``prefill`` and ``forward`` of 8,192 tokens, a prefill of 8,160 and 32
   ``decode_step``s fed the true tokens against forward's logits at those
   positions (bf16 within RWKV_BF16_DECODE_ATOL; an f32 twin at 1,024 tokens
   within the reference's 2e-2), decode at ``decode_32k``'s batch of 128
   from that state (16 steps, then a profiled window of 8) and the
   ``SlotServer`` (4 slots, 8 requests of 512 prompt tokens, 32 new each);
   every prefill or forward launches the chunked WKV kernel once a layer,
   every decode step the sequential one, and neither the other; the
   profiled window's device ms and operations a decode step; and (2k) the
   paper's experiments at full width, run right after the main path: (a)
   ``run_dagfl`` with the paper's char LSTM (``LSTMTask()``, 820,522
   parameters) on the 100-node char population with ``LSTM_TASK.dagfl``,
   cut in depth to ``LSTM_ITERATIONS`` (ledger, parameters and bank on the
   card, ``fedavg_gather`` once a prepare and once a check with a tip),
   twice, bitwise the same run, and a profiled SGD step and validation;
   (b) ``run_google``, ``run_async`` and ``run_block`` on ``CNNTask()`` at
   ``ITERATIONS`` and on ``LSTMTask()`` at ``LSTM_ITERATIONS`` (no hand
   kernel launched: their averages are plain PyTorch); Table II's two
   numbers per system and task, as ``iteration_delay_experiment`` computes
   them; and (2m) DAG-FL training over the model zoo: ``launch.train.run``
   of qwen3-0.6b at full width in bf16, ``TRAIN_STEPS`` steps of
   ``TRAIN_NODES`` nodes (each step: selection, Eq. (1) through
   ``fedavg_gather``, a local SGD step of every node through ``Model.loss``
   with attention's backward kernel, cross-validation scoring, the
   frontier), twice with one seed and bitwise the same run, the launches a
   step of the three kernels with every plain version made to raise, a
   profiled step (the device's idle share, host and device ms a stage),
   and node 0's parameters and the frontier through a checkpoint, bitwise;
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
   sybil roles bankless): ledgers, fault reports and telemetry bitwise;
   (3i) reduced qwen3-0.6b (f32) and its sliding-window variant with the
   same parameters: prefill and decode logits within 1e-4, the
   ``SlotServer``'s tokens, ticks and length equal; (3j) reduced rwkv6-7b
   (f32): forward and prefill of 96 tokens (the chunked WKV kernel) and 4
   decode steps (the sequential one) within 1e-4, the ``SlotServer``'s
   tokens and ticks equal with prompts of 32 and of 9 tokens (the latter
   prefilled by the sequential kernel), both launch counts checked; (3k) the
   bench LSTM through ``run_dagfl`` and the three baselines on the bench CNN
   and the bench LSTM (a lazy population): latencies, times, accuracies,
   Block FL's ``dropped`` and the ledger's integer columns equal,
   parameters within 1e-4; (3m) reduced qwen3-0.6b (f32), two DAG-FL steps
   of 4 nodes from the same weights and draws: the frontiers equal,
   parameters within 1e-4.

Phase 1 holds the Eq.-(1) kernel at the paper's CNN (k = 2, 8, a NO_TX
slot, ragged, bf16) and at the paper's LSTM (``main_lstm_k2``: k = 2 rows of
820,522). Phase 1 of the merge-winner, chunk-dedup, codec, event-queue, histogram,
model-distance, attention and WKV kernels runs last, after phase 3 (1b
times the winner at density 0.5, the full overlay (every edge live, a ticks
round) and an events batch of path (d) (1-4 live edges of
``k_regular(100, 8)``, beside the live edges a batch that path (d) really
had, counted on the device during 2e) among its cases, and 1c the dedup at
its cases, the edge columns and a store past one hash table, each with the
kernel's registers and shared memory; 1i
times the prefill kernel at 8k, 32k, 32k with an 8k window, gemma-2b's MQA
and an odd f32 shape, and the decode kernel at the 32k cache, ragged lengths
with 0, 1 and S, gemma-2b's shape and f32, each against its plain version in
f32 on the same inputs; 1j times the WKV kernel's chunked route at
rwkv6-7b's 8k prefill with the model's decays and with strong ones, in f32,
one chunk from a nonzero state, 32k and an odd f32 shape at hd 128, each
against its chunked plain version and the sequential scan run in f32 on the
same inputs, with the bound restated for the tensor cores beside PR 21's,
and its sequential route at rwkv6-7b's decode step (B 128) and an odd f32
shape at hd 128, T 9, against ``wkv_scan_plain``, out of place and in
place, with each WKV kernel's registers and shared memory; 1d times the
top-k kernel's two selections at the main shape (k = 32: rounds; 33: the
bitwise search) and blocks of 1,024 beside the earlier cases, the
quantisation with the decoded payload in the same launch (the commit's
``encode_decode``: the CNN's own leaves, a ragged model's unaligned views,
zero blocks, exact halves, 4x scale) bitwise against the plain
quantisation and dequantisation, checks ``encode_decode`` against
``decode(encode())`` and prints the codec kernels' registers and spills;
1e checks ``pop_head``'s pinned
host mirror against the device words on every draw, times the pop and
read back through it and through ``read_head``, adds Q either side of a
pass of the cluster and a million slots, and prints the head kernel's
registers, shared memory and cluster size; 1f holds ``bin_index`` on the
card against the CPU and the fused ``record`` (binning, bincount and add in
one launch) against ``record_plain``, bitwise, at every f32 edge of two
``HistConfig``s with their neighbours and special values, times ``record``
at the loop's four shapes beside the plain and the unfused path, keeps the
idx route's four cases and prints the kernel's registers and spills; 1h
holds the model distance (one launch: distances and, for the screen, the
scores) against its plain version at its five cases, with each case's
device kernels a call (profiled right after phase 1), the kernel's
registers, shared memory and spills, its plan, and views with other row
strides and start offsets bitwise the contiguous tensor; 1m holds
attention's backward kernel against its plain version run in f32 at the
training shape (B 4, S 128, qwen3-0.6b's heads, bf16), B 1 at 4,096,
gemma-2b's MQA at hd 256 with a window and an odd f32 shape, each repeated
bitwise, timed beside the plain version, the backward of
``scaled_dot_product_attention`` and its bound, with the kernels'
registers and shared memory); the digest check
(bank table against one payload, bitwise) runs before phase 2c.

Prints one JSON line of kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result, on
any failure, or where there is no CUDA card or no ``src/repro_torch``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
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
PEAK_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores
PEAK_F64_FLOPS = 34e12       # f64 outside the tensor cores

MAIN_P = 1_663_370          # CNNTask() parameters: the paper's full-width CNN
LSTM_P = 820_522            # LSTMTask() parameters: the paper's full-width char LSTM
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
# simulated second, so its depth is cut (60 until phase 2l came, 50-90 s;
# nothing it checks depends on the depth)
JITTER_ITERATIONS = 20
TIP_SIM_F = 1.5e9               # the mean of Table I's f range: h = 2.08 s
TIP_SIM_HORIZON = 600.0
TIP_SIM_PENDING = 64            # simulate_insystem_tips' max_pending
TIP_SIM_SEEDS = (0, 1, 2, 3, 4, 5)
SPIN_CYCLES = 40_000_000    # about 20 ms at the H100's 1.98 GHz boost clock
HIST_BINS = 65              # HistConfig(): 64 log-spaced bins and the overflow bin
# the fused histogram update's least work per weighted sample: the binning
# (obs/hist.py::bin_index with xla_log_f32: 12 f64 products and 12 f64 sums,
# two divisions and about 13 other f32 operations) and the add
HIST_F64_OPS_PER_SAMPLE, HIST_F32_OPS_PER_SAMPLE = 24, 16
# phase 2k's depth on the paper's LSTM: an iteration is beta = 5 epochs of 4
# minibatches of 100 lines, each SGD step about 5,500 eager launches (the
# 80-step recurrence of two layers, forward and backward), about 2.7 s on one
# H100, so the depth is cut from the paper's 5,000-10,000 to keep 2k near a
# minute (the whole script took 1,024 s of its 1,200 with a depth of 10 and
# 1,065 s with 6, on slow hosts)
LSTM_ITERATIONS = 4
LSTM_EVAL_EVERY = 2
# phase 3k: the bench tasks, card against CPU (Google FL's cohort of 10 needs
# more than 10 nodes to draw from)
SMALL_DAGFL_NODES, SMALL_BASELINE_NODES = 8, 12
OBS_ITERATIONS = 100        # phase 2g's depth: each path runs twice (telemetry off, on)
FAULT_ITERATIONS = 100      # phase 2h's depth: each faulted path beside its unfaulted run
# phase 2l's depth and its profiled window's: an INFER batch is about 120
# eager launches (3 ms of host on one H100), about 300 of them an iteration,
# so the depth is cut from 20 (29.5 simulated s, 2,900 requests; 269 s the
# phase, most of it parsing a profile of 8 iterations) to 8, and the window
# to one iteration (73 s of parsing at 2)
SERVE_ITERATIONS = 8
SERVE_PROFILED_ITERATIONS = 1
# the served model (2i): qwen3-0.6b's prefill length, the decode batch (the
# decode_32k shape's 128 cut to 8, 30.1 GB of cache at its 32k context), the
# steps timed and profiled, and the slot server's load
MODEL_PREFILL = 8192
SHAPE_DECODE_32K = 32768
MODEL_DECODE_BATCH = 8
MODEL_DECODE_STEPS = 16
MODEL_PROFILED_STEPS = 8
SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 512, 32
# bf16 decode_step against forward's last logits (2i (a)): the two paths
# round in other places (matmuls of 1 row against S + 1; the decode kernel's
# 512-slot splits against the prefill kernel's 64-key blocks), which moved
# the logits by at most 0.043 and by 0.0067 on average at S = 64, 1,024 and
# 8,192 (scripts/torch_decode_gap.py); the f32 twin keeps the reference's 2e-2
BF16_DECODE_ATOL, BF16_DECODE_MEAN = 6e-2, 1e-2
# attention, kernel vs plain in f32 on the same inputs: relative to each
# output's sum_j p_j |v_j| (sums in another order), plus a bf16 ulp in bf16
ATTN_TOL = 1e-5
# the model distance, kernel vs plain: relative to each entry's sum of
# absolute terms sq_i + sq_j + 2 |x_i . x_j| (sums in another order; the
# diagonal cancels to near 0)
DIST_TOL = 1e-5
# the RWKV model (2j): rwkv6-7b's parameters (the reference's Model.init
# leaves; ModelConfig.param_count's 8,858,370,048 counts 3 d d_ff a layer
# where the blocks hold 2 d d_ff + d^2), its prefill length and the f32
# twin's, the decode steps held to forward's logits, and the decode batch:
# decode_32k's 128, not cut (the state is 32 MB a sequence, whatever the
# context)
RWKV_PARAMS = 7_534_952_448
RWKV_PREFILL, RWKV_TWIN_PREFILL, RWKV_DECODE_CHECK = 8192, 1024, 32
RWKV_DECODE_BATCH, RWKV_DECODE_STEPS, RWKV_PROFILED_STEPS = 128, 16, 8
# the WKV kernel, relative to each output's sum of absolute terms (the same
# function on |r|, |k|, |v|, |u|, |state|): against its plain version run in
# f32 (f32 sums in another order), and against the sequential scan (the
# chunked form's cum_prev - cum cancels under strong decays; the
# reference's own bound for its chunked form against its scan)
WKV_TOL, WKV_SCAN_TOL = 1e-5, 5e-4
# bf16 rwkv6-7b prefill and decode_step against forward (2j (a)): any
# rounding-level change of an f32 intermediate flips bf16 roundings that the
# 32 layers carry to the logits: at most 0.34-0.41 and 0.045-0.064 on
# average at S = 64, 1,024 and 8,192, with the matmuls padded to forward's
# rows and with forward's WKV through the scan alike, while bf16's forward
# itself lies 0.47-0.54 (0.069-0.073 on average) from the f32 forward
# (scripts/torch_decode_gap.py --arch rwkv6-7b); the f32 twin keeps 2e-2
RWKV_BF16_DECODE_ATOL, RWKV_BF16_DECODE_MEAN = 0.6, 0.08
# phase 2m: launch/train.py's defaults (4 nodes of 4 sequences of 128
# tokens), cut from its 50 steps to 10, run twice
TRAIN_NODES, TRAIN_STEPS = 4, 10
# phase 3m, card against CPU (reduced qwen3-0.6b, f32): a gradient entry
# within 1e-4 of its leaf's largest (reads 1.6e-6 on an H100, PERF.md); the
# parameters after two steps at lr 0.3 within 1e-6, ~8 f32 units at a norm
# scale's 1.0 (read 1.8e-7; a leaf's change from init is 4.6e-3 to 0.23)
TRAIN_GRAD_SHARE, TRAIN_PARAM_ATOL = 1e-4, 1e-6
# exponentials a second on the special-function units: 16 a clock per SM
# (CUDA C++ programming guide, compute capability 9.0), 132 SMs, 1.98 GHz
PEAK_EXP_PER_S = 16 * 132 * 1.98e9


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


def fedavg_error(rows, slots, weights, got, want):
    """(within the bar, largest error) of the Eq.-(1) kernel's output
    against its plain version on the same rows, slots and weights: in f32
    within F32_TOL; in bf16 within one bf16 unit plus 1e-6 of sum_j |w_j x_j|
    (both sides round an f32 sum once; sums a hair apart may round to
    neighbours)."""
    err = (got.float() - want.float()).abs()
    if rows.dtype == torch.bfloat16:
        picked = rows[slots.long().clamp(0, rows.shape[0] - 1)].float()
        scale = (weights.abs()[:, None] * picked.abs()).sum(0)
        tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + 1e-6 * scale
        return bool((err <= tol).all()), float(err.max())
    return float(err.max()) <= F32_TOL, float(err.max())


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
    ok, max_abs_err = fedavg_error(rows, sets[0][1], sets[0][2], got, want)
    check(ok, f"{name}: kernel off its plain version by {max_abs_err}, past its bar")

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
    # the paper's LSTM (phase 2k): k = 2 rows of 820,522 at the 16-byte stride
    rows = fedavg.alloc_rows(MAIN_SLOTS, LSTM_P, torch.float32, dev)
    rows.normal_(generator=gen)
    cases.append(fedavg_case(fedavg, "main_lstm_k2", rows, 2, 0, gen))
    del rows
    # the reference kernel's own (weights, models) signature: slot = arange(k)
    models = torch.randn((3, 1_000_003), generator=gen, device=dev)
    w = torch.tensor([0.2, 0.3, 0.5], device=dev)
    got, want = fedavg.fedavg(w, models), fedavg.fedavg_gather_plain(models, torch.arange(3, device=dev), w)
    torch.cuda.synchronize()
    check(float((got - want).abs().max()) <= F32_TOL, "fedavg(weights, models) disagrees")
    torch.cuda.empty_cache()
    return cases


def gossip_case(gm, name, r, rr, cap, offset, density, gen, reps=40, masks=None):
    """One shape of the merge-winner kernel: bitwise against the plain
    version, then times. The state has key ties, equal times under other
    publishers and rows nobody holds. ``masks``, where given, replace the
    density's one mask: the calls cycle through them."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    pub = torch.randint(-1, 4, (r, cap), dtype=torch.int32, **kw)
    pub[:, ::37] = -1
    t = torch.randint(0, 4, (r, cap), **kw).float() * 0.5
    ac = torch.randint(0, 6, (r, cap), dtype=torch.int32, **kw)
    if masks is None:
        masks = [torch.rand((rr, r), **kw) < density]
    row_ids = None if offset is None else offset + torch.arange(rr, device=dev)
    max_abs_err = 0.0
    for mask in masks:
        got = gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
        want = gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name}: gossip_winner differs from its plain version (max abs err {err})")
        max_abs_err = max(max_abs_err, err)

    cycle = [(masks[k % len(masks)],) for k in range(reps)]
    kernel = lambda mask: gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
    plain = lambda mask: gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
    ms = device_ms(kernel, cycle)
    # the plain version launches about 30 kernels a call: 40 calls queued
    # behind the spin would fill CUDA's launch queue and block the host
    plain_ms = device_ms(plain, cycle[:8])
    wrapper_call_ms = call_ms(kernel, cycle)
    # least bytes: the three (R, cap) columns and the mask read once, the two
    # outputs written once; least operations: every admitted candidate
    # (the receiver always admitted) checked once, the mean over the masks
    nbytes = 3 * r * cap * 4 + rr * r + 2 * rr * cap * 4
    ids = (0 if offset is None else offset) + torch.arange(rr, device=dev)
    own = ids[:, None] == torch.arange(r, device=dev)[None, :]
    admitted = [int((m.bool() | own).sum()) for m in masks]
    checks = sum(admitted) * cap / len(masks)
    ops = GOSSIP_OPS_PER_CHECK * checks
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return {
        "case": name, "R": r, "Rr": rr, "cap": cap, "row_offset": offset,
        "density": density, "masks": len(masks),
        "live_edges_per_mask": (sum(admitted) - rr * len(masks)) / len(masks),
        "candidate_checks": checks, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "call_ms": wrapper_call_ms, "library_ms": None,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def events_batch_masks(gen, n, count):
    """``count`` masks of an events batch on path (d): 1-4 live edges drawn
    from ``k_regular(n, 8)``'s, with the diagonal the round adds."""
    from repro_torch.net.topology import k_regular

    edges = torch.nonzero(torch.from_numpy(k_regular(n, 8).adjacency)).cuda()
    masks = []
    for _ in range(count):
        live = int(torch.randint(1, 5, (1,), generator=gen, device="cuda"))
        pick = torch.randperm(len(edges), generator=gen, device="cuda")[:live]
        mask = torch.eye(n, dtype=torch.bool, device="cuda")
        mask[edges[pick, 0], edges[pick, 1]] = True
        masks.append(mask)
    return masks


def phase_gossip_kernel(gm, cuda_build, path_d=None):
    """Phase 1b: the winner at the main shape (density 0.5), the full
    overlay (every edge live: a ticks round), an events batch of path (d)
    (1-4 live edges; ``path_d``, the live edges a batch that path (d)
    really had, is recorded beside it), the union fold, a receiver block,
    ragged rows and 400 replicas; then the kernel's registers and shared
    memory."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = [
        gossip_case(gm, "main", MAIN_NODES, MAIN_NODES, MAIN_SLOTS, None, 0.5, gen),
        gossip_case(gm, "union", MAIN_NODES, 1, MAIN_SLOTS, None, 1.0, gen),
        gossip_case(gm, "block", MAIN_NODES, 25, MAIN_SLOTS, 50, 0.5, gen),
        gossip_case(gm, "ragged", MAIN_NODES, MAIN_NODES, 1000, None, 0.5, gen),
        gossip_case(gm, "scale", 400, 400, MAIN_SLOTS, None, 0.5, gen, reps=20),
        gossip_case(gm, "full", MAIN_NODES, MAIN_NODES, MAIN_SLOTS, None, 1.0, gen),
        gossip_case(gm, "events_batch", MAIN_NODES, MAIN_NODES, MAIN_SLOTS, None, None, gen,
                    masks=events_batch_masks(gen, MAIN_NODES, 40)),
    ]
    cases[-1]["path_d_live_edges_per_batch"] = path_d
    return {"cases": cases,
            "resources": kernel_resources(cuda_build, "gossip_merge.cu", ["gossip_winner_kernel"])}


@contextlib.contextmanager
def live_edge_count(gm, n):
    """Counts the live edges of every round's (n, n) mask that a run hands
    the merge winner while the wrapper is wrapped: one sum on the device a
    round, read after the run (no host sync in the loop). The round adds
    the diagonal, n entries; the union fold's (1, n) masks are not rounds.
    Yields a dict that holds the counts once the block has ended."""
    orig, sums, out = gm.gossip_winner, [], {}

    def spy(t, p, ac, mask, row_offset=None):
        if mask.shape == (n, n):
            sums.append(mask.sum(dtype=torch.int64))
        return orig(t, p, ac, mask, row_offset=row_offset)

    gm.gossip_winner = spy
    try:
        yield out
    finally:
        gm.gossip_winner = orig
        live = torch.stack(sums) - n if sums else torch.zeros(0, dtype=torch.int64)
        out.update(rounds=len(sums), mean_live_edges=float(live.double().mean()) if sums else None,
                   max_live_edges=int(live.max()) if sums else None)


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
        "wallclock_s": float(res.times[-1]),
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


def check_same_run(what, a, b, counters=("sync_rounds", "approvals_issued", "approvals_in_union")):
    """Two runs of the gossip path agree: curve, latency, the union's and
    every replica's ledger columns (integer columns and times), and
    ``counters``."""
    check(a.avg_latency == b.avg_latency, f"{what}: avg latency differs")
    for name in ("iters", "times", "accs"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differ: {getattr(a, name)} vs {getattr(b, name)}")
    for part, da, db in (("union", a.extras["dag"], b.extras["dag"]),
                         ("replicas", a.extras["replicas"].dags, b.extras["replicas"].dags)):
        for name in LEDGER_COLUMNS:
            check(torch.equal(getattr(da, name).cpu(), getattr(db, name).cpu()),
                  f"{what}: {part} {name} differs")
    for key in counters:
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


# each count of cuda_build.LAUNCHES and the kernels its wrapper launches
PROFILED_KERNELS = {
    "fedavg_gather": ("fedavg_gather_kernel",), "gossip_winner": ("gossip_winner_kernel",),
    "chunk_dedup": ("chunk_dedup_kernel",), "quant_blocks": ("quant_leaves_kernel",),
    "topk_blocks": ("topk_blocks_kernel",), "event_pop": ("event_pop_kernel",),
    "hist_bincount": ("hist_cluster_kernel", "hist_atomic_kernel"),
}


def phase_profile(system="run_dagfl", label=None, iterations=PROFILED_ITERATIONS, **options):
    """A path again, shorter, under ``torch.profiler``: the device's busy
    share and where its time goes. The profiler slows the host, so these
    times are not the main path's. ``options`` go to the entry point."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl import systems
    from repro_torch.fl.tasks import CNNTask
    from torch.profiler import ProfilerActivity, profile

    dcfg = CNN_TASK.dagfl
    nodes, gval = paper_setup(dcfg.num_nodes, 28)
    sim = systems.SimConfig(iterations=iterations, eval_every=EVAL_EVERY,
                            minibatch=dcfg.minibatch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = getattr(systems, system)(CNNTask(), nodes, dcfg, sim, gval, device="cuda",
                                       **options)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    out = {"system": label or system, "iterations": iterations,
           **trace_summary(prof, wall_ms)}
    if "device_ops" not in out:
        return out
    spans = device_spans(prof)
    for kernel, names in PROFILED_KERNELS.items():
        us = [end - start for start, end, name in spans if any(n in name for n in names)]
        out[f"{kernel}_in_loop"] = {"launches": len(us), "ms_total": sum(us) / 1e3,
                                    "ms_mean": sum(us) / 1e3 / max(len(us), 1)}
    batches = res.extras.get("events_processed", 0)
    if batches:
        out["event_batches"] = batches
        out["host_syncs_per_batch"] = out["host_syncs"] / batches
    return out


def device_spans(prof):
    """(start, end, name) of the device events of a trace, without the
    ranges telemetry's annotations (``repro_torch.net.<entry point>``)
    mirror onto the device timeline."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("repro_torch.")]


def trace_summary(prof, wall_ms):
    """A profiled window: the device's busy and idle share, its operations,
    the top ten by time, and the host syncs (stream synchronisations the
    runtime made: each read back of a device value is one)."""
    spans = device_spans(prof)
    if not spans:
        return {"wall_ms": wall_ms,
                "device_busy_ms": "not measured (no device events in the trace)"}
    busy_us, cur_end = 0.0, float("-inf")
    by_name = {}
    for start, end, name in sorted(spans):
        busy_us += max(0.0, end - max(start, cur_end))
        cur_end = max(cur_end, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms, "device_ops": len(spans),
            "top_device_ms": {name[:80]: us / 1e3 for name, us in top},
            "host_syncs": sum(1 for e in prof.events() if e.name == "cudaStreamSynchronize")}


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


@contextlib.contextmanager
def bank_devices():
    """The device types of the model bank at every ``bank_write`` of a run
    (genesis and each commit) while the block runs."""
    from repro_torch.core import bank as bank_lib

    orig, seen = bank_lib.bank_write, set()

    def spy(bank, slot, params):
        seen.add(bank.rows.device.type)
        return orig(bank, slot, params)

    bank_lib.bank_write = spy
    try:
        yield seen
    finally:
        bank_lib.bank_write = orig


def timed_system(cuda_build, system, task, nodes, gval, dcfg, sim):
    """One run of ``SYSTEMS[system]`` on the card from a copy of ``nodes``
    (whose rng streams a run consumes): the result, its wall s, the kernel
    launches and the peak memory."""
    from repro_torch.fl.systems import SYSTEMS

    nodes = copy.deepcopy(nodes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = SYSTEMS[system](task, nodes, dcfg, sim, gval, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    return res, wall_s, dict(cuda_build.LAUNCHES), torch.cuda.max_memory_allocated()


def check_model(what, res, params_expected):
    params = res.final_params
    check(all(p.is_cuda for p in params.values()), f"{what}: final params are not on the card")
    check(sum(p.numel() for p in params.values()) == params_expected,
          f"{what}: {sum(p.numel() for p in params.values())} parameters, not {params_expected}")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          f"{what}: non-finite params")
    check(len(res.accs) > 0 and bool(np.isfinite(res.accs).all()),
          f"{what}: accuracies {res.accs}")


def system_summary(res, wall_s, iterations, peak):
    out = {"iterations": iterations, "run_s": wall_s, "ms_per_iteration": 1e3 * wall_s / iterations,
           "avg_latency_s": res.avg_latency, "wallclock_s": float(res.times[-1]),
           "last_acc": float(res.accs[-1]), "accs": [float(a) for a in res.accs],
           "peak_memory_bytes": peak}
    if "stage_ms" in res.extras:
        out["stage_ms"] = res.extras["stage_ms"]
    if "dropped" in res.extras:
        out["dropped"] = res.extras["dropped"]
    return out


def lstm_step_profile(task, nodes, dcfg, sim):
    """One SGD step and one validation of the paper's LSTM under
    ``torch.profiler``: device operations, device ms and wall ms each."""
    from repro_torch.fl.systems import _tb
    from torch.profiler import ProfilerActivity, profile

    params = task.init(0, "cuda")
    node = copy.deepcopy(nodes[0])
    train = _tb(node.minibatch(sim.minibatch), "cuda")
    val = _tb(node.val_batch(sim.val_size), "cuda")
    out = {}
    for name, fn in (("sgd_step", lambda: task.train_fn(params, train)),
                     ("validation", lambda: task.eval_fn(params, val))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
        out[name] = trace_summary(prof, wall_ms)
    step, val = out["sgd_step"].get("device_ops"), out["validation"].get("device_ops")
    if step is not None and val is not None:
        # beta epochs of steps_per_iter minibatches, alpha candidates and the
        # new model validated: the launches of one prepare, less its few others
        out["device_ops_per_prepare"] = dcfg.beta * sim.steps_per_iter * step + (dcfg.alpha + 1) * val
    return out


def phase_paper_experiments(cuda_build, main_path):
    """Phase 2k: the paper's experiments at full width. (a) ``run_dagfl``
    with the paper's LSTM (820,522 parameters) on the 100-node char
    population, through ``fedavg_gather``, twice, bitwise the same; (b) the
    three baselines on the paper's CNN at ``ITERATIONS`` and on the LSTM at
    ``LSTM_ITERATIONS``; Table II's two numbers per system and task, as
    ``iteration_delay_experiment`` computes them."""
    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK, LSTM_TASK
    from repro_torch.fl.experiments import make_lstm_setup
    from repro_torch.fl.systems import SimConfig
    from repro_torch.fl.tasks import CNNTask, LSTMTask

    dcfg, task = LSTM_TASK.dagfl, LSTMTask()     # 100 nodes, capacity 512, alpha 5, k 2, beta 5
    t = time.perf_counter()
    _, nodes, gval, _ = make_lstm_setup(num_nodes=dcfg.num_nodes)
    out = {"population_setup_s": time.perf_counter() - t}
    sim = SimConfig(iterations=LSTM_ITERATIONS, eval_every=LSTM_EVAL_EVERY,
                    minibatch=dcfg.minibatch)
    runs = []
    for _ in range(2):
        with bank_devices() as banks:
            res, wall_s, launches, peak = timed_system(cuda_build, "dagfl", task, nodes, gval,
                                                       dcfg, sim)
        dag = res.extras["dag"]
        check(dag.publisher.is_cuda and dag.approvers.is_cuda, "2k (a): ledger is not on the card")
        check(banks == {"cuda"}, f"2k (a): the bank was written on {banks}")
        check_model("2k (a)", res, LSTM_P)
        check(int(dag.count) == LSTM_ITERATIONS + 1,
              f"2k (a): ledger count {int(dag.count)} != {LSTM_ITERATIONS + 1}")
        expected = LSTM_ITERATIONS + res.extras["checks_with_tip"]
        check(launches.get("fedavg_gather", 0) == expected,
              f"2k (a): fedavg_gather launched {launches.get('fedavg_gather', 0)} times, "
              f"expected {expected} (prepares + controller checks with a tip)")
        runs.append((res, wall_s, launches, peak))
    (a, wall_s, launches, peak), (b, wall_b, _, _) = runs
    check(a.avg_latency == b.avg_latency, "2k (a): the repeat's latency differs")
    for name in ("iters", "times", "accs"):
        check(np.array_equal(getattr(a, name), getattr(b, name)), f"2k (a): the repeat's {name} differ")
    for name in LEDGER_COLUMNS + ("accuracy", "auth_tag"):
        check(same_bits(getattr(a.extras["dag"], name).cpu(), getattr(b.extras["dag"], name).cpu()),
              f"2k (a): the repeat's ledger {name} differs")
    for k in a.final_params:
        check(same_bits(a.final_params[k].cpu(), b.final_params[k].cpu()),
              f"2k (a): the repeat's final params {k} differ")
    out["lstm_dagfl"] = {**system_summary(a, wall_s, LSTM_ITERATIONS, peak),
                         "nodes": dcfg.num_nodes, "capacity": dcfg.capacity, "params": LSTM_P,
                         "checks": a.extras["checks"], "checks_with_tip": a.extras["checks_with_tip"],
                         "launches": launches, "repeat_run_s": wall_b, "repeat_bitwise": True}
    del runs, b
    out["lstm_profile"] = lstm_step_profile(task, nodes, dcfg, sim)

    cnn_dcfg = CNN_TASK.dagfl
    cnn_nodes, cnn_gval = paper_setup(cnn_dcfg.num_nodes, CNNTask().image_size)
    table2 = {"cnn": {"iterations": ITERATIONS,
                      "dagfl_avg_iter_latency_s": main_path["avg_latency_s"],
                      "dagfl_wallclock_s": main_path["wallclock_s"]},
              "lstm": {"iterations": LSTM_ITERATIONS,
                       "dagfl_avg_iter_latency_s": a.avg_latency,
                       "dagfl_wallclock_s": float(a.times[-1])}}
    for label, btask, bnodes, bgval, bdcfg, iterations, eval_every, params in (
            ("cnn", CNNTask(), cnn_nodes, cnn_gval, cnn_dcfg, ITERATIONS, EVAL_EVERY, MAIN_P),
            ("lstm", task, nodes, gval, dcfg, LSTM_ITERATIONS, LSTM_EVAL_EVERY, LSTM_P)):
        bsim = SimConfig(iterations=iterations, eval_every=eval_every, minibatch=bdcfg.minibatch)
        for system in ("google", "async", "block"):
            res, wall_s, launches, peak = timed_system(cuda_build, system, btask, bnodes, bgval,
                                                       bdcfg, bsim)
            what = f"2k (b) {system} on the {label}"
            check_model(what, res, params)
            # the baselines average and mix in plain PyTorch, as the reference does
            check(not launches, f"{what}: launched hand kernels {launches}")
            out[f"{label}_{system}"] = system_summary(res, wall_s, iterations, peak)
            table2[label][f"{system}_avg_iter_latency_s"] = res.avg_latency
            table2[label][f"{system}_wallclock_s"] = float(res.times[-1])
    out["table2"] = table2
    return out


@contextlib.contextmanager
def one_cpu_thread(on=True):
    """One intra-op CPU thread while the block runs: the LSTM's CPU run is
    thousands of small matmuls, and a full thread pool synchronising on
    each took 25.5 s of 3k in one run and 117.7 s in another."""
    before = torch.get_num_threads()
    if on:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def phase_small_paper_agreement():
    """Phase 3k: the bench LSTM through ``run_dagfl`` and the three baselines
    on the bench CNN and the bench LSTM, on the card and on the CPU with the
    same draws: latencies, times, ledger integer columns and accuracies
    equal, parameters within 1e-4."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup, make_lstm_setup
    from repro_torch.fl.systems import SYSTEMS, SimConfig

    out = {}
    cases = [("dagfl", "lstm", SMALL_DAGFL_NODES,
              SimConfig(iterations=4, eval_every=2, steps_per_iter=1, seed=0))]
    for task_name in ("cnn", "lstm"):
        # the LSTM: 11 iterations are still two of Google FL's rounds
        kw = dict(iterations=11, steps_per_iter=1, minibatch=16) if task_name == "lstm" \
            else dict(iterations=20)
        cases += [(system, task_name, SMALL_BASELINE_NODES,
                   SimConfig(eval_every=5, seed=0, **kw))
                  for system in ("google", "async", "block")]
    for system, task_name, n, sim in cases:
        setup = make_cnn_setup if task_name == "cnn" else make_lstm_setup
        dcfg = default_dagfl_config(n, task_name)
        res = {}
        for device in ("cuda", "cpu"):
            task, nodes, gval, _ = setup(num_nodes=n, abnormal="lazy", num_abnormal=2, seed=0)
            kw = {}
            if system == "dagfl":
                kw["draw"] = small_draws(device, n, dcfg.capacity)[0]
            with one_cpu_thread(device == "cpu"):
                res[device] = SYSTEMS[system](task, nodes, dcfg, sim, gval, device=device, **kw)
        g, c = res["cuda"], res["cpu"]
        what = f"3k {system} on the bench {task_name}"
        check(g.avg_latency == c.avg_latency, f"{what}: avg latency differs")
        check(np.array_equal(g.iters, c.iters) and np.array_equal(g.times, c.times),
              f"{what}: curve times differ")
        check(np.array_equal(g.accs, c.accs), f"{what}: accuracies differ: {g.accs} vs {c.accs}")
        check(g.extras.get("dropped") == c.extras.get("dropped"), f"{what}: dropped differs")
        if system == "dagfl":
            dg, dc = g.extras["dag"], c.extras["dag"]
            for name in ("publisher", "approvals", "approval_count", "model_slot", "count",
                         "published_per_node", "contributing_m0", "contributing_m1"):
                check(torch.equal(getattr(dg, name).cpu(), getattr(dc, name)),
                      f"{what}: ledger {name} differs")
        diff = max(float((g.final_params[k].cpu() - c.final_params[k]).abs().max())
                   for k in c.final_params)
        check(diff <= 1e-4, f"{what}: final params differ by {diff}")
        out[f"{system}_{task_name}"] = {"final_params_max_abs_diff": diff,
                                        "accs": [float(a) for a in g.accs],
                                        "dropped": g.extras.get("dropped")}
    return out


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


def leaves_of(dc, row, layout, own):
    """A flat payload's leaves, as the layout slices it: views of the row
    (offsets not 16-byte aligned), or with ``own`` tensors of their own, as
    a trained model's leaves are."""
    fv = layout.first_value
    views = {name: row[v0:v1] for name, v0, v1 in zip(layout.names, fv, fv[1:])}
    return {name: v.clone() for name, v in views.items()} if own else views


def fused_case(dc, name, layout, case, qmax, gen, reps=40, own=True):
    """Quantisation with the decoded payload in the same launch
    (``quant_params(..., decode=True)``, what the codec's commit runs): the
    codes, scales and decoded payload bitwise against ``quant_blocks_plain``
    and ``dequant_blocks_plain``, then times: the launch, the same launch
    without the decoded payload, the plain version, and the bound (bytes:
    the payload read once, codes, scales and the decoded payload written
    once), and, as a yardstick of what the card moves at this size, one
    PyTorch copy of the payload."""
    rows = codec_rows(gen, layout, case, qmax)
    params = [leaves_of(dc, row, layout, own) for row in rows]
    args = [(params[i % len(params)], layout, qmax) for i in range(reps)]
    codes, scales, decoded = dc.quant_params(*args[0], decode=True)

    def plain(p, layout, qmax):
        c, sc = dc.quant_blocks_plain(dc.blocked(dc.flatten_params(p), layout), qmax)
        return c, sc, dc._unblocked(dc.dequant_blocks_plain(c, sc), layout)

    want_c, want_s, want_d = plain(*args[0])
    torch.cuda.synchronize()
    max_abs_err = max(bits_err(codes, want_c), bits_err(scales, want_s),
                      bits_err(decoded, want_d))
    check(same_bits(codes, want_c) and same_bits(scales, want_s) and same_bits(decoded, want_d),
          f"fused quant {name}: differs from its plain version (max abs err {max_abs_err})")
    ms = device_ms(lambda p, layout, qmax: dc.quant_params(p, layout, qmax, decode=True), args)
    quant_ms = device_ms(dc.quant_params, args)
    plain_ms = device_ms(plain, args[:8])
    # yardstick: PyTorch's copy of the same payload (its reads, P values written)
    copies = [(torch.empty_like(row), row) for row in rows]
    copy_ms = device_ms(lambda dst, src: dst.copy_(src), copies * (reps // len(copies)))
    wrapper_call_ms = call_ms(lambda p, layout, qmax: dc.quant_params(p, layout, qmax, decode=True),
                              args)
    nb, p = layout.num_blocks, layout.num_values
    nbytes = 8 * p + nb * layout.block + 4 * nb
    return {"case": name, "qmax": qmax, "values": p, "blocks": nb, "leaves": len(layout.names),
            "own_leaves": own, "max_abs_err": max_abs_err, "ms": ms, "quant_only_ms": quant_ms,
            "plain_ms": plain_ms, "library_ms": None, "call_ms": wrapper_call_ms,
            "payload_copy_ms": copy_ms,
            **codec_bound(nbytes, (QUANT_OPS_PER_VALUE + 1) * p)}


def encode_decode_check(dc, params, kind):
    """``DeltaCodec.encode_decode`` on the card: ``encode``'s keys and
    tensors and ``decode(encode(...))``'s payload, bitwise, in one launch."""
    base = {k: v * 0.9 for k, v in params.items()}
    codec = dc.DeltaCodec(kind)
    enc, dec = codec.encode_decode(params, base)
    want = codec.encode(params, base)
    want_dec = codec.decode(want, base)
    torch.cuda.synchronize()
    check(enc.keys() == want.keys()
          and all(enc[k].keys() == want[k].keys() for k in enc), f"encode_decode {kind}: keys")
    for part in enc:
        for leaf in enc[part]:
            check(same_bits(enc[part][leaf], want[part][leaf]),
                  f"encode_decode {kind}: {part} {leaf} differs from encode")
    for leaf in dec:
        check(dec[leaf].shape == base[leaf].shape and same_bits(dec[leaf], want_dec[leaf]),
              f"encode_decode {kind}: {leaf} differs from decode(encode)")
    return {"kind": kind, "leaves": len(dec), "bitwise": True}


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
    # the leaf table read once; operations: the selection's, at most 32
    # integer steps a value (31 search steps or 2 k rounds, then the ties)
    nb, p = layout.num_blocks, layout.num_values
    nbytes = (8 if with_base else 4) * p + 4 * nb * layout.block + 16 * (len(layout.names) + 1)
    return {"case": name, "k": k, "block": layout.block, "values": p, "blocks": nb,
            "leaves": len(layout.names), "with_base": with_base, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch.topk(|d|, k, dim=1) + scatter",
            "call_ms": wrapper_call_ms, **codec_bound(nbytes, 32 * nb * layout.block)}


def phase_codec_kernel(dc, cuda_build):
    """Phase 1d: both codec kernels at the main path's shape (the paper's
    CNN blocked leaf by leaf), a ragged model, all-zero blocks, exact halves,
    ties with NaN and -0.0, k >= nnz and a 4x scale; quantisation also with
    the decoded payload in the same launch (the commit's encode + decode:
    the CNN's own leaf tensors, the ragged model's unaligned views, zero
    blocks, halves, 4x scale) and ``encode_decode`` against ``decode(
    encode())`` on the CNN; top-k also at k = 32 and 33 on the main shape
    (the last k of the warp's rounds, the first of its bitwise search) and
    in blocks of 1,024; then the kernels' registers and spills."""
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
    quant, fused, topk = [], [], []
    for kind, qmax in (("int8", 127), ("int4", 7)):
        quant += [
            quant_case(dc, f"main_{kind}", main, "random", qmax, gen),
            quant_case(dc, f"ragged_{kind}", ragged, "random", qmax, gen),
            quant_case(dc, f"zero_blocks_{kind}", dense, "zero", qmax, gen),
            quant_case(dc, f"halves_{kind}", dense, "halves", qmax, gen),
            quant_case(dc, f"scale_4x_{kind}", scale, "random", qmax, gen, reps=20),
        ]
        fused += [
            fused_case(dc, f"main_{kind}", main, "random", qmax, gen),
            fused_case(dc, f"ragged_{kind}", ragged, "random", qmax, gen, own=False),
            fused_case(dc, f"zero_blocks_{kind}", dense, "zero", qmax, gen),
            fused_case(dc, f"halves_{kind}", dense, "halves", qmax, gen),
            fused_case(dc, f"scale_4x_{kind}", scale, "random", qmax, gen, reps=20),
        ]
    cnn = {k: v.cuda() + 0.01 for k, v in CNNTask().init(0, "cpu").items()}
    checks = [encode_decode_check(dc, cnn, kind) for kind in ("int8", "int4", "topk")]
    topk += [
        topk_case(dc, "main", main, "random", 8, gen),
        topk_case(dc, "ragged", ragged, "random", 8, gen),
        topk_case(dc, "ties_nan_zeros", dense, "ties", 8, gen, with_base=False),
        topk_case(dc, "k_ge_nnz", dense, "sparse", None, gen, with_base=False),
        topk_case(dc, "k_128", ragged, "random", 128, gen),
        topk_case(dc, "scale_4x", scale, "random", 8, gen, reps=20, with_base=False),
        topk_case(dc, "main_k32", main, "random", 32, gen),
        topk_case(dc, "main_k33", main, "random", 33, gen),
        topk_case(dc, "block_1024", dc.dense_layout(MAIN_CODEC_BLOCKS // 8, 1024), "ties", 64,
                  gen, with_base=False),
    ]
    torch.cuda.empty_cache()
    resources = kernel_resources(cuda_build, "delta_codec.cu",
                                 [f"quant_leaves_kernel<{j}>" for j in (1, 2, 4, 8)]
                                 + [f"topk_blocks_kernel<{v}>" for v in (1, 2, 4, 8, 16, 32)])
    return {"quant": quant, "fused": fused, "topk": topk, "encode_decode": checks,
            "resources": resources}


def dedup_case(ck, name, r, s, c, classes, special, gen, reps=40):
    """One shape of the chunk-dedup kernel: bitwise against the plain
    version, then times. Digests fall into ``classes`` duplicate classes;
    ``special`` adds NaN and -0.0/+0.0 digests."""
    dev = torch.device("cuda")
    kw = dict(generator=gen, device=dev)
    dig = torch.randint(0, classes, (s, c), **kw).float()
    if special == "columns":              # all NaN, only +-0.0, one value, half empty
        dig[:, 0] = float("nan")
        dig[:, 1] = torch.where(torch.rand(s, **kw) < 0.5, -0.0, 0.0)
        dig[:, 2] = 3.5
        dig[: s // 2, 3] = 0.0
    elif special:
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


def phase_dedup_kernel(ck, cuda_build):
    """Phase 1c: the dedup at a tick's shape, the gate (R = 1), ragged,
    NaN and signed zeros, one class, 400 replicas, the edge columns (all
    NaN, only +-0.0, one value, half empty slots) and a store past one hash
    table; then the kernel's registers and shared memory."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [
        dedup_case(ck, "main", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen),
        dedup_case(ck, "gate", 1, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen),
        dedup_case(ck, "ragged", 37, 1000, 3, 100, False, gen),
        dedup_case(ck, "nan_and_zeros", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 8, True, gen),
        dedup_case(ck, "one_class", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 1, False, gen),
        dedup_case(ck, "scale", 400, MAIN_SLOTS, MAIN_CHUNKS, 64, False, gen, reps=20),
        dedup_case(ck, "edge_columns", MAIN_NODES, MAIN_SLOTS, MAIN_CHUNKS, 1 << 20, "columns",
                   gen),
        dedup_case(ck, "past_table", 33, 2049, 2, 64, True, gen, reps=20),
    ]
    return {"cases": cases,
            "resources": kernel_resources(cuda_build, "chunk_dedup.cu", ["chunk_dedup_kernel"])}


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
        idx, found, head_t, kind, head = ep.pop_head(*args)
        mirror = [idx, int(found), int(np.float32(head_t).view(np.int32)), kind]
        check(mirror == head.tolist() == want.tolist(),
              f"event_pop {name}: pop_head's mirror {mirror}, its device words "
              f"{head.tolist()}, plain {want.tolist()}")
    ms_hot = device_ms(ep.event_head, [args] * reps)
    ms_cold = None
    if cold:
        copies = -(-POP_COLD_BYTES // (EVENT_POP_BYTES_PER_SLOT * q))
        ms_cold = device_ms(ep.event_head, [pop_queue(gen, q, case) for _ in range(copies)])
    # the plain version launches about 15 kernels a call: 8 calls behind the spin
    plain_ms = device_ms(ep.event_head_plain, [args] * 8)
    # what the event loop pays per batch for its head: the launch, the
    # read back and the host's own work; through the pinned mirror
    # (pop_head, the loop's call) and through a copy (read_head)
    head_ms = call_ms(ep.pop_head, [args] * reps)
    read_head_ms = call_ms(lambda *a: ep.read_head(ep.event_head(*a)), [args] * reps)
    # least bytes: each slot's time, kind, seq (4 B each) and valid (1 B)
    # read once, the four output words written once; its compares are far less
    nbytes = EVENT_POP_BYTES_PER_SLOT * q + 16
    return {"case": name, "Q": q, "queue": case, "max_abs_err": max_abs_err,
            "ms": ms_hot if ms_cold is None else ms_cold, "ms_hot": ms_hot, "ms_cold": ms_cold,
            "plain_ms": plain_ms, "pop_and_read_back_ms": head_ms,
            "event_head_and_read_head_ms": read_head_ms, "library_ms": None,
            "cluster_blocks": ep.cluster_blocks(q),
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "bound_bytes": nbytes}


def kernel_resources(cuda_build, source, kernels):
    """Registers, spills, stack and static shared memory of each of
    ``kernels`` (``name``, or ``name<V>`` for a template on an int, on
    ``uint8_t`` or on ``int32_t``) in the -Xptxas=-v report of ``source``'s
    build log."""
    import re

    log = cuda_build.library_path(cuda_build.CSRC / source).with_suffix(".log")
    out, name = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)(?:I(Li(\d+)|h|i)E)?",
                          line)
        if entry:
            arg = entry.group(3) or {"h": "uint8_t", "i": "int32_t", None: None}[entry.group(2)]
            name = entry.group(1) + (f"<{arg}>" if arg else "")
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    check(set(kernels) <= set(out), f"{source}'s build log names {sorted(out)}, not {kernels}")
    return {k: out[k] for k in kernels}


def phase_event_pop_kernel(ep, cuda_build):
    """Phase 1e: the queue head at the engine's three queue sizes (the full
    overlay's 9,900 delivery slots; 19,800 with the bank's drain slots;
    9,965 in the tip simulation), the edge cases, the sizes either side of
    a pass of the 8 x 1,024-thread cluster and a million slots; then the
    kernel's registers, shared memory and cluster size at each Q."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    q_tip = MAIN_NODES * (MAIN_NODES - 1) + TIP_SIM_PENDING + 1
    cases = [
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
        pop_case(ep, "q8191", 8191, "ties", gen, draws=20),
        pop_case(ep, "q8193", 8193, "inf_nan", gen, draws=20),
        pop_case(ep, "q1000003", 1_000_003, "ties", gen, reps=40),
    ]
    return {"cases": cases,
            "resources": kernel_resources(cuda_build, "event_pop.cu", ["event_pop_kernel"])}


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
    from repro_torch.kernels import gossip_merge

    with live_edge_count(gossip_merge, MAIN_NODES) as live:
        out["d_k_regular_jitter"] = phase_gossip_main_path(
            cuda_build, "events (d)", iterations=JITTER_ITERATIONS, engine="events",
            topology=k_regular(MAIN_NODES, 8, link_latency=0.5, latency_jitter=1.0, seed=0))[0]
    out["d_k_regular_jitter"]["live_edges_per_batch"] = live
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
# inference serving under gossip: full width (2l), card vs CPU (3l)
# ---------------------------------------------------------------------------


def serve_options(serve, **extra):
    """Phase 2l's path: events path (c) raw, full(100) with 0.5 s links at
    1 Mbit/s, phi = 7 MB in 4 chunks, with ``serve`` (a ``ServeConfig`` or
    None)."""
    return dict(events_constrained_runs()["raw"], engine="events", serve=serve, **extra)


def same_serve_report(what, a, b):
    check(a.keys() == b.keys(), f"{what}: serve report keys differ")
    for key, value in a.items():
        same = (np.array_equal(value, b[key]) if isinstance(value, np.ndarray)
                else value == b[key] or (value != value and b[key] != b[key]))
        check(same, f"{what}: serve report {key} differs: {value} vs {b[key]}")


def check_same_transport(what, a, b):
    """Two banked runs with the same transport: ``check_same_run`` but for
    the batch count and the dispatch labels (a serving run's INFER batches
    count in both), the floats, the transport state and the edge draws."""
    check_same_run(what, a, b, counters=("approvals_issued", "approvals_in_union"))
    check_same_floats(what, a, b)
    check(a.extras["edge_draws"] == b.extras["edge_draws"], f"{what}: edge draws differ")
    for name in ("have", "credit", "sent"):
        check(torch.equal(getattr(a.extras["replicas"].bank_state, name).cpu(),
                          getattr(b.extras["replicas"].bank_state, name).cpu()),
              f"{what}: transport {name} differs")


def phase_serve_main_path(cuda_build):
    """Phase 2l, inference serving at full width: ``run_dagfl_gossip`` with
    ``serve=ServeConfig()`` (1 request/s a node, 4 slots, 0.05 s a batch,
    queue 64) on events path (c) raw at ``SERVE_ITERATIONS``.

    The serving run repeats bitwise (the repeat is the run with telemetry
    below, which only reads); rate 0 and ``serve=None`` are one run bitwise,
    and the serving run's ledgers and transport are theirs (serving only
    reads). Requests are conserved, no batch exceeds its
    slots, every node's arrivals equal the host replay of its draws up to
    the last advance, and on these links the gated staleness is positive.
    The launches: one winner a round that drew, a union fold a check and
    one more a snapshot (as every run), plus one union fold an INFER batch;
    one dedup a batch, INFER batches included. Then the same with telemetry
    and the histograms (bitwise the serving run; ``queue_wait`` and
    ``serve_stale`` sampled), and a profiled window of the serving and the
    serve-free run at ``SERVE_PROFILED_ITERATIONS``: device operations and
    host syncs an INFER batch, the device's idle share."""
    from repro_torch.net.serve import ServeConfig, arrival_times
    from repro_torch.obs import HistConfig, ObsConfig

    cfg = ServeConfig()
    n = SERVE_ITERATIONS
    runs = {}
    phase_s = {}
    t = time.perf_counter()
    for name, serve in (("serve", cfg), ("rate0", ServeConfig(rate=0.0)), ("none", None)):
        runs[name] = full_width_run(cuda_build, n, **serve_options(serve))
    phase_s["three_runs"] = time.perf_counter() - t
    (res, wall_s, launches), (none, none_s, none_launches) = runs["serve"], runs["none"]
    ex = res.extras
    rep = ex["serve_report"]
    check(res.extras["replicas"].dags.publisher.is_cuda, "serve: replicas are not on the card")
    check(ex["events_capped"] == 0, f"serve: {ex['events_capped']} advances capped")
    # the degenerate limit, and serving as a pure reader
    rate0 = runs["rate0"][0]
    check_same_bank_run("serve rate 0 vs None", rate0, none, 0.0)
    check_same_floats("serve rate 0 vs None", rate0, none)
    for key in ("edge_draws", "events_processed", "dispatch_counts"):
        check(rate0.extras[key] == none.extras[key], f"serve rate 0: {key} differs")
    check("serve_report" not in rate0.extras and "serve_report" not in none.extras,
          "serve: a report without serving")
    check(runs["rate0"][2] == none_launches, "serve rate 0: launches differ from serve=None")
    check_same_transport("serve vs serve-free", res, none)
    infer = ex["events_processed"] - none.extras["events_processed"]
    check(infer > 0, "serve: no INFER batch ran")
    # conservation, the slot cap, staleness, the host replay
    arrived = rep["requests_served"] + rep["queued"] + rep["inflight"] + rep["dropped"]
    check(np.array_equal(rep["arrivals"], arrived), "serve: requests not conserved")
    check(bool(np.all(rep["requests_served"] + rep["inflight"] <= rep["batches"] * cfg.slots)),
          "serve: a batch exceeded its slots")
    check(rep["samples"] + rep["samples_dropped"] == int(rep["batches"].sum()),
          "serve: one staleness sample a batch")
    check(rep["staleness_max"] > 0, "serve: gated staleness never positive on 1 Mbit/s links")
    horizon = float(np.float32(res.times[-1]))         # the last commit's advance
    t = time.perf_counter()
    replay = [len(arrival_times(0, cfg, i, horizon)) for i in range(MAIN_NODES)]
    replay_s = time.perf_counter() - t
    check(np.array_equal(rep["arrivals"], np.asarray(replay)),
          f"serve: arrivals {rep['arrivals'].tolist()} vs the host replay {replay}")
    # launches: the serve-free run's, plus a union fold and a dedup an INFER batch
    expected = dict(none_launches)
    for kernel in ("gossip_winner", "chunk_dedup", "event_pop"):
        expected[kernel] = expected.get(kernel, 0) + infer
    advances = sum(ex["dispatch_counts"].values()) - ex["dispatch_counts"].get("bank_commit", 0)
    check(advances == sum(none.extras["dispatch_counts"].values())
          - none.extras["dispatch_counts"].get("bank_commit", 0), "serve: advances differ")
    for kernel in set(expected) | set(launches):
        check(launches.get(kernel, 0) == expected.get(kernel, 0),
              f"serve: {kernel} launched {launches.get(kernel, 0)} times, expected "
              f"{expected.get(kernel, 0)}")
    # telemetry with the histograms: the same run again (the repeat)
    t = time.perf_counter()
    obs, obs_s, obs_launches = full_width_run(cuda_build, n, **serve_options(
        cfg, obs=ObsConfig(hist=HistConfig())))
    check_same_transport("serve obs", obs, res)
    same_serve_report("serve obs", obs.extras["serve_report"], rep)
    report = obs.extras["obs"]
    for name in ("queue_wait", "serve_stale"):
        check(report.hist["counts"][name].sum() > 0, f"serve obs: {name} histogram empty")
    check(obs_launches.get("hist_bincount", 0) > 0, "serve obs: no histogram launch")
    phase_s["obs_run"] = time.perf_counter() - t
    # a profiled window, with and without serving
    t = time.perf_counter()
    prof, prof_none = (phase_profile("run_dagfl_gossip", label=f"serve={serve}",
                                     iterations=SERVE_PROFILED_ITERATIONS, **serve_options(serve))
                       for serve in (cfg, None))
    phase_s["profiles"] = time.perf_counter() - t
    window = {"serve": prof, "none": prof_none}
    prof_infer = prof.get("event_batches", 0) - prof_none.get("event_batches", 0)
    if "device_ops" in prof and "device_ops" in prof_none and prof_infer > 0:
        window["infer_batches"] = prof_infer
        window["device_ops_per_infer_batch"] = (prof["device_ops"] - prof_none["device_ops"]) \
            / prof_infer
        window["host_syncs_per_infer_batch"] = (prof["host_syncs"] - prof_none["host_syncs"]) \
            / prof_infer
    return {
        "iterations": n, "nodes": MAIN_NODES, "rate": cfg.rate, "slots": cfg.slots,
        "service_time_s": cfg.service_time, "queue_cap": cfg.queue_cap,
        "ms_per_iteration_serve": 1e3 * wall_s / n,
        "ms_per_iteration_none": 1e3 * none_s / n,
        "ms_per_iteration_rate0": 1e3 * runs["rate0"][1] / n,
        "ms_per_iteration_obs": 1e3 * obs_s / n,
        "simulated_s": horizon, "events_processed": ex["events_processed"],
        "infer_batches": infer, "infer_batches_per_iteration": infer / n,
        "delivery_batches": ex["edge_draws"],
        "arrived": rep["arrived_total"], "served": rep["served_total"],
        "dropped": rep["dropped_total"], "batches": int(rep["batches"].sum()),
        "staleness_p50": rep["staleness_p50"], "staleness_p99": rep["staleness_p99"],
        "staleness_max": rep["staleness_max"], "host_replay_s": replay_s,
        "hist": hist_percentiles(report), "launches": launches,
        "launches_serve_free": none_launches, "launches_obs": obs_launches,
        "profile": window, "phase_s": phase_s, "nvidia_smi": nvidia_smi_line(),
    }


def small_serve_draw(device, n):
    """Unit exponentials made with numpy per (node, count), the same on every
    device (the arrival draws of phase 3l)."""
    def draw(counts):
        c = counts.cpu().numpy()
        e = [np.random.default_rng([4, i, int(c[i])]).standard_exponential(dtype=np.float32)
             for i in range(n)]
        return torch.from_numpy(np.asarray(e, np.float32)).to(device)
    return draw


def phase_small_serve_agreement():
    """Phase 3l: a small banked serving run on the card and on the CPU with
    the same host-made draws (a lossy starved ring with jittered links and a
    partition that heals): ledgers, transport, the serve report and the
    curve bitwise, parameters within 1e-4; and the default counter-based
    draws (``torch_serve_draw``) give the same f32 values on both devices
    over a grid of 4,096 nodes and 64 counts each."""
    from repro_torch.fl.experiments import default_dagfl_config, make_cnn_setup
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.net.bank import BankGossipConfig
    from repro_torch.net.gossip import PartitionSchedule
    from repro_torch.net.serve import ServeConfig, torch_serve_draw
    from repro_torch.net.topology import ring, split_halves

    n = 8
    dcfg = default_dagfl_config(num_nodes=n)
    sim = SimConfig(iterations=12, eval_every=4, seed=0)
    out = {}
    for device in ("cuda", "cpu"):
        task, nodes, gval, _ = make_cnn_setup(num_nodes=n, seed=0)
        draw, edge_draw = small_draws(device, n, dcfg.capacity)
        out[device] = run_dagfl_gossip(
            task, nodes, dcfg, sim, gval,
            topology=ring(n, drop=0.3, bandwidth=1e7, link_latency=0.5, latency_jitter=1.0),
            partition=PartitionSchedule(split_halves(n), 5.0, 12.0),
            bank_gossip=BankGossipConfig(chunks_per_slot=MAIN_CHUNKS, slot_bytes=TABLE1_SLOT_BYTES),
            engine="events", serve=ServeConfig(rate=3.0, sample_capacity=256), device=device,
            draw=draw, edge_draw=edge_draw, serve_draw=small_serve_draw(device, n))
    g, c = out["cuda"], out["cpu"]
    diff = check_same_bank_run("serve small", g, c, 1e-4)
    for key in ("events_processed", "edge_draws"):
        check(g.extras[key] == c.extras[key], f"serve small: {key} differs")
    same_serve_report("serve small", g.extras["serve_report"], c.extras["serve_report"])
    rep = g.extras["serve_report"]
    check(rep["served_total"] > 0 and rep["staleness_max"] > 0,
          "serve small: nothing served, or never stale")
    counts = [torch.full((4096,), k, dtype=torch.int32) for k in range(64)]
    grid = {dev: torch.stack([torch_serve_draw(7, 13, 4096, dev)(k.to(dev)) for k in counts])
            for dev in ("cuda", "cpu")}
    check(same_bits(grid["cuda"].cpu(), grid["cpu"]), "serve draws: the card differs from the CPU")
    return {"final_params_max_abs_diff": diff, "events_processed": g.extras["events_processed"],
            "arrived": rep["arrived_total"], "served": rep["served_total"],
            "staleness_max": rep["staleness_max"], "draw_grid": [4096, 64]}


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


def record_batch(gen, case, cfg):
    """(counts, values, weights) on the card shaped like one of the loop's
    histogram updates: ``merge`` R * cap latencies of sync-period
    multiples, 2 % weighted (bool, as ``changed``); ``commit`` the cap rows
    of replica 0, 1 % weighted (bool); ``chunk`` R * cap latencies, 5 %
    weighted by 1-4 completed chunks (i32); ``uniform`` R * cap values
    log-uniform over the whole range and past it, every one weighted (i32)."""
    m = MAIN_SLOTS if case == "commit" else MAIN_NODES * MAIN_SLOTS
    kw = dict(generator=gen, device="cuda")
    counts = torch.randint(0, 1_000, (cfg.bins + 1,), dtype=torch.int32, **kw)
    if case == "uniform":
        span = np.log(cfg.hi / cfg.lo) + 6.0
        values = (cfg.lo * np.exp(-3.0)) * torch.exp(torch.rand((m,), **kw) * span)
        return counts, values.float(), torch.randint(1, 4, (m,), dtype=torch.int32, **kw)
    values = 0.25 * torch.randint(1, 33, (m,), **kw).float()
    p = {"merge": 0.02, "commit": 0.01, "chunk": 0.05}[case]
    w = torch.rand((m,), **kw) < p
    if case == "chunk":
        w = w.to(torch.int32) * torch.randint(1, MAIN_CHUNKS + 1, (m,), dtype=torch.int32, **kw)
    return counts, values, w


def record_case(hb, hist_lib, name, case, gen, reps=200):
    """One histogram update at a loop's shape: ``record`` (one launch)
    bitwise against ``record_plain`` (``bin_index``, the plain bincount and
    the add) on the same card tensors, ``counts`` unchanged; then times:
    the launch, the plain version, the parent's unfused path (``bin_index``,
    a cast, the idx route's kernel and the add), the call with the host in
    the loop, and the bound (bytes: values, weights and counts read once,
    the bins written once; operations: the binning of the weighted samples
    at the f64 and f32 peaks). No one PyTorch call bins on a log scale."""
    cfg = hist_lib.HistConfig()
    batches = [record_batch(gen, case, cfg) for _ in range(8)]
    for counts, values, w in batches:
        before = counts.clone()
        got = hist_lib.record(counts, values, w, cfg)
        want = hist_lib.record_plain(counts, values, w, cfg)
        torch.cuda.synchronize()
        max_abs_err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want) and torch.equal(counts, before),
              f"record {name}: kernel != plain ({max_abs_err} off) or counts written")
    lo, ratio, bins = hist_lib.bin_params(cfg)

    def unfused(counts, values, w):
        return counts + hb.hist_bincount(hist_lib.bin_index(values, cfg), w.to(torch.int32),
                                         bins + 1)

    def fused(counts, values, w):
        return hist_lib.record(counts, values, w, cfg)

    ms = device_ms(fused, batches * (reps // 8))
    # about 95 launches a call: four calls, or the queue behind the spin
    # fills and blocks the host
    plain_ms = device_ms(lambda c, v, w: hist_lib.record_plain(c, v, w, cfg), batches[:4])
    unfused_ms = device_ms(unfused, batches[:4])
    call = call_ms(fused, batches * 8)
    m = int(batches[0][1].shape[0])
    weighted = int((batches[0][2] != 0).sum())
    nbytes = 4 * m + batches[0][2].element_size() * m + 2 * 4 * (bins + 1)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    ops_s = weighted * (HIST_F64_OPS_PER_SAMPLE / PEAK_F64_FLOPS
                        + HIST_F32_OPS_PER_SAMPLE / PEAK_F32_FLOPS)
    return {"case": name, "batch": case, "m": m, "weighted": weighted,
            "weights": str(batches[0][2].dtype), "num_bins": bins + 1,
            "cluster_blocks": hb.cluster_blocks(m), "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "unfused_ms": unfused_ms, "call_ms": call,
            "library_ms": None, "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations", "bound_bytes": nbytes}


def edge_values(hist_lib, cfg, rng):
    """Every f32 edge of ``cfg`` with its two neighbours, the sync-period
    multiples, 0, -0.0, negatives, subnormals, NaN, +-inf and 3e38, then
    100,000 log-uniform values over the bins and past them."""
    e = hist_lib.edges(cfg).astype(np.float32)
    return np.concatenate([
        e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf)),
        np.arange(1, 33, dtype=np.float32) * np.float32(0.25),
        np.float32([0.0, -0.0, -1.0, -3e38, 1e-45, 1e-40, np.nan, np.inf, -np.inf, 3e38]),
        np.exp(rng.uniform(np.log(cfg.lo) - 3, np.log(cfg.hi) + 3, 100_000)).astype(np.float32)])


def phase_hist_kernel(hb, cuda_build):
    """Phase 1f: the histogram update. ``bin_index`` on the card against the
    CPU, and ``record`` (one launch) against ``record_plain`` on the card,
    bitwise, at every f32 edge of the default and a non-default
    ``HistConfig`` with their neighbours and special values, each value
    with its own large i32 weight (a value in another bin moves two sums)
    and with bool weights; ``record`` at the loop's four shapes; the idx
    route (the TPU kernel's contract) against ``hist_bincount_plain`` at
    its four cases; the kernel's registers and spills."""
    from repro_torch.obs import hist as hist_lib

    rng = np.random.default_rng(7)
    checked = 0
    for cfg in (hist_lib.HistConfig(), hist_lib.HistConfig(bins=16, lo=1e-3, hi=1e3)):
        values = edge_values(hist_lib, cfg, rng)
        cpu = hist_lib.bin_index(torch.from_numpy(values), cfg)
        card = hist_lib.bin_index(torch.from_numpy(values).cuda(), cfg).cpu()
        bad = (card != cpu).nonzero().flatten()
        check(bad.numel() == 0, f"bin_index: card differs from the CPU at "
                                f"{values[bad[:5].numpy()].tolist()}: {card[bad[:5]].tolist()} vs "
                                f"{cpu[bad[:5]].tolist()}")
        v = torch.from_numpy(values).cuda()
        counts = torch.from_numpy(rng.integers(0, 1_000, cfg.bins + 1).astype(np.int32)).cuda()
        for w in (torch.from_numpy(rng.integers(1, 1 << 20, values.size).astype(np.int32)),
                  torch.from_numpy(rng.random(values.size) < 0.5)):
            w = w.cuda()
            got, want = hist_lib.record(counts, v, w, cfg), hist_lib.record_plain(counts, v, w, cfg)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"record at the edges of {cfg}, {w.dtype} weights: "
                                          f"{(got - want).abs().max().item()} off")
        checked += values.size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    records = [record_case(hb, hist_lib, f"record_{name}", name, gen)
               for name in ("merge", "commit", "chunk", "uniform")]
    cases = [hist_case(hb, name, name, gen) for name in ("merge", "commit", "chunk", "uniform")]
    resources = kernel_resources(cuda_build, "hist_bincount.cu", [
        f"{k}<{t}>" for k in ("hist_cluster_kernel", "hist_atomic_kernel")
        for t in ("uint8_t", "int32_t")])
    return {"bin_index_values_checked": checked, "record_cases": records, "cases": cases,
            "resources": resources}


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


def device_kernels_a_call(fn, *args, tries=5):
    """The names of the device operations (kernels, copies, fills) one call
    of ``fn`` runs, from a profiled call; None where the profiler saw no
    device work. A spin kernel enqueued after the call marks a trace that
    holds the call's device events: late in a run the profiler drops every
    device event of some windows, and such a window is profiled again."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [name for _, _, name in sorted(device_spans(prof))]
        if any("spin_kernel" in name for name in names):
            return [name for name in names if "spin_kernel" not in name]
    return None


def distance_views(md, x):
    """``x``'s distances (and scores, where the tree has them) through views
    with row strides N + 1, N + 2, N + 3 and views that start 1-3 floats
    into a buffer, each bitwise those of the contiguous ``x``."""
    k, n = x.shape
    fn = getattr(md, "outlier_scores", None) or (lambda t: (md.model_distance(t),))
    want = fn(x)
    views = []
    for extra in (1, 2, 3):
        wide = torch.zeros((k, n + extra), device=x.device)
        wide[:, :n] = x
        views.append((f"row_stride_n_plus_{extra}", wide[:, :n]))
    for start in (1, 2, 3):
        flat = torch.zeros(start + k * n, device=x.device)
        view = flat[start:].view(k, n)
        view.copy_(x)
        views.append((f"offset_{start}_floats", view))
    for what, view in views:
        got = fn(view)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"distance {k} x {n}: the view {what} differs from the contiguous tensor")
    return [what for what, _ in views]


# phase 1h's shapes: (case, k, N, a row of zeros, calls timed)
DISTANCE_CASES = (("main_k5", 5, MAIN_P, False, 40), ("main_k16", 16, MAIN_P, False, 40),
                  ("k1", 1, 4_097, False, 20), ("k7_n33_zero_row", 7, 33, True, 20),
                  ("k32_ragged", 32, 100_003, True, 20))


def distance_device_kernels(md):
    """The device operations one ``model_distance`` call runs at each of
    phase 1h's shapes, from a profiled call each. Taken early in a run:
    after the telemetry phases the profiler drops the device events of
    some windows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    out = {}
    for name, k, n, _, _ in DISTANCE_CASES:
        x = torch.randn((k, n), generator=gen, device="cuda")
        out[name] = device_kernels_a_call(md.model_distance, x)
    return out


def distance_case(md, name, k, n, gen, kernels, zero_row=False, reps=40):
    """One shape of the model-distance kernel: within DIST_TOL of the sum of
    the absolute terms of its plain version on the same card tensors, the
    same bits from call to call, d symmetric bit for bit, strided and offset
    views bitwise the contiguous tensor, the plan where the tree reports it,
    ``kernels`` (the device operations a call, ``distance_device_kernels``),
    then times: the kernel, the plain version, ``torch.cdist`` (the library
    yardstick; it gives the root of the distance, computed through a matrix
    product) and the byte bound. Each timed call reads other models (copies
    cycled past the 50 MB L2), as a screen of freshly gathered candidates
    would."""
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
        check(torch.equal(got, got.T), f"distance {name}: d is not symmetric bit for bit")
        err = (got.double() - want.double()).abs()
        max_abs_err = max(max_abs_err, float(err.max()))
        check(bool((err <= DIST_TOL * distance_scale(x)).all()),
              f"distance {name}: kernel off plain by {float(err.max())}")
    views = distance_views(md, args_list[0][0])
    plan = md.plan_info(k, n) if hasattr(md, "plan_info") else None
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
            "bound_bytes": nbytes, "timed_copies": copies,
            "device_kernels_a_call": "not measured (the profiler saw no device work)"
            if kernels is None else len(kernels),
            "device_kernel_names": kernels, "views_bitwise": views, "plan": plan}


def phase_distance_kernel(md, cuda_build, kernels):
    """Phase 1h: the model-distance kernel against its plain version at the
    screen's shapes (alpha = 5 candidates of the paper's CNN, and 16) and at
    small odd ones (k = 1, N not a multiple of a chunk, a row of zeros),
    each case with its device kernels a call (``kernels``, profiled early in
    the run) and the kernel's registers, shared memory and spills."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    cases = [distance_case(md, name, k, n, gen, kernels[name], zero_row=zero_row, reps=reps)
             for name, k, n, zero_row, reps in DISTANCE_CASES]
    with_zero = torch.zeros((3, 1_000), device="cuda")
    check(int(md.model_distance(with_zero).abs().sum()) == 0, "distance of zeros is not 0")
    try:
        md.model_distance(torch.zeros((md.MAX_K + 1, 8), device="cuda"))
        check(False, "k past MAX_K was not refused")
    except ValueError:
        pass
    for case in cases:
        check(case["device_kernel_names"] is None or len(case["device_kernel_names"]) == 1,
              f"distance {case['case']}: device operations a call: "
              f"{case['device_kernel_names']}")
    resources = kernel_resources(cuda_build, "model_distance.cu", ["model_distance_kernel"])
    for case in cases:
        case["resources"] = dict(resources["model_distance_kernel"],
                                 dynamic_smem=(case["plan"] or {}).get("dynamic_smem"))
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
        bank of a run with 10 poisoning nodes, card against the CPU: one
        launch, one device kernel a call (profiled), its call ms."""
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
    screen_kernels = device_kernels_a_call(anomaly.parameter_outlier_scores, x)
    check(screen_kernels is None or len(screen_kernels) == 1,
          f"screen: {len(screen_kernels or [])} device operations: {screen_kernels}")
    out["d_outlier_screen"] = {
        "device_kernels_a_call": "not measured (the profiler saw no device work)"
        if screen_kernels is None else len(screen_kernels),
        "device_kernel_names": screen_kernels,
        "call_ms": call_ms(anomaly.parameter_outlier_scores, [(x,)] * 20),
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


# ---------------------------------------------------------------------------
# the model zoo's dense transformer: attention kernels (1i), qwen3-0.6b served
# at full width (2i), card vs CPU (3i)
# ---------------------------------------------------------------------------


def attention_bound(flops, nbytes, dtype):
    """(ms, what bounds it): the larger of the operations over the peak for
    ``dtype`` (bf16 tensor cores; f32 outside them, TF32 is off) and the
    bytes over the memory rate."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ops_s, bytes_s = flops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def attention_errors(got, plain, args32, absargs32, dtype, plain_args):
    """Largest error of the kernel against its plain version run in f32 on
    the same inputs, checked within ATTN_TOL of sum_j p_j |v_j| (plus one
    bf16 ulp in bf16); and, in bf16, against the plain version in bf16."""
    want = plain(*args32)
    scale = plain(*absargs32)
    err = (got.float() - want).abs()
    tol = ATTN_TOL * scale
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    ok = bool((err <= tol).all())
    out = {"max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max())}
    if dtype == torch.bfloat16:
        out["max_abs_diff_plain_bf16"] = float((got.float() - plain(*plain_args).float())
                                               .abs().max())
    return ok, out


def prefill_tensor_ops(B, H, S, hd, window):
    """Tensor operations the bf16 prefill kernel issues: each warpgroup (64
    query rows of a head) takes Q K^T once and p @ v twice (p_hi and p_lo) on
    every key tile it does not skip, 2 * 64 * tile * hd operations each, the
    masked parts of edge tiles included (csrc/flash_attention.cu)."""
    tile = 128 if hd <= 128 else 64
    tiles = 0
    for r_lo in range(0, S, 64):
        first = max(0, r_lo - window + 1) // tile if window else 0
        tiles += min(r_lo + 63, S - 1) // tile - first + 1
    return 3.0 * 2 * 64 * tile * hd * tiles * B * H


def attention_kernel_resources(cuda_build):
    """Registers, spills and stack of each attention kernel, from nvcc's
    -Xptxas=-v report in the build log, and the dynamic shared memory its
    launcher asks for (the layouts of csrc/flash_attention.cu: tc::Prefill,
    tc::Decode, prefill_smem_bytes, decode_smem_bytes)."""
    import re

    log = cuda_build.library_path(cuda_build.CSRC / "flash_attention.cu").with_suffix(".log")
    out, name = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)I(f?)Li(\d+)E", line)
        if entry:
            name = f"{entry.group(1)}<{'f32, ' if entry.group(2) else ''}{entry.group(3)}>"
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                out[name]["static_smem"] = int(s.group(1))
    for hd in (64, 128, 256):
        cols, tile, warps = hd // 64, (128 if hd <= 128 else 64), (2 if hd == 256 else 4)
        dynamic = {
            f"flash_prefill_tc_kernel<{hd}>": 2 * cols * 8192 + 2 * 2 * cols * tile * 128 + 40 + 1024,
            f"decode_tc_kernel<{hd}>": 2 * 3 * cols * 16 * warps * 128 + 64 + 32 * (2 + warps) + 8
            + 1024,
            f"flash_prefill_kernel<f32, {hd}>": 4 * (hd * 64 + 2 * hd * 32 + 32 * 68 + 128),
            f"decode_split_kernel<f32, {hd}>": (lambda t: 8 * t * (hd + 4) + 8 * t * hd
                                                + 4 * (8 * hd + 8 * t + 24))(32 if hd > 128 else 64),
        }
        for kernel, nbytes in dynamic.items():
            out.setdefault(kernel, {})["dynamic_smem"] = nbytes
    check(all(r.get("spill_stores", 0) == 0 for r in out.values()),
          f"an attention kernel spills: {out}")
    return out


def prefill_case(fa, name, B, H, KV, S, hd, dtype, window, gen, reps):
    """One shape of the prefill kernel on the model's layout ((B, S, H, hd)
    passed permuted): error against the plain version, the same bits twice,
    then times of the kernel, the plain version (query blocks of 1024),
    ``scaled_dot_product_attention`` (causal, or windowed through a boolean
    mask) and the bound."""
    F = torch.nn.functional
    q = (torch.randn((B, S, H, hd), generator=gen, device="cuda") * 0.5).to(dtype).transpose(1, 2)
    k = (torch.randn((B, S, KV, hd), generator=gen, device="cuda") * 0.5).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    got, again = fa.flash_attention(q, k, v, window), fa.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"prefill {name}: two calls differ")
    ok, errs = attention_errors(got, fa.flash_attention_plain,
                                (q.float(), k.float(), v.float(), window),
                                (q.float(), k.float(), v.float().abs(), window),
                                dtype, (q, k, v, window))
    check(ok, f"prefill {name}: kernel off its plain version: {errs}")
    del got, again
    args = [(q, k, v, window)] * reps
    ms = device_ms(fa.flash_attention, args, warmup=1)
    plain_ms = device_ms(fa.flash_attention_plain, args[:max(1, reps // 2)], warmup=1)
    if window:                         # the same function through an (S, S) boolean mask
        i, j = torch.arange(S, device="cuda")[:, None], torch.arange(S, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window)
        library_ms = device_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), [(q, k, v, mask)] * reps, warmup=1)
        del i, j, mask
    else:
        library_ms = device_ms(lambda q, k, v, w: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), args, warmup=1)
    rows = torch.arange(S, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=window).sum() if window else (rows + 1).sum())
    flops = 4.0 * B * H * pairs * hd
    nbytes = (2 * B * H * S * hd + 2 * B * KV * S * hd) * q.element_size()
    bound_ms, bound_by = attention_bound(flops, nbytes, dtype)
    issued = {}
    if dtype == torch.bfloat16:
        ops = prefill_tensor_ops(B, H, S, hd, window)
        issued = {"tensor_ops_issued": ops, "issued_over_algorithm": ops / flops,
                  "tensor_tflops_issued": ops / ms / 1e9}
    return {"case": name, "B": B, "H": H, "KV": KV, "S": S, "hd": hd, "window": window,
            "dtype": str(dtype).removeprefix("torch."), **errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops_achieved": flops / ms / 1e9, **issued, "reps": reps}


def decode_case(fa, name, B, H, KV, S, hd, dtype, lengths, gen, reps):
    """One shape of the decode kernel against an (B, S, KV, hd) cache: error
    against the plain version, the same bits twice, then times of the
    kernel, the plain version, ``scaled_dot_product_attention`` with a length
    mask (rows of length 0 excluded: its softmax of nothing is NaN) and the
    byte bound of the slots this run's lengths read."""
    F = torch.nn.functional
    q = (torch.randn((B, H, hd), generator=gen, device="cuda") * 0.5).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").mul_(0.3).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got, again = fa.decode_attention(q, k, v, lens), fa.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"decode {name}: two calls differ")
    ok, errs = attention_errors(got, fa.decode_attention_plain,
                                (q.float(), k.float(), v.float(), lens),
                                (q.float(), k.float(), v.float().abs(), lens),
                                dtype, (q, k, v, lens))
    check(ok, f"decode {name}: kernel off its plain version: {errs}")
    args = [(q, k, v, lens)] * reps
    ms = device_ms(fa.decode_attention, args)
    plain_ms = device_ms(fa.decode_attention_plain, args[:max(1, reps // 4)], warmup=1)
    library_ms = None
    if 0 not in lengths:
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        library_ms = device_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=m, enable_gqa=True),
            [(q, k, v, mask)] * max(1, reps // 4), warmup=1)
    read = sum(length or S for length in lengths)          # a row of length 0 reads all S
    nbytes = (2 * read * KV * hd + 2 * B * H * hd) * q.element_size() + 4 * B
    flops = 4.0 * sum(lengths) * (H // KV) * KV * hd
    bound_ms, bound_by = attention_bound(flops, nbytes, dtype)
    return {"case": name, "B": B, "H": H, "KV": KV, "S": S, "hd": hd,
            "lengths": lengths if len(set(lengths)) > 1 else f"{lengths[0]} x {B}",
            "dtype": str(dtype).removeprefix("torch."), **errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "gb_per_s_achieved": nbytes / ms / 1e6, "reps": reps}


def phase_attention_kernels(fa, cuda_build):
    """Phase 1i: both attention kernels against their plain versions at the
    served model's shapes (qwen3-0.6b: H 16, KV 8, hd 128, bf16), the long
    and windowed lengths, gemma-2b's MQA at hd 256, and odd f32 shapes; bf16
    takes the tensor-core route, f32 the CUDA cores. With each kernel's
    registers and shared memory."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    prefill = [
        prefill_case(fa, "main", 1, 16, 8, 8192, 128, torch.bfloat16, 0, gen, reps=10),
        prefill_case(fa, "long_32k", 1, 16, 8, 32768, 128, torch.bfloat16, 0, gen, reps=2),
        prefill_case(fa, "window_32k", 1, 16, 8, 32768, 128, torch.bfloat16, 8192, gen, reps=2),
        prefill_case(fa, "gemma_2b", 1, 8, 1, 4096, 256, torch.bfloat16, 0, gen, reps=10),
        prefill_case(fa, "odd_f32", 1, 10, 2, 1000, 64, torch.float32, 0, gen, reps=10),
    ]
    torch.cuda.empty_cache()
    decode = [
        decode_case(fa, "main", 8, 16, 8, 32768, 128, torch.bfloat16, [32768 - 16] * 8, gen,
                    reps=40),
        decode_case(fa, "ragged", 8, 16, 8, 32768, 128, torch.bfloat16,
                    [0, 1, 32768, 17, 4095, 20000, 32767, 513], gen, reps=20),
        decode_case(fa, "gemma_2b", 8, 8, 1, 32768, 256, torch.bfloat16, [32768 - 16] * 8,
                    gen, reps=40),
        decode_case(fa, "odd_f32", 3, 10, 2, 1000, 64, torch.float32, [1000, 0, 333], gen,
                    reps=40),
    ]
    torch.cuda.empty_cache()
    for bad in ((torch.zeros((1, 4, 8, 48), device="cuda"),) * 3,
                (torch.zeros((1, 4, 8, 64), device="cuda", dtype=torch.float16),) * 3):
        try:
            fa.flash_attention(*bad)
            check(False, "a shape or dtype the kernel does not take was not refused")
        except ValueError:
            pass
    return {"prefill": prefill, "decode": decode,
            "resources": attention_kernel_resources(cuda_build)}


def check_attention_launches(what, launches, flash, decode):
    got = (launches.get("flash_attention", 0), launches.get("decode_attention", 0))
    check(got == (flash, decode), f"{what}: attention launches {got}, expected {(flash, decode)}")


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_model_path(cuda_build):
    """Phase 2i: qwen3-0.6b at full width in bf16 from a seeded init:
    (a) ``prefill`` of MODEL_PREFILL tokens and ``forward`` of one more, in
    bf16 and in an f32 twin of the same draws: in f32 (the precision of the
    reference's test) ``decode_step`` must give forward's last logits within
    the reference's 2e-2; in bf16 prefill's must, and decode's within
    BF16_DECODE_ATOL (+ 2e-2 |logit|), BF16_DECODE_MEAN on average; (b)
    MODEL_DECODE_STEPS ``decode_step``s of a batch of 8 against a 32k cache
    filled from a seeded generator; (c) the ``SlotServer``; (d) a profiled
    window of decode steps. Each attention layer launches its kernel once."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    cfg = get_arch("qwen3-0.6b")
    L, V = cfg.num_layers, cfg.vocab_size
    model = build_model(cfg)
    params, init_s = timed(model.init, 0, device="cuda")
    leaves = param_leaves(params)
    n_params = sum(p.numel() for _, p in leaves)
    norms = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
    n_matrices = sum(p.numel() for path, p in leaves if not set(path) & set(norms))
    check(n_matrices == cfg.param_count(),       # the closed form counts no norm scales
          f"{n_matrices} weights outside the norms, not {cfg.param_count()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": L, "params": n_params,
           "params_in_matrices": n_matrices, "init_s": init_s}
    total = collections.Counter()

    # (a) prefill, forward and the first decode step, in bf16 and in an f32
    # twin of the same draws (the bf16 weights are these rounded)
    S = MODEL_PREFILL
    tokens = torch.randint(0, V, (1, S + 1), generator=gen, device="cuda")
    model.prefill(params, tokens[:, :S], cache_len=S + 4)         # warm-up (allocator)
    runs = {}
    for label, m, p in (("bf16", model, params),
                        ("f32", build_model(dataclasses.replace(cfg, dtype="float32")), None)):
        p = p if p is not None else m.init(0, device="cuda")
        cuda_build.LAUNCHES.clear()
        (last, cache), prefill_s = timed(m.prefill, p, tokens[:, :S], cache_len=S + 4)
        check_attention_launches(f"{label} prefill", cuda_build.LAUNCHES, L, 0)
        total.update(cuda_build.LAUNCHES)
        cuda_build.LAUNCHES.clear()
        (logits, _), forward_s = timed(m.forward, p, tokens)
        check_attention_launches(f"{label} forward", cuda_build.LAUNCHES, L, 0)
        total.update(cuda_build.LAUNCHES)
        cuda_build.LAUNCHES.clear()
        (step, _), decode_s = timed(m.decode_step, p, tokens[:, S:], cache)
        check_attention_launches(f"{label} decode_step", cuda_build.LAUNCHES, 0, L)
        total.update(cuda_build.LAUNCHES)
        check(bool(torch.isfinite(logits).all()) and logits.shape == (1, S + 1, V),
              f"{label} forward logits {tuple(logits.shape)} not finite")
        runs[label] = {"prefill_s": prefill_s, "forward_s": forward_s, "decode_step_s": decode_s,
                       "forward": logits[0, -1].float(), "prefill": last[0, 0].float(),
                       "forward_prev": logits[0, -2].float(), "decode": step[0, 0].float()}
        del logits, cache, last, step, p, m
    bf, fp = runs["bf16"], runs["f32"]

    def max_err(a, b):
        return float((a - b).abs().max())

    def within(got, want, atol=2e-2):  # the reference's decode==forward bound at 2e-2
        return bool(((got - want).abs() <= atol + 2e-2 * want.abs()).all())

    # the reference's test, at full width in its own precision (f32)
    check(within(fp["decode"], fp["forward"]),
          f"f32: decode_step off forward by {max_err(fp['decode'], fp['forward'])}")
    check(within(fp["prefill"], fp["forward_prev"]),
          f"f32: prefill off forward by {max_err(fp['prefill'], fp['forward_prev'])}")
    check(within(bf["prefill"], bf["forward_prev"]),
          f"bf16: prefill off forward by {max_err(bf['prefill'], bf['forward_prev'])}")
    bf_mean = float((bf["decode"] - bf["forward"]).abs().mean())
    check(within(bf["decode"], bf["forward"], BF16_DECODE_ATOL) and bf_mean <= BF16_DECODE_MEAN,
          f"bf16: decode_step off forward by {max_err(bf['decode'], bf['forward'])}, "
          f"{bf_mean} on average")
    out["a_prefill_forward_decode"] = {
        "prefill_tokens": S, "forward_tokens": S + 1,
        **{f"{label}_{key}": runs[label][key] for label in runs
           for key in ("prefill_s", "forward_s", "decode_step_s")},
        "bf16_prefill_tokens_per_s": S / bf["prefill_s"],
        "f32_decode_vs_forward_max_abs_err": max_err(fp["decode"], fp["forward"]),
        "f32_prefill_vs_forward_max_abs_err": max_err(fp["prefill"], fp["forward_prev"]),
        "bf16_prefill_vs_forward_max_abs_err": max_err(bf["prefill"], bf["forward_prev"]),
        "bf16_decode_vs_forward_max_abs_err": max_err(bf["decode"], bf["forward"]),
        "bf16_decode_vs_forward_mean_abs_err": bf_mean,
        "bf16_decode_vs_f32_forward_max_abs_err": max_err(bf["decode"], fp["forward"]),
        "bf16_forward_vs_f32_forward_max_abs_err": max_err(bf["forward"], fp["forward"]),
        "bf16_decode_argmax_is_forward_argmax":
            int(bf["decode"].argmax()) == int(bf["forward"].argmax()),
        "forward_logit_abs_max": float(bf["forward"].abs().max()),
        "tolerance": "2e-2 + 2e-2 |logit|; bf16 decode: "
                     f"{BF16_DECODE_ATOL} + 2e-2 |logit|, mean {BF16_DECODE_MEAN}"}
    del runs, bf, fp
    torch.cuda.empty_cache()

    # (b) decode steps of a batch of 8 against a 32k cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()    # the params and what earlier phases hold
    B, ctx = MODEL_DECODE_BATCH, SHAPE_DECODE_32K
    cache = model.init_cache(B, ctx, length=ctx - MODEL_DECODE_STEPS, device="cuda")
    cache["stack"].k.normal_(generator=gen)
    cache["stack"].v.normal_(generator=gen)
    tok = torch.randint(0, V, (B, 1), generator=gen, device="cuda")
    step_ms = []
    cuda_build.LAUNCHES.clear()
    for _ in range(MODEL_DECODE_STEPS):
        (step, cache), s = timed(model.decode_step, params, tok, cache)
        tok = torch.argmax(step[:, 0], dim=-1, keepdim=True)
        step_ms.append(1e3 * s)
    check_attention_launches("decode steps", cuda_build.LAUNCHES, 0, L * MODEL_DECODE_STEPS)
    total.update(cuda_build.LAUNCHES)
    check(bool(torch.isfinite(step).all()) and step.shape == (B, 1, V),
          "decode logits not finite")
    check(cache["stack"].length == ctx, f"cache length {cache['stack'].length}")
    steady = step_ms[1:]
    out["b_decode_32k"] = {
        "batch": B, "context": ctx, "cache_bytes": 2 * cache["stack"].k.numel() * 2,
        "steps": MODEL_DECODE_STEPS, "step_ms": step_ms,
        "ms_per_step_steady": sum(steady) / len(steady),
        "tokens_per_s_steady": B * 1e3 * len(steady) / sum(steady),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": held_before}

    # (d) a profiled window of decode steps at the full context
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(MODEL_PROFILED_STEPS):
            step, cache = model.decode_step(params, tok, cache)
            tok = torch.argmax(step[:, 0], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    out["d_profile_decode"] = {"steps": MODEL_PROFILED_STEPS, **trace_summary(prof, wall_ms)}
    del cache, step, prof
    torch.cuda.empty_cache()

    # (c) the slot server
    slots, n_req, prompt_len, max_new = SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW
    rng = np.random.default_rng(20)
    queue = [Request(i, rng.integers(0, V, prompt_len).astype(np.int32), max_new)
             for i in range(n_req)]
    server = SlotServer(cfg, params, slots, prompt_len + max_new + 2)
    cuda_build.LAUNCHES.clear()
    ticks, wall_s = timed(serve, server, queue)
    check(all(r.done and len(r.out) == max_new for r in queue), "a request did not complete")
    check_attention_launches("SlotServer", cuda_build.LAUNCHES, L * n_req, L * ticks)
    total.update(cuda_build.LAUNCHES)
    out["c_slot_server"] = {"slots": slots, "requests": n_req, "prompt_tokens": prompt_len,
                            "new_tokens": max_new, "ticks": ticks, "wall_s": wall_s,
                            "tokens_out": sum(len(r.out) for r in queue),
                            "tokens_per_s": sum(len(r.out) for r in queue) / wall_s,
                            "final_length": server.length}
    out["launches"] = dict(total)
    return out


# ---------------------------------------------------------------------------
# the RWKV6 family: the WKV kernel (1j), rwkv6-7b served at full width (2j),
# card vs CPU (3j)
# ---------------------------------------------------------------------------


def wkv_inputs(gen, B, T, H, hd, dtype, decay, nonzero_state):
    """r, k, v and u in ``dtype``, logw f32 drawn like the model's (``-exp(-1
    + small)``) or strong (``-exp(min(2 + N, 10))``, the model's clamp), the
    state f32: zero (a prefill) or standard normal."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    dd = -1.0 + 0.3 * randn(B, T, H, hd) if decay == "model" else 2.0 + randn(B, T, H, hd)
    logw = -torch.exp(torch.clamp(dd, max=10.0))
    u = torch.rand((H, hd), generator=gen, device="cuda").mul_(0.5).to(dtype)
    s0 = randn(B, H, hd, hd) if nonzero_state else torch.zeros((B, H, hd, hd), device="cuda")
    return r, k, v, logw, u, s0


def wkv_bound(B, T, H, hd, esize):
    """(ms, what bounds it, its parts) of the chunked route: the bytes (r, k,
    v, u in their type; logw, both states and y in f32) over the memory
    rate; its products on the tensor cores (r_dec S, k_dec^T v and the
    factorised score blocks below the diagonal of the sub-chunks of 8) at
    the TF32 rate; the direct pairs inside the sub-chunks, the bonus and A v
    on the CUDA cores at the f32 rate; the exponentials the factorised form
    needs (both decays, e^total, the blocks' factors, the direct pairs) at
    the special-function rate. The PR 21 bound, every score direct and every
    product on the CUDA cores, is kept beside them as ``old_*``."""
    C, SUB = 32, 8
    nc = T // C
    pairs = C * (C - 1) // 2                          # 496 strictly lower (t, s)
    inner = (C // SUB) * SUB * (SUB - 1) // 2         # 112 inside the sub-chunks
    cross = pairs - inner                             # 384 in the factorised blocks
    heads = B * H * nc
    nbytes = (3 * esize + 8) * B * T * H * hd + esize * H * hd + 8 * B * H * hd * hd
    tf32_flops = heads * (4 * C * hd * hd + 2 * cross * hd)
    f32_flops = heads * (3 * inner * hd + 3 * C * hd + C * (C + 1) * hd)
    factors = (C - SUB) * hd + sum(SUB * n for n in range(1, C // SUB)) * hd
    exps = heads * ((2 * C + 1) * hd + factors + inner * hd)
    old_flops = heads * (3 * pairs * hd + 3 * C * hd + C * (C + 1) * hd + 4 * C * hd * hd)
    old_exps = heads * (pairs * hd + 2 * C * hd + hd)
    parts = {"bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
             "tf32_ms": 1e3 * tf32_flops / PEAK_TF32_FLOPS,
             "f32_ops_ms": 1e3 * f32_flops / PEAK_F32_FLOPS,
             "exp_ms": 1e3 * exps / PEAK_EXP_PER_S}
    ms = max(parts.values())
    old = {"old_f32_ops_ms": 1e3 * old_flops / PEAK_F32_FLOPS,
           "old_exp_ms": 1e3 * old_exps / PEAK_EXP_PER_S}
    old["old_bound_ms"] = max(parts["bytes_ms"], *old.values())
    return ms, ("bytes" if parts["bytes_ms"] == ms else "operations"), {**parts, **old}


def wkv_scan_bound(B, T, H, hd, esize):
    """(ms, what bounds it, its parts) of the sequential route: the bytes (r,
    k, v, u in their type; logw and y in f32; the state read once and
    written once) over the memory rate; its f32 operations (k v, S + u k v,
    the r dot and w S + k v: 7 a state entry a step) over the f32 peak; its
    exponentials (w) over the special-function rate."""
    nbytes = (3 * esize + 8) * B * T * H * hd + esize * H * hd + 8 * B * H * hd * hd
    parts = {"bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
             "f32_ops_ms": 1e3 * 7 * B * T * H * hd * hd / PEAK_F32_FLOPS,
             "exp_ms": 1e3 * B * T * H * hd / PEAK_EXP_PER_S}
    ms = max(parts.values())
    return ms, ("bytes" if parts["bytes_ms"] == ms else "operations"), parts


def wkv_errors(got, args, plain, tol, label, name):
    """Largest error of ``got`` (y, state) against ``plain`` run in f32 on
    the same inputs, relative to ``plain`` on the absolute values; checked
    within ``tol``."""
    r, k, v, logw, u, s0 = args
    want = plain(r.float(), k.float(), v.float(), logw, u.float(), s0)
    scale = plain(r.float().abs(), k.float().abs(), v.float().abs(), logw, u.float().abs(),
                  s0.abs())
    err = [(g - w).abs() for g, w in zip(got, want)]
    over = max(float((e / sc).max()) for e, sc in zip(err, scale))
    check(over <= tol, f"{name}: kernel off its {label} version by {over} of the scale")
    return {f"max_abs_err_vs_{label}": max(float(e.max()) for e in err),
            f"max_err_over_scale_vs_{label}": over}


def wkv_case(wm, name, B, T, H, hd, dtype, decay, nonzero_state, gen, reps, plain_calls=1):
    """One shape of the WKV kernel on the model's (B, T, H, hd) layout: y and
    the final state against the chunked plain version and the sequential
    scan, both run in f32 on the same inputs; the same bits twice; then
    times of the kernel, the chunked plain version and the bound."""
    args = wkv_inputs(gen, B, T, H, hd, dtype, decay, nonzero_state)
    got, again = wm.wkv(*args), wm.wkv(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"wkv {name}: two calls differ")
    r = args[0]
    errs = {**wkv_errors(got, args, wm.wkv_chunked_plain, WKV_TOL, "plain", f"wkv {name}"),
            **wkv_errors(got, args, wm.wkv_scan_plain, WKV_SCAN_TOL, "scan", f"wkv {name}")}
    del got, again
    ms = device_ms(wm.wkv, [args] * reps, warmup=1)
    # the plain version's thousands of launches outlast any spin: the host in the loop
    plain_ms = call_ms(wm.wkv_chunked_plain, [args] * plain_calls, warmup=plain_calls - 1)
    bound_ms, bound_by, parts = wkv_bound(B, T, H, hd, r.element_size())
    return {"case": name, "B": B, "T": T, "H": H, "hd": hd, "decay": decay,
            "initial_state": "normal" if nonzero_state else "zero",
            "dtype": str(dtype).removeprefix("torch."), **errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, **parts,
            "reps": reps}


def wkv_scan_case(wm, name, B, T, H, hd, dtype, decay, gen, reps):
    """One shape of the sequential kernel from a nonzero state: y and the
    final state against ``wkv_scan_plain`` run in f32 on the same inputs,
    the same bits twice, in place (``out`` the state itself) the same bits
    as out of place; then times of the kernel out of place and in place, the
    plain version and the bound."""
    args = wkv_inputs(gen, B, T, H, hd, dtype, decay, True)
    got, again = wm.wkv_scan(*args), wm.wkv_scan(*args)
    state = args[5].clone()
    y_in, s_in = wm.wkv_scan(*args[:5], state, out=state)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"wkv_scan {name}: two calls differ")
    check(s_in is state and torch.equal(y_in, got[0]) and torch.equal(state, got[1]),
          f"wkv_scan {name}: in place differs from out of place")
    errs = wkv_errors(got, args, wm.wkv_scan_plain, WKV_TOL, "plain", f"wkv_scan {name}")
    del got, again, y_in
    ms = device_ms(wm.wkv_scan, [args] * reps, warmup=1)
    ms_in_place = device_ms(lambda *a: wm.wkv_scan(*a, out=a[5]), [(*args[:5], state)] * reps,
                            warmup=1)
    plain_ms = call_ms(wm.wkv_scan_plain, [args] * 2, warmup=1)
    bound_ms, bound_by, parts = wkv_scan_bound(B, T, H, hd, args[0].element_size())
    return {"case": name, "B": B, "T": T, "H": H, "hd": hd, "decay": decay,
            "dtype": str(dtype).removeprefix("torch."), **errs, "ms": ms,
            "ms_in_place": ms_in_place, "ms_per_step": ms / T, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, **parts,
            "reps": reps}


def wkv_kernel_resources(cuda_build, wm):
    """Registers, spills and stack of each WKV kernel, from nvcc's
    -Xptxas=-v report in the build log, and the dynamic shared memory its
    launcher asks for (``wkv_smem_bytes`` of the library)."""
    import re

    log = cuda_build.library_path(cuda_build.CSRC / "wkv.cu").with_suffix(".log")
    out, name = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d(wkv_[a-z]+_kernel)I(13__nv_bfloat16|f)"
                          r"Li(\d+)E", line)
        if entry:
            dtype = "f32" if entry.group(2) == "f" else "bf16"
            name = f"{entry.group(1)}<{dtype}, {entry.group(3)}>"
            kernel = ("wkv_state_kernel", "wkv_intra_kernel", "wkv_scan_kernel").index(
                entry.group(1))
            out[name] = {"dynamic_smem": wm._library().wkv_smem_bytes(
                kernel, int(dtype == "bf16"), int(entry.group(3)))}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    check(len(out) == 12, f"the WKV build log names {len(out)} kernels, not 12: {sorted(out)}")
    return out


def phase_wkv_kernel(wm, cuda_build):
    """Phase 1j: the chunked route at rwkv6-7b's shape (H 64, hd 64, bf16)
    for an 8k prefill with the model's decays and with strong ones, in f32,
    one chunk from a nonzero state, 32k (``prefill_32k``'s length at B 1),
    and an odd f32 shape at hd 128; the sequential route at rwkv6-7b's
    decode step (B 128, T 1) and an odd f32 shape at hd 128 (T 9, strong
    decays); then the shapes each refuses, and the kernels' resources."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    cases = [
        wkv_case(wm, "main", 1, 8192, 64, 64, torch.bfloat16, "model", False, gen, reps=10,
                 plain_calls=2),
        wkv_case(wm, "strong", 1, 8192, 64, 64, torch.bfloat16, "strong", False, gen, reps=5),
        wkv_case(wm, "f32", 1, 8192, 64, 64, torch.float32, "model", False, gen, reps=5),
        wkv_case(wm, "one_chunk", 1, 32, 64, 64, torch.bfloat16, "model", True, gen, reps=40),
        wkv_case(wm, "long_32k", 1, 32768, 64, 64, torch.bfloat16, "model", False, gen, reps=2),
        wkv_case(wm, "odd_f32_hd128", 3, 96, 5, 128, torch.float32, "strong", True, gen, reps=20),
    ]
    torch.cuda.empty_cache()
    scan_cases = [
        wkv_scan_case(wm, "decode", 128, 1, 64, 64, torch.bfloat16, "model", gen, reps=40),
        wkv_scan_case(wm, "odd_f32_hd128", 3, 9, 5, 128, torch.float32, "strong", gen, reps=40),
    ]
    torch.cuda.empty_cache()
    r, k, v, logw, u, s0 = wkv_inputs(gen, 1, 64, 2, 64, torch.float32, "model", False)
    for fn, bad in ((wm.wkv, (r[:, :48], k[:, :48], v[:, :48], logw[:, :48], u, s0)),
                    (wm.wkv_scan, (r[:, :0], k[:, :0], v[:, :0], logw[:, :0], u, s0))):
        for args in (bad, (r[..., :32], k[..., :32], v[..., :32], logw[..., :32], u[:, :32],
                           s0[:, :, :32, :32])):
            try:
                fn(*args)
                check(False, f"a length or head dim {fn.__name__} does not take was not refused")
            except ValueError:
                pass
    return {"chunked": cases, "scan": scan_cases,
            "resources": wkv_kernel_resources(cuda_build, wm)}


def phase_rwkv_path(cuda_build):
    """Phase 2j: rwkv6-7b at full width in bf16 from a seeded init: (a)
    ``prefill`` and ``forward`` of RWKV_PREFILL tokens, then a prefill of
    RWKV_DECODE_CHECK fewer and that many ``decode_step``s fed the true
    tokens, held to forward's logits at those positions (bf16: within
    RWKV_BF16_DECODE_ATOL + 2e-2 |logit|, RWKV_BF16_DECODE_MEAN on average;
    an f32 twin of the same draws at RWKV_TWIN_PREFILL tokens: within the
    reference's 2e-2); (b) decode at B = RWKV_DECODE_BATCH from (a)'s state in every
    slot, then a profiled window; (c) the ``SlotServer``. Every prefill or
    forward of a multiple of 32 tokens launches the chunked WKV kernel once
    a layer and the sequential one never; every decode step launches the
    sequential one once a layer and the chunked one never."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_at_start = torch.cuda.memory_allocated()     # what earlier phases still hold
    cfg = get_arch("rwkv6-7b")
    L, V = cfg.num_layers, cfg.vocab_size
    model = build_model(cfg)
    params, init_s = timed(model.init, 0, device="cuda")
    leaves = [p for _, p in param_leaves(params)]
    n_params = sum(p.numel() for p in leaves)
    check(n_params == RWKV_PARAMS, f"rwkv6-7b holds {n_params} parameters, not {RWKV_PARAMS}")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": L, "params": n_params,
           "param_bytes": sum(p.numel() * p.element_size() for p in leaves),
           "param_count_formula": cfg.param_count(), "init_s": init_s,
           "allocated_at_start_bytes": held_at_start}
    del leaves
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    total = collections.Counter()

    def launched(what, expect, expect_scan=0):
        got = cuda_build.LAUNCHES.get("wkv", 0)
        check(got == expect, f"{what}: wkv launched {got} times, expected {expect}")
        got = cuda_build.LAUNCHES.get("wkv_scan", 0)
        check(got == expect_scan, f"{what}: wkv_scan launched {got} times, expected {expect_scan}")
        total.update(cuda_build.LAUNCHES)
        cuda_build.LAUNCHES.clear()

    def max_err(a, b):
        return float((a - b).abs().max())

    def within(got, want, atol=2e-2):  # the reference's decode==forward bound at 2e-2
        return bool(((got - want).abs() <= atol + 2e-2 * want.abs()).all())

    def decode_against_forward(m, p, tokens, label):
        """(forward's logits at the last n + 1 positions, prefill's last and
        the n decode steps' logits, forward s): n = RWKV_DECODE_CHECK."""
        S, n = tokens.shape[1], RWKV_DECODE_CHECK
        (logits, _), forward_s = timed(m.forward, p, tokens)
        launched(f"{label} forward", L)
        check(bool(torch.isfinite(logits).all()) and logits.shape == (1, S, V),
              f"{label} forward logits {tuple(logits.shape)} not finite")
        want = logits[0, S - n - 1:].float()
        del logits
        last, cache = m.prefill(p, tokens[:, :S - n])
        launched(f"{label} prefill of {S - n}", L)
        got = [last[0, 0].float()]
        for i in range(S - n, S):
            step, cache = m.decode_step(p, tokens[:, i:i + 1], cache)
            got.append(step[0, 0].float())
        launched(f"{label} decode steps", 0, L * n)
        return want, torch.stack(got), forward_s

    # (a) prefill and forward of 8,192 tokens; decode against forward, in bf16
    # and in an f32 twin of the same draws (the bf16 weights are these rounded)
    S = RWKV_PREFILL
    tokens = torch.randint(0, V, (1, S), generator=gen, device="cuda")
    model.prefill(params, tokens[:, :512])                 # warm-up (allocator, cuBLAS)
    cuda_build.LAUNCHES.clear()
    (last, cache), prefill_s = timed(model.prefill, params, tokens)
    launched("bf16 prefill", L)
    check(bool(torch.isfinite(last).all()), "bf16 prefill logits not finite")
    want, got, forward_s = decode_against_forward(model, params, tokens, "bf16")
    bf_max, bf_mean = max_err(got, want), float((got - want).abs().mean())
    check(within(got, want, RWKV_BF16_DECODE_ATOL) and bf_mean <= RWKV_BF16_DECODE_MEAN,
          f"bf16: prefill and decode_step off forward by {bf_max}, {bf_mean} on average")
    a = {"prefill_tokens": S, "prefill_s": prefill_s, "prefill_tokens_per_s": S / prefill_s,
         "forward_s": forward_s, "decode_checked_steps": RWKV_DECODE_CHECK,
         "bf16_prefill_vs_forward_max_abs_err": max_err(got[0], want[0]),
         "bf16_decode_vs_forward_max_abs_err": max_err(got[1:], want[1:]),
         "bf16_max_abs_err": bf_max, "bf16_mean_abs_err": bf_mean,
         "bf16_decode_argmax_is_forward_argmax": int(
             (got[1:].argmax(-1) == want[1:].argmax(-1)).sum()),
         "forward_logit_abs_max": float(want.abs().max())}
    del want, got
    twin = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = twin.init(0, device="cuda")
    want, got, twin_forward_s = decode_against_forward(twin, p32, tokens[:, :RWKV_TWIN_PREFILL],
                                                       "f32")
    check(within(got, want), f"f32: decode_step off forward by {max_err(got, want)}")
    a.update({"f32_tokens": RWKV_TWIN_PREFILL, "f32_forward_s": twin_forward_s,
              "f32_prefill_vs_forward_max_abs_err": max_err(got[0], want[0]),
              "f32_decode_vs_forward_max_abs_err": max_err(got[1:], want[1:]),
              "tolerance": "f32: 2e-2 + 2e-2 |logit|; bf16: "
                           f"{RWKV_BF16_DECODE_ATOL} + 2e-2 |logit|, "
                           f"mean {RWKV_BF16_DECODE_MEAN}"})
    a["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["a_prefill_forward_decode"] = a
    del want, got, p32, twin
    torch.cuda.empty_cache()

    # (b) decode at B = 128 from (a)'s state, copied into every slot
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()          # the params and (a)'s state
    B = RWKV_DECODE_BATCH
    states = model.init_cache(B, 0, device="cuda")
    for dst, src in zip(states, cache):
        dst.copy_(src.expand_as(dst))
    tok = torch.randint(0, V, (B, 1), generator=gen, device="cuda")
    step_ms = []
    for _ in range(RWKV_DECODE_STEPS):
        (step, states), s = timed(model.decode_step, params, tok, states)
        tok = torch.argmax(step[:, 0], dim=-1, keepdim=True)
        step_ms.append(1e3 * s)
    launched("B = 128 decode steps", 0, L * RWKV_DECODE_STEPS)
    check(bool(torch.isfinite(step).all()) and step.shape == (B, 1, V), "decode logits not finite")
    steady = step_ms[1:]
    out["b_decode"] = {
        "batch": B, "state_bytes": sum(leaf.numel() * leaf.element_size() for leaf in states),
        "steps": RWKV_DECODE_STEPS, "step_ms": step_ms,
        "ms_per_step_steady": sum(steady) / len(steady),
        "tokens_per_s_steady": B * 1e3 * len(steady) / sum(steady),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": held_before}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(RWKV_PROFILED_STEPS):
            step, states = model.decode_step(params, tok, states)
            tok = torch.argmax(step[:, 0], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    launched("profiled decode steps", 0, L * RWKV_PROFILED_STEPS)
    summary = trace_summary(prof, wall_ms)
    if isinstance(summary.get("device_busy_ms"), float):
        summary["device_ms_per_step"] = summary["device_busy_ms"] / RWKV_PROFILED_STEPS
        summary["device_ops_per_step"] = summary["device_ops"] / RWKV_PROFILED_STEPS
    out["b_profile_decode"] = {"steps": RWKV_PROFILED_STEPS, **summary}
    del states, step, prof, cache, last
    torch.cuda.empty_cache()

    # (c) the slot server: every slot carries its own request's state
    slots, n_req, prompt_len, max_new = SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW
    rng = np.random.default_rng(22)
    queue = [Request(i, rng.integers(0, V, prompt_len).astype(np.int32), max_new)
             for i in range(n_req)]
    server = SlotServer(cfg, params, slots, prompt_len + max_new + 2)
    ticks, wall_s = timed(serve, server, queue)
    check(all(r.done and len(r.out) == max_new for r in queue), "a request did not complete")
    launched("SlotServer", L * n_req, L * ticks)
    out["c_slot_server"] = {"slots": slots, "requests": n_req, "prompt_tokens": prompt_len,
                            "new_tokens": max_new, "ticks": ticks, "wall_s": wall_s,
                            "tokens_out": sum(len(r.out) for r in queue),
                            "tokens_per_s": sum(len(r.out) for r in queue) / wall_s}
    out["launches"] = dict(total)
    return out


def phase_small_rwkv_agreement():
    """Phase 3j: reduced rwkv6-7b (f32), the same parameters on the card and
    on the CPU: forward and prefill of 96 tokens (the chunked WKV kernel on
    the card, its plain version on the CPU) and 4 decode steps (the
    sequential kernel), logits within 1e-4; the ``SlotServer``'s tokens and
    ticks equal, with prompts of 32 tokens (prefilled by the chunked kernel)
    and of 9 (by the sequential one); both launch counts checked."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import build_model

    cfg = get_arch("rwkv6-7b").reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = tree_to(cpu, "cuda")
    tokens = np.random.default_rng(23).integers(0, cfg.vocab_size, (2, 96 + 4))
    cuda_build.LAUNCHES.clear()
    worst = float((model.forward(card, tokens[:, :96])[0].cpu()
                   - model.forward(cpu, tokens[:, :96])[0]).abs().max())
    caches = {device: model.prefill(params, tokens[:, :96])
              for device, params in (("cuda", card), ("cpu", cpu))}
    L = cfg.num_layers

    def launched(what, expect, expect_scan):
        got = (cuda_build.LAUNCHES.get("wkv", 0), cuda_build.LAUNCHES.get("wkv_scan", 0))
        check(got == (expect, expect_scan),
              f"3j {what}: wkv, wkv_scan launched {got} times, expected {expect}, {expect_scan}")
        cuda_build.LAUNCHES.clear()

    launched("forward and prefill", 2 * L, 0)
    worst = max(worst, float((caches["cuda"][0].cpu() - caches["cpu"][0]).abs().max()))
    cg, cc = caches["cuda"][1], caches["cpu"][1]
    for step in range(4):
        tok = tokens[:, 96 + step:97 + step]
        lg, cg = model.decode_step(card, tok, cg)
        lc, cc = model.decode_step(cpu, tok, cc)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
    check(worst <= 1e-4, f"3j: card and CPU logits differ by {worst}")
    launched("decode steps", 0, 4 * L)
    servers = {}
    for prompt_len in (32, 9):
        outs = {}
        for device, params in (("cuda", card), ("cpu", cpu)):
            rng = np.random.default_rng(24)
            queue = [Request(i, rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32), 6)
                     for i in range(5)]
            server = SlotServer(cfg, params, 2, prompt_len + 8)
            outs[device] = (serve(server, queue), [r.out for r in queue])
            if device == "cuda":                # 5 prefills, then one decode step a tick
                chunked = prompt_len % 32 == 0
                launched(f"SlotServer at {prompt_len}", 5 * L * chunked,
                         5 * L * (not chunked) + L * outs["cuda"][0])
        check(outs["cuda"] == outs["cpu"], f"3j: SlotServer differs at {prompt_len}: {outs}")
        servers[f"prompt_{prompt_len}"] = {"ticks": outs["cuda"][0],
                                           "tokens": sum(len(o) for o in outs["cuda"][1])}
    return {"logits_max_abs_diff": worst, **servers}


def param_leaves(tree, path=()):
    """(key path, tensor) of every tensor of a nested dict of parameters."""
    if isinstance(tree, dict):
        return [leaf for key, sub in tree.items() for leaf in param_leaves(sub, path + (key,))]
    return [(path, tree)]


def phase_small_model_agreement():
    """Phase 3i: reduced qwen3-0.6b (f32) and its sliding-window variant, the
    same parameters on the card and on the CPU: prefill and decode logits
    within 1e-4, and the ``SlotServer``'s tokens, ticks and length equal."""
    from repro_torch.configs import get_arch, long_context_variant
    from repro_torch.launch.serve import Request, SlotServer, serve
    from repro_torch.models import build_model

    out = {}
    base = get_arch("qwen3-0.6b")
    for label, cfg in (("full", base.reduced()),
                       ("sliding_window", long_context_variant(base).reduced())):
        model = build_model(cfg)
        cpu = model.init(0, device="cpu")
        card = tree_to(cpu, "cuda")
        tokens = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 100 + 4))
        caches = {device: model.prefill(params, tokens[:, :100], cache_len=110)
                  for device, params in (("cuda", card), ("cpu", cpu))}
        worst = float((caches["cuda"][0].cpu() - caches["cpu"][0]).abs().max())
        cg, cc = caches["cuda"][1], caches["cpu"][1]
        for step in range(4):
            tok = tokens[:, 100 + step:101 + step]
            lg, cg = model.decode_step(card, tok, cg)
            lc, cc = model.decode_step(cpu, tok, cc)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
        check(worst <= 1e-4, f"3i {label}: card and CPU logits differ by {worst}")
        outs = {}
        for device, params in (("cuda", card), ("cpu", cpu)):
            rng = np.random.default_rng(22)
            queue = [Request(i, rng.integers(0, cfg.vocab_size, 9).astype(np.int32), 6)
                     for i in range(5)]
            server = SlotServer(cfg, params, 2, 20)
            outs[device] = (serve(server, queue), [r.out for r in queue], server.length)
        check(outs["cuda"] == outs["cpu"], f"3i {label}: SlotServer differs: {outs}")
        out[label] = {"window": cfg.window_size if cfg.attention == "sliding_window" else 0,
                      "logits_max_abs_diff": worst, "server_ticks": outs["cuda"][0],
                      "server_tokens": sum(len(o) for o in outs["cuda"][1])}
    return out


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# training: attention's backward kernel (1m), DAG-FL training of qwen3-0.6b at
# full width (2m), card vs CPU (3m)
# ---------------------------------------------------------------------------


def bwd_tile_pairs(S, window, tile=32):
    """(query tile, key tile) pairs that csrc/flash_attention_bwd.cu visits a
    head: a query tile walks the key tiles from its window's first to its
    own diagonal."""
    pairs = 0
    for q0 in range(0, S, tile):
        first = max(0, q0 - window + 1) // tile * tile if window else 0
        pairs += (min(S, q0 + tile) - 1) // tile - first // tile + 1
    return pairs


def attention_bwd_resources(fa, cuda_build):
    """Registers, spills and stack of each backward kernel from nvcc's
    -Xptxas=-v report, and the dynamic shared memory its launcher asks for
    (``flash_attention_bwd_smem``, which asks the CUDA source)."""
    import re

    log = cuda_build.library_path(cuda_build.CSRC / "flash_attention_bwd.cu").with_suffix(".log")
    out, name = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d(bwd_[a-z]+_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)E", line)
        if entry:
            name = f"{entry.group(1)}<{'f32' if entry.group(2) == 'f' else 'bf16'}, " \
                   f"{entry.group(3)}>"
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    for kernel in out:
        smem = fa.flash_attention_bwd_smem(int(kernel.split(", ")[1][:-1]))
        out[kernel]["dynamic_smem"] = smem["dq" if kernel.startswith("bwd_dq") else "dkdv"]
    check(len(out) == 12, f"expected 12 backward kernels in the build log, found {sorted(out)}")
    check(all(r.get("spill_stores", 0) == 0 for r in out.values()),
          f"a backward kernel spills: {out}")
    return out


def attention_bwd_case(fa, name, B, H, KV, S, hd, dtype, window, gen, reps):
    """One shape of the backward kernel on the model's layout: error against
    the plain version run in f32 on the same inputs (within ATTN_TOL of each
    gradient entry's sum of absolute terms, plus one bf16 unit in bf16), the
    same bits twice, then times of the kernel, the plain version on the
    inputs as they are, the backward of ``scaled_dot_product_attention``
    (causal, or windowed through a boolean mask) on the same inputs, and the
    bound: five products of 2 hd operations a visible pair, q, k, v, do read
    and dq, dk, dv written once."""
    F = torch.nn.functional

    def draw(heads, scale=1.0):
        return (torch.randn((B, S, heads, hd), generator=gen, device="cuda") * scale).to(
            dtype).transpose(1, 2)

    q, k, v, do = draw(H, 0.5), draw(KV, 0.5), draw(KV), draw(H)
    got, again = fa.flash_attention_bwd(q, k, v, do, window), \
        fa.flash_attention_bwd(q, k, v, do, window)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"backward {name}: two calls differ")
    args32 = [t.float() for t in (q, k, v, do)]
    want = fa.flash_attention_bwd_plain(*args32, window)
    scale = fa.flash_attention_bwd_scale(*args32, window)
    errs, ratio = 0.0, 0.0
    for g, w, m in zip(got, want, scale):
        err = (g.float() - w).abs()
        tol = ATTN_TOL * m + (bf16_ulp(w) if dtype == torch.bfloat16 else 0.0)
        check(bool((err <= tol).all()), f"backward {name}: kernel off its plain version by "
              f"{float((err / tol).max())} of its bar")
        errs, ratio = max(errs, float(err.max())), max(ratio, float((err / tol).max()))
    del got, again, want, scale, args32
    torch.cuda.empty_cache()
    ms = device_ms(fa.flash_attention_bwd, [(q, k, v, do, window)] * reps, warmup=1)
    plain_ms = device_ms(fa.flash_attention_bwd_plain, [(q, k, v, do, window)] * 2, warmup=1)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if window:                         # the same function through an (S, S) boolean mask
        i, j = torch.arange(S, device="cuda")[:, None], torch.arange(S, device="cuda")[None, :]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=(j <= i) & (j > i - window),
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    library_ms = device_ms(lambda o, d: torch.autograd.grad(o, leaves, d, retain_graph=True),
                           [(out, do)] * reps, warmup=1)
    del out, leaves
    rows = torch.arange(S, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=window).sum() if window else (rows + 1).sum())
    flops = 10.0 * B * H * pairs * hd
    nbytes = (3 * B * H * S * hd + 4 * B * KV * S * hd) * q.element_size()
    bound_ms, bound_by = attention_bound(flops, nbytes, dtype)
    issued = 9 * 2.0 * 32 * 32 * hd * bwd_tile_pairs(S, window) * B * H
    return {"case": name, "B": B, "H": H, "KV": KV, "S": S, "hd": hd, "window": window,
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": errs,
            "max_err_over_tol": ratio, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops_achieved": flops / ms / 1e9,
            "ops_issued": issued, "issued_over_algorithm": issued / flops, "reps": reps}


def phase_attention_bwd_kernel(fa, cuda_build):
    """Phase 1m: the backward kernel against its plain version run in f32,
    at the training shape (qwen3-0.6b, 4 sequences of 128, bf16), B 1 at
    4,096, gemma-2b's MQA at hd 256 with a window, and an odd f32 shape;
    with the kernels' registers and shared memory. And B.9's forward at the
    training shape, as phase 1i holds it at the serving shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    forward = [prefill_case(fa, "train_main", 4, 16, 8, 128, 128, torch.bfloat16, 0, gen,
                            reps=20)]
    cases = [
        attention_bwd_case(fa, "main", 4, 16, 8, 128, 128, torch.bfloat16, 0, gen, reps=20),
        attention_bwd_case(fa, "long_4k", 1, 16, 8, 4096, 128, torch.bfloat16, 0, gen, reps=2),
        attention_bwd_case(fa, "mqa_hd256_window", 1, 8, 1, 2048, 256, torch.bfloat16, 512,
                           gen, reps=3),
        attention_bwd_case(fa, "odd_f32", 1, 10, 2, 333, 64, torch.float32, 0, gen, reps=10),
    ]
    torch.cuda.empty_cache()
    try:
        fa.flash_attention_bwd(*(torch.zeros((1, 4, 8, 48), device="cuda"),) * 4)
        check(False, "a head dim the backward kernel does not take was not refused")
    except ValueError:
        pass
    return {"cases": cases, "forward_cases": forward,
            "resources": attention_bwd_resources(fa, cuda_build)}


@contextlib.contextmanager
def no_plain_versions():
    """Make the plain versions of the training path's kernels raise while
    the block runs: the path on the card must launch the kernels."""
    from repro_torch.kernels import fedavg, flash_attention

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (flash_attention, "flash_attention_plain"), (flash_attention, "flash_attention_bwd_plain"),
        (fedavg, "fedavg_gather_plain"))]

    def refuse(*args, **kwargs):
        raise SmokeFailure("a plain version ran on the card's training path")

    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def stage_breakdown(prof, prefix="repro_torch.fl_step."):
    """Host ms of each profiler range ``prefix<stage>``, and on the device
    the span its kernels covered (the range's mirrored annotation) and the
    busy ms of the kernels inside that span."""
    spans = sorted(device_spans(prof))
    out = {}
    for e in prof.events():
        if not e.name.startswith(prefix):
            continue
        entry = out.setdefault(e.name[len(prefix):], {})
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy, cur = 0.0, start
            for s0, s1, _ in spans:
                lo, hi = max(s0, cur), min(s1, end)
                if hi > lo:
                    busy += hi - lo
                    cur = hi
            entry["device_span_ms"] = (end - start) / 1e3
            entry["device_busy_ms"] = busy / 1e3
        else:
            entry["host_ms"] = (end - start) / 1e3
    return out


def phase_train_path(cuda_build):
    """Phase 2m: ``launch.train.run`` of qwen3-0.6b at full width in bf16,
    TRAIN_STEPS DAG-FL steps of TRAIN_NODES nodes (4 sequences of 128 tokens
    a node, launch/train.py's defaults), twice with one seed: the two runs bitwise
    equal, every metric finite, every weight matrix moved off its init; s a
    step after the first, peak memory, launches a step of the three kernels (no plain
    version runs); one more step profiled (the device's idle share), built
    by ``make_trainer`` with run's own settings; Eq. (1) of the embedding and
    of a layer's leaf through ``aggregate`` held against the plain version on
    the same rows, slots and weights (phase 1's bar); the frontier and node
    0's parameters round-tripped through ``save_pytree``/``load_pytree``
    bitwise. At lr 3e-3 a bf16 norm scale of 1.0 moves only where the step
    passes half a bf16 unit, so the norms are reported, the weight matrices
    required to move."""
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import fedavg
    from repro_torch.launch.train import make_trainer, next_batch, run
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.sharding import fl_step
    from torch.profiler import ProfilerActivity, profile

    cfg = get_arch("qwen3-0.6b")
    L, nodes, steps = cfg.num_layers, TRAIN_NODES, TRAIN_STEPS
    settings = {"nodes": nodes, "batch_per_node": 4, "seq_len": 128, "lr": 3e-3, "seed": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    cuda_build.LAUNCHES.clear()
    with no_plain_versions():
        first, first_s = timed(run, cfg, steps=steps, log_every=steps, **settings)
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    leaves = len(tree_leaves(first.stacked))
    per_step = {name: launches.get(name, 0) / steps for name in
                ("flash_attention", "flash_attention_bwd", "fedavg_gather")}
    # a node's forward, its checkpointed recompute, and the scoring forward
    expected = {"flash_attention": 3 * nodes * L, "flash_attention_bwd": nodes * L,
                "fedavg_gather": nodes * leaves}
    check(per_step == expected, f"2m launches a step {per_step}, expected {expected}")
    second, second_s = timed(run, cfg, steps=steps, log_every=steps, **settings)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(first.stacked),
                                                 tree_leaves(second.stacked))),
          "2m: two runs with one seed give other parameters")
    check(all(torch.equal(a, b) for a, b in zip(first.frontier, second.frontier)),
          "2m: two runs with one seed give other frontiers")
    check(first.history == [dict(h, s=f["s"]) for h, f in zip(second.history, first.history)],
          "2m: two runs with one seed give other metrics")
    check(all(np.isfinite(v) for h in first.history for v in h.values()),
          f"2m: a metric is not finite: {first.history}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(first.stacked)),
          "2m: a parameter is not finite")
    del second
    trainer = make_trainer(cfg, device="cuda", **settings)
    init0 = dict(param_leaves(trainer.model.init(settings["seed"], device="cuda")))
    node0 = tree_map(lambda a: a[0], first.stacked)
    # every weight matrix moves; a norm scale of 1.0 moves only where lr * g
    # passes half a bf16 unit of 1.0 (2^-8), so those are counted, not required
    norms = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
    moved = {"/".join(path): not torch.equal(init0[path], p) for path, p in param_leaves(node0)}
    stuck = [name for name, m in moved.items() if not m and not set(name.split("/")) & set(norms)]
    check(not stuck, f"2m: node 0's {stuck} did not move")
    del init0

    # one more step, profiled: run's step, data and validation batch
    batch = next_batch(trainer.samplers, "cuda")
    trainer.step(first.stacked, first.frontier, batch, trainer.val_batch, 1)     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = trainer.step(first.stacked, first.frontier, batch, trainer.val_batch, 2)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    profiled = dict(trace_summary(prof, wall_ms), stages=stage_breakdown(prof))
    del out, prof, batch

    # Eq. (1) at the path's own shapes: the embedding's and a layer leaf's
    # (N, P) bf16 rows through aggregate's kernel route, against the plain
    # version on the same rows, slots and weights (the next step's draw)
    dcfg = trainer.dcfg
    sel = fl_step.select_peers(first.frontier, dcfg.alpha, dcfg.k, dcfg.tau_max,
                               settings["seed"] * 7 + steps)
    picked = {"embed": first.stacked["embed"], "layers/mlp/wi": first.stacked["layers"]["mlp"]["wi"]}
    agg = fl_step.aggregate(sel, picked)
    eq1 = {}
    for name, leaf in picked.items():
        rows, worst = leaf.reshape(nodes, -1), 0.0
        for i in range(nodes):
            want = fedavg.fedavg_gather_plain(rows, sel.slots[i], sel.weights[i])
            ok, err = fedavg_error(rows, sel.slots[i], sel.weights[i], agg[name][i].reshape(-1),
                                   want)
            check(ok, f"2m: Eq. (1) of {name} for node {i} off its plain version by {err}")
            worst = max(worst, err)
            del want
        eq1[name] = {"P": rows.shape[1], "dtype": str(leaf.dtype), "max_abs_err": worst}
    eq1["slots"], eq1["weights"] = sel.slots.tolist(), sel.weights.tolist()
    del agg, picked, sel
    torch.cuda.empty_cache()

    # the frontier and node 0's parameters through a checkpoint
    tree = {"params": node0, "frontier": first.frontier}
    template = {"params": tree_map(torch.empty_like, node0),
                "frontier": fl_step.Frontier(*map(torch.empty_like, first.frontier))}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        save_pytree(str(Path(tmp) / "node0"), tree, meta={"arch": cfg.name, "steps": steps})
        back = load_pytree(str(Path(tmp) / "node0"), template)
        ckpt_s = time.perf_counter() - t
        ckpt_bytes = (Path(tmp) / "node0.npz").stat().st_size
    check(all(torch.equal(a, b) and a.dtype == b.dtype and a.device == b.device
              for a, b in zip(tree_leaves(back["params"]), tree_leaves(node0))),
          "2m: node 0's parameters changed through the checkpoint")
    check(all(torch.equal(a, b) for a, b in zip(back["frontier"], first.frontier)),
          "2m: the frontier changed through the checkpoint")
    secs = [h["s"] for h in first.history]
    return {"arch": cfg.name, "dtype": cfg.dtype, "nodes": nodes, "steps": steps,
            "batch_per_node": 4, "seq_len": 128,
            "params_per_node": sum(p.numel() for p in tree_leaves(node0)),
            "run_s": first_s, "repeat_run_s": second_s, "step_s": secs,
            "s_per_step_after_first": sum(secs[1:]) / len(secs[1:]),
            "tokens_per_s_after_first": nodes * 4 * 128 * len(secs[1:]) / sum(secs[1:]),
            "peak_memory_bytes": peak, "allocated_before_bytes": held_before,
            "launches": launches, "launches_per_step": per_step, "leaves_moved": moved,
            "final_metrics": {k: v for k, v in first.history[-1].items() if k != "s"},
            "final_scores": first.frontier.scores.tolist(),
            "profiled_step": profiled, "eq1_against_plain": eq1,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_s": ckpt_s}


def phase_small_train_agreement(cuda_build):
    """Phase 3m: reduced qwen3-0.6b (f32) on the card and on the CPU from the
    same weights. Node 0's loss gradient on one batch: each leaf within
    TRAIN_GRAD_SHARE of its largest CPU entry, and through the backward
    kernel once a layer. Two DAG-FL steps of 4 nodes with the same draws
    (numpy): the frontiers equal (scores, counters, times), every
    parameter within TRAIN_PARAM_ATOL."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenSampler
    from repro_torch.launch.train import init_stacked, run
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import tree_leaves, tree_map, value_and_grad

    cfg = get_arch("qwen3-0.6b").reduced()
    model = build_model(cfg)
    cpu_params = init_stacked(model, 4, 0, torch.device("cpu"))
    toks = torch.from_numpy(TokenSampler(cfg.vocab_size, 4, 64, seed=0).next()["tokens"])
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        node0 = tree_map(lambda p: p[0].to(device), cpu_params)
        batch = {"tokens": toks.to(device), "labels": toks.to(device)}
        before = cuda_build.LAUNCHES["flash_attention_bwd"]
        (total, _), grads[device] = value_and_grad(model.loss, node0, batch, has_aux=True)
        losses[device] = float(total.detach())
        if device == "cuda":
            check(cuda_build.LAUNCHES["flash_attention_bwd"] - before == cfg.num_layers,
                  "3m: the card's gradient did not go through the backward kernel once a layer")
    grad_share = {}
    for (path, g), c in zip(param_leaves(grads["cuda"]), tree_leaves(grads["cpu"])):
        grad_share["/".join(path)] = float((g.cpu() - c).abs().max() / c.abs().max())
    check(max(grad_share.values()) <= TRAIN_GRAD_SHARE,
          f"3m: card and CPU gradients differ past {TRAIN_GRAD_SHARE} of a leaf: {grad_share}")
    draws = [torch.from_numpy(np.random.default_rng(31 + s).random((4, 4), dtype=np.float32)
                              * np.float32(0.999) + np.float32(1e-9)) for s in range(2)]
    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = run(cfg, steps=2, seq_len=64, lr=0.3, device=device,
                           params=tree_map(lambda p: p.to(device), cpu_params),
                           draws=lambda step: draws[step], log_every=2)
    card, cpu = runs["cuda"], runs["cpu"]
    worst = max(float((a.cpu() - b).abs().max())
                for a, b in zip(tree_leaves(card.stacked), tree_leaves(cpu.stacked)))
    check(worst <= TRAIN_PARAM_ATOL, f"3m: card and CPU parameters differ by {worst}")
    for name, a, b in zip(card.frontier._fields, card.frontier, cpu.frontier):
        check(torch.equal(a.cpu(), b), f"3m: the frontiers' {name} differ: {a} / {b}")
    return {"grad_max_diff_over_leaf_max": grad_share, "loss": losses,
            "steps": 2, "nodes": 4, "params_max_abs_diff": worst,
            "mean_val_acc": [h["mean_val_acc"] for h in card.history],
            "cpu_mean_val_acc": [h["mean_val_acc"] for h in cpu.history]}


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
    from repro_torch.kernels import flash_attention, gossip_merge, hist_bincount
    from repro_torch.kernels import model_distance, wkv

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
        distance_kernels = distance_device_kernels(model_distance)   # for phase 1h

        main_path = phase_main_path(cuda_build)
        print(json.dumps({"main_path": main_path}))
        print(json.dumps({"profile": phase_profile()}))
        # the paper's experiments run here, before the telemetry phases, after
        # which the profiler loses device events (2k profiles an LSTM step)
        t = time.perf_counter()
        print(json.dumps({"paper_experiments": phase_paper_experiments(cuda_build, main_path)}))
        print(f"[phase 2k] the paper's LSTM and the baselines: {time.perf_counter() - t:.1f} s")
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
        # profiled here, before the telemetry phases, after which the
        # profiler loses device events: the head kernel's time in the loop
        # and the host syncs a batch
        print(json.dumps({"profile_events": phase_profile(
            "run_dagfl_gossip",
            label="run_dagfl_gossip(engine=events, 1 Mbit/s, 0.5 s links, int4)",
            engine="events", **events_constrained_runs()["int4"])}))
        t = time.perf_counter()
        tip_sims = phase_tip_sims(cuda_build)
        print(json.dumps({"tip_sims": tip_sims}))
        print(f"[phase 2f] tip simulations: {time.perf_counter() - t:.1f} s")
        # serving, also before the telemetry phases: 2l profiles a window
        t = time.perf_counter()
        serve_path = phase_serve_main_path(cuda_build)
        print(json.dumps({"serve_main_path": serve_path}))
        print(f"[phase 2l] inference serving: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_serve_agreement": phase_small_serve_agreement()}))
        print(f"[phase 3l] inference serving, card against CPU: {time.perf_counter() - t:.1f} s")
        # training, also before the telemetry phases: 2m profiles a step
        t = time.perf_counter()
        train_path = phase_train_path(cuda_build)
        print(json.dumps({"train_main_path": train_path}))
        print(f"[phase 2m] qwen3-0.6b DAG-FL training: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_train_agreement": phase_small_train_agreement(cuda_build)}))
        print(f"[phase 3m] DAG-FL training, card against CPU: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        obs_paths = phase_obs_main_path(cuda_build, tip_sims["e_table1"]["runs"][0])
        print(json.dumps({"obs_main_path": obs_paths}))
        print(f"[phase 2g] telemetry paths: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        fault_paths = phase_fault_main_path(cuda_build)
        print(json.dumps({"fault_main_path": fault_paths}))
        print(f"[phase 2h] fault injection paths: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        model_path = phase_model_path(cuda_build)
        print(json.dumps({"model_main_path": model_path}))
        print(f"[phase 2i] qwen3-0.6b served: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rwkv_path = phase_rwkv_path(cuda_build)
        print(json.dumps({"rwkv_main_path": rwkv_path}))
        print(f"[phase 2j] rwkv6-7b served: {time.perf_counter() - t:.1f} s")

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
        t = time.perf_counter()
        print(json.dumps({"small_model_agreement": phase_small_model_agreement()}))
        print(f"[phase 3i] the dense model, card against CPU: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_rwkv_agreement": phase_small_rwkv_agreement()}))
        print(f"[phase 3j] the RWKV model, card against CPU: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        print(json.dumps({"small_paper_agreement": phase_small_paper_agreement()}))
        print(f"[phase 3k] the LSTM and the baselines, card against CPU: "
              f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        gossip_phase = phase_gossip_kernel(
            gossip_merge, cuda_build, events_paths["d_k_regular_jitter"]["live_edges_per_batch"])
        gossip_cases = gossip_phase["cases"]
        print(json.dumps({"gossip_cases": gossip_phase}))
        print(f"[phase 1b] gossip_winner vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        dedup_phase = phase_dedup_kernel(chunk_transfer, cuda_build)
        dedup_cases = dedup_phase["cases"]
        print(json.dumps({"dedup_cases": dedup_phase}))
        print(f"[phase 1c] chunk_dedup vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        codec_phase = phase_codec_kernel(delta_codec, cuda_build)
        fused_cases, topk_cases = codec_phase["fused"], codec_phase["topk"]
        print(json.dumps({"quant_cases": codec_phase["quant"]}))
        print(json.dumps({"fused_quant_cases": fused_cases}))
        print(json.dumps({"encode_decode": codec_phase["encode_decode"]}))
        print(json.dumps({"topk_cases": topk_cases}))
        print(json.dumps({"codec_resources": codec_phase["resources"]}))
        print(f"[phase 1d] codec kernels vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        pop_phase = phase_event_pop_kernel(event_pop, cuda_build)
        pop_cases = pop_phase["cases"]
        print(json.dumps({"event_pop_cases": pop_phase}))
        print(f"[phase 1e] event_pop vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        hist_cases = phase_hist_kernel(hist_bincount, cuda_build)
        print(json.dumps({"hist_bincount_cases": hist_cases}))
        print(f"[phase 1f] hist_bincount vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        distance_cases = phase_distance_kernel(model_distance, cuda_build, distance_kernels)
        print(json.dumps({"model_distance_cases": distance_cases}))
        print(f"[phase 1h] model_distance vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        attention_cases = phase_attention_kernels(flash_attention, cuda_build)
        print(json.dumps({"attention_cases": attention_cases}))
        print(f"[phase 1i] attention kernels vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        wkv_phase = phase_wkv_kernel(wkv, cuda_build)
        wkv_cases, wkv_scan_cases = wkv_phase["chunked"], wkv_phase["scan"]
        print(json.dumps({"wkv_cases": wkv_phase}))
        print(f"[phase 1j] wkv kernel vs plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        bwd_phase = phase_attention_bwd_kernel(flash_attention, cuda_build)
        print(json.dumps({"attention_bwd_cases": bwd_phase}))
        print(f"[phase 1m] attention backward vs plain: {time.perf_counter() - t:.1f} s")
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
            ("quant_blocks", fused_cases, "main_int8", "1mbps_int8", 76),
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
            # quant: the commit's launch, decoded payload included; no library
            # call quantises. topk: torch.topk + scatter
            "library_ms": main_case["library_ms"],
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
    # the update the loop launches: binning, bincount and add in one launch
    hist_main = next(c for c in hist_cases["record_cases"] if c["case"] == "record_merge")
    kernels.append({
        "name": "hist_bincount",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_bincount.cu",
        "replaces": "src/repro/kernels/hist_bincount.py:52",
        "launches": obs_paths["ticks_main"]["launches_obs_on"].get("hist_bincount", 0),
        "max_abs_err": max(c["max_abs_err"] for c in hist_cases["cases"]
                           + hist_cases["record_cases"]),
        "ms": hist_main["ms"],
        "kernel_ms": hist_main["ms"],
        "call_ms": hist_main["call_ms"],
        "plain_ms": hist_main["plain_ms"],
        "bound_ms": hist_main["bound_ms"],
        "bound_by": hist_main["bound_by"],
        "library_ms": hist_main["library_ms"],   # none: no one call bins on a log scale
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
    for name, step, line in (("flash_attention", "prefill", 87),
                             ("decode_attention", "decode", 180)):
        cases = attention_cases[step]
        main_case = next(c for c in cases if c["case"] == "main")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": model_path["launches"].get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"],
            "kernel_ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],   # scaled_dot_product_attention
        })
    wkv_main = next(c for c in wkv_cases if c["case"] == "main")
    kernels.append({
        "name": "wkv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:80",
        "launches": rwkv_path["launches"].get("wkv", 0),
        "max_abs_err": max(c["max_abs_err_vs_plain"] for c in wkv_cases),
        "ms": wkv_main["ms"],
        "kernel_ms": wkv_main["ms"],
        "plain_ms": wkv_main["plain_ms"],
        "bound_ms": wkv_main["bound_ms"],
        "bound_by": wkv_main["bound_by"],
        "library_ms": None,          # no single PyTorch call computes the WKV recurrence
    })
    scan_main = next(c for c in wkv_scan_cases if c["case"] == "decode")
    kernels.append({
        "name": "wkv_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wkv.cu",
        # replaces no Pallas kernel: the reference's decode runs wkv_scan, plain JAX
        "replaces": "none (src/repro/models/rwkv.py:72, wkv_scan, plain JAX)",
        "launches": rwkv_path["launches"].get("wkv_scan", 0),
        "max_abs_err": max(c["max_abs_err_vs_plain"] for c in wkv_scan_cases),
        "ms": scan_main["ms"],
        "kernel_ms": scan_main["ms"],
        "plain_ms": scan_main["plain_ms"],
        "bound_ms": scan_main["bound_ms"],
        "bound_by": scan_main["bound_by"],
        "library_ms": None,          # no single PyTorch call computes the recurrence
    })
    bwd_main = next(c for c in bwd_phase["cases"] if c["case"] == "main")
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # replaces no Pallas kernel: the reference differentiates chunked_sdpa by XLA autodiff
        "replaces": "none (src/repro/models/attention.py:112, chunked_sdpa, XLA autodiff)",
        "launches": train_path["launches"].get("flash_attention_bwd", 0),
        "max_abs_err": max(c["max_abs_err"] for c in bwd_phase["cases"]),
        "ms": bwd_main["ms"],
        "kernel_ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": bwd_main["library_ms"],   # scaled_dot_product_attention's backward
    })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
