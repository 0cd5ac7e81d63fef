#!/usr/bin/env python3
"""Time the event-queue head, the codec's kernels, the merge-winner, the
chunk-dedup, the histogram and the model-distance kernels of one source
tree, and with ``--runs`` the telemetry and codec paths they serve.

    python3 scripts/torch_kernel_ab.py [--src DIR] [--only GROUP ...] [--profile-events] [--runs]

On a machine with a CUDA card and nvcc. Loads ``repro_torch`` from ``DIR``
(default: this checkout's ``src``), builds its ``event_pop.cu``,
``delta_codec.cu``, ``gossip_merge.cu`` and ``chunk_dedup.cu`` (into
``build/kernels`` beside that tree), holds each kernel bitwise against its
plain version, and prints one JSON line:

- the head kernel (``event_head``) at Q = 9,900 (the full overlay's
  delivery slots) and 19,800 (with the bank's drain slots): device ms hot
  (one queue again and again) and cold (queues cycled past the 50 MB L2),
  and the wall ms of a launch with its read back, through ``read_head`` and,
  where the tree has it, through ``pop_head`` (the pinned mirror);
- the top-k kernel (``topk_leaves``) at the paper's CNN blocked leaf by
  leaf, k = 1, 8, 33 and 128, with a base: device ms;
- the merge winner (``gossip_winner``) at every case of ``chip_smoke.py``'s
  phase 1b (density 0.5, the union fold, a receiver block, ragged rows, 400
  replicas, the full overlay, an events batch of path (d)) and the chunk
  dedup (``chunk_dedup``) at every case of its phase 1c (a tick, the gate,
  ragged, NaN and signed zeros, one class, 400 replicas, the edge columns,
  a store past one hash table): device ms, plain ms, the bound, and the
  kernel's registers and shared memory;
- the histogram update (``obs.hist.record``: in one launch where the tree
  fuses it, else ``bin_index``, the bincount kernel and the add) at the
  loop's four shapes of ``chip_smoke.py``'s phase 1f, bitwise against
  ``bin_index`` + ``hist_bincount_plain`` + add, and the idx route
  (``hist_bincount``) at its four cases: device ms;
- the quantisation (``quant_leaves`` over the flat payload) at the CNN,
  int8 and int4, and at 4x scale, and the commit's encode + decode of the
  CNN's own leaves (``DeltaCodec.encode_decode`` where the tree has it,
  else ``decode(encode(...))``), bitwise against the plain versions:
  device ms;
- the model distance (``model_distance``) at ``chip_smoke.py``'s phase 1h
  cases ``main_k5``, ``main_k16`` and ``k32_ragged`` (within its tolerance
  of the plain version, views bitwise, the device kernels a call) and the
  screen's call (``parameter_outlier_scores`` on five candidates of the
  CNN's width, cycled past L2, against the CPU): device ms and call ms;
- a launch's floor: the device ms of a one-element in-place add;
- with ``--profile-events``, ``chip_smoke.py``'s profiled window of the
  events engine's path (c) with int4 (40 iterations): the head, winner and
  dedup kernels' device ms a launch in the loop, the host syncs a batch,
  the device's idle share;
- with ``--runs``, at full width: ``chip_smoke.py``'s phase 2g pairs
  (telemetry off, then on, 100 iterations) on the gossip main path, the
  Table-I bank and the events engine's path (c) with int4, and its phase
  2d runs at 1 Mbit/s raw, int8 and int4 (200 iterations): ms an iteration,
  the commit's ``stage_ms``, the launches, and a digest of each run
  (curve, latency, every ledger column, bank transport, lag, bytes,
  parameters, a checksum of the bank rows; telemetry's counts apart), so
  that two trees' runs can be compared bit for bit.

The timings are ``chip_smoke.py``'s (``device_ms``, ``call_ms``) on its
queues and payloads. To compare two trees on one card, unpack the other
into a directory that ``.gitignore`` lists and run both in one call, in
turns: A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (timing helpers, queues, payloads)

HOT_REPS = 200
TOPK_REPS = 40
GROUPS = ["event_head", "topk_leaves", "gossip_winner", "chunk_dedup", "record",
          "quant_leaves", "model_distance"]


def time_head(ep, name, q, case, gen):
    copies = -(-smoke.POP_COLD_BYTES // (smoke.EVENT_POP_BYTES_PER_SLOT * q))
    queues = [smoke.pop_queue(gen, q, case) for _ in range(copies)]
    for args in queues[:3]:
        got, want = ep.event_head(*args), ep.event_head_plain(*args)
        smoke.check(torch.equal(got, want), f"{name}: {got.tolist()} != {want.tolist()}")
    hot = [queues[0]] * HOT_REPS
    return {
        "case": name, "Q": q,
        "ms_hot": smoke.device_ms(ep.event_head, hot),
        "ms_cold": smoke.device_ms(ep.event_head, queues),
        "event_head_and_read_head_ms": smoke.call_ms(
            lambda *a: ep.read_head(ep.event_head(*a)), hot),
        "pop_head_ms": smoke.call_ms(ep.pop_head, hot) if hasattr(ep, "pop_head") else None,
    }


def time_topk(dc, layout, k, gen):
    rows = smoke.codec_rows(gen, layout, "random")
    bases = smoke.codec_rows(gen, layout, "random")
    args = [(rows[i % len(rows)], bases[i % len(rows)], layout, k) for i in range(TOPK_REPS)]
    got = dc.topk_leaves(*args[0])
    want = dc.topk_blocks_plain(dc.blocked(args[0][0] - args[0][1], layout), k)
    smoke.check(smoke.same_bits(got, want), f"topk k = {k}: differs from its plain version")
    return {"case": f"main_k{k}", "k": k, "ms": smoke.device_ms(dc.topk_leaves, args)}


def time_record(hist_lib, hb, case, gen):
    """The loop's histogram update at one of phase 1f's shapes, through
    ``record`` as the tree has it, bitwise against the unfused plain path."""
    cfg = hist_lib.HistConfig()
    batches = [smoke.record_batch(gen, case, cfg) for _ in range(8)]
    for counts, values, w in batches:
        want = counts + hb.hist_bincount_plain(hist_lib.bin_index(values, cfg),
                                               w.to(torch.int32), cfg.bins + 1)
        smoke.check(torch.equal(hist_lib.record(counts, values, w, cfg), want),
                    f"record {case}: differs from its plain version")
    # unfused, about 95 launches a call: four calls, or the queue behind the
    # spin fills and blocks the host
    fused = hasattr(hist_lib, "record_plain")
    return {"case": f"record_{case}", "fused": fused, "ms": smoke.device_ms(
        lambda c, v, w: hist_lib.record(c, v, w, cfg), batches * 25 if fused else batches[:4])}


def time_quant(dc, layout, qmax, gen, name):
    rows = smoke.codec_rows(gen, layout, "random", qmax)
    args = [(rows[i % len(rows)], layout, qmax) for i in range(TOPK_REPS)]
    codes, scales = dc.quant_leaves(*args[0])
    want_c, want_s = dc.quant_blocks_plain(dc.blocked(args[0][0], layout), qmax)
    smoke.check(smoke.same_bits(codes, want_c) and smoke.same_bits(scales, want_s),
                f"quant {name}: differs from its plain version")
    return {"case": name, "ms": smoke.device_ms(dc.quant_leaves, args)}


def time_encode_decode(dc, layout, kind, gen):
    """The commit's encode and decode of the CNN's own leaf tensors."""
    codec = dc.DeltaCodec(kind)
    rows = smoke.codec_rows(gen, layout, "random")
    fv = layout.first_value
    params = [{n: row[v0:v1].clone() for n, v0, v1 in zip(layout.names, fv, fv[1:])}
              for row in rows]
    base = {n: torch.zeros_like(v) for n, v in params[0].items()}
    if hasattr(codec, "encode_decode"):
        fn = codec.encode_decode
    else:
        def fn(p, b):
            enc = codec.encode(p, b)
            return enc, codec.decode(enc, b)
    enc, dec = fn(params[0], base)
    flat = dc.flatten_params(params[0])
    codes, scales = dc.quant_blocks_plain(dc.blocked(flat, layout), codec_qmax(kind))
    want = dc.dequant_blocks_plain(codes, scales)
    got = torch.cat([dec[n].reshape(-1) for n in layout.names])
    blocks = torch.cat([want[b0:b1].reshape(-1)[:v1 - v0] for b0, b1, v0, v1 in zip(
        layout.first_block, layout.first_block[1:], fv, fv[1:])])
    smoke.check(smoke.same_bits(got, blocks), f"encode+decode {kind}: differs from plain")
    args = [(params[i % len(params)], base) for i in range(TOPK_REPS)]
    return {"case": f"encode_decode_{kind}", "fused": hasattr(codec, "encode_decode"),
            "ms": smoke.device_ms(fn, args), "call_ms": smoke.call_ms(fn, args)}


def time_screen(anomaly, gen, k=5):
    """The screen's call on k candidates of the CNN's width, copies cycled
    past the 50 MB L2, each within DIST_TOL of the CPU's scores: device ms,
    call ms and the device operations a call."""
    n = smoke.MAIN_P
    args = [(torch.randn((k, n), generator=gen, device="cuda"),) for _ in range(4)]
    for (x,) in args[:2]:
        got, want = anomaly.parameter_outlier_scores(x).cpu(), anomaly.parameter_outlier_scores(
            x.cpu())
        scale = smoke.distance_scale(x.cpu())
        row_scale = (scale.sum(1) - scale.diagonal()) / max(k - 1, 1)
        err = (got.double() - want.double()).abs()
        smoke.check(bool((err <= smoke.DIST_TOL * row_scale).all()),
                    f"screen: card off the CPU by {float(err.max())}")
    kernels = smoke.device_kernels_a_call(anomaly.parameter_outlier_scores, args[0][0])
    return {"case": "screen_k5", "k": k, "N": n,
            "ms": smoke.device_ms(anomaly.parameter_outlier_scores, args * 10),
            "call_ms": smoke.call_ms(anomaly.parameter_outlier_scores, args * 10),
            "device_kernels_a_call": None if kernels is None else len(kernels),
            "device_kernel_names": kernels}


def time_distance(md, anomaly, gen):
    """``chip_smoke.py``'s phase 1h cases main_k5, main_k16 and k32_ragged,
    and the screen's call."""
    kernels = smoke.distance_device_kernels(md)
    cases = [smoke.distance_case(md, name, k, n, gen, kernels[name], zero_row=zero_row, reps=reps)
             for name, k, n, zero_row, reps in smoke.DISTANCE_CASES
             if name in ("main_k5", "main_k16", "k32_ragged")]
    keep = ("case", "ms", "plain_ms", "call_ms", "library_ms", "bound_ms", "max_abs_err",
            "device_kernels_a_call", "plan")
    return [{key: c[key] for key in keep} for c in cases] + [time_screen(anomaly, gen)]


def codec_qmax(kind):
    return {"int8": 127, "int4": 7}[kind]


def run_digest(res):
    """sha256 of everything a run computes but telemetry: curve, latency,
    the union's and every replica's ledger columns, the bank's transport
    state, lag, divergence, bytes, the final parameters and a checksum of
    every bank row; and, apart, of telemetry's histogram counts."""
    import hashlib

    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous().reshape(-1)
            h.update(x.view(torch.uint8).numpy().tobytes() if x.numel() else b"")
        else:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())

    add(np.float64(res.avg_latency))
    for name in ("iters", "times", "accs"):
        add(getattr(res, name))
    ex = res.extras
    for dags in (ex["dag"], ex["replicas"].dags):
        for name in smoke.LEDGER_COLUMNS:
            add(getattr(dags, name))
    for name in sorted(res.final_params):
        add(res.final_params[name])
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final"):
        if key in ex:
            add(ex[key])
    for key in ("sync_rounds", "approvals_issued", "approvals_in_union", "bank_bytes_sent"):
        if key in ex:
            add(np.float64(ex[key]))
    reps = ex["replicas"]
    if reps.bank_state is not None:
        for name in ("have", "credit", "sent"):
            add(getattr(reps.bank_state, name))
    if reps.bank is not None:
        rows = reps.bank.rows.view(torch.int32).long()
        weight = torch.arange(rows.shape[-1], device=rows.device) % 1009 + 1
        add((rows * weight).sum(dim=-1))
    out = {"run_digest": h.hexdigest()}
    if "obs" in ex:
        hh = hashlib.sha256()
        for name, counts in sorted(ex["obs"].hist["counts"].items()):
            hh.update(name.encode() + np.ascontiguousarray(counts).tobytes())
        out["hist_digest"] = hh.hexdigest()
    return out


def full_run(cuda_build, iterations, **options):
    """One full-width ``run_dagfl_gossip``: ms an iteration, the commit's
    stage ms, launches, digests."""
    import time

    from repro_torch.configs.dagfl_paper_tasks import CNN_TASK
    from repro_torch.fl.systems import SimConfig, run_dagfl_gossip
    from repro_torch.fl.tasks import CNNTask

    dcfg = CNN_TASK.dagfl
    nodes, gval = smoke.paper_setup(dcfg.num_nodes, 28)
    sim = SimConfig(iterations=iterations, eval_every=smoke.EVAL_EVERY, minibatch=dcfg.minibatch)
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    t = time.perf_counter()
    res = run_dagfl_gossip(CNNTask(), nodes, dcfg, sim, gval, device="cuda", **options)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    out = {"ms_per_iteration": 1e3 * wall_s / iterations,
           "commit_ms": res.extras["stage_ms"]["commit"],
           "stage_ms": res.extras["stage_ms"], "launches": dict(cuda_build.LAUNCHES),
           **run_digest(res)}
    del res
    torch.cuda.empty_cache()
    return out


def path_runs(cuda_build):
    """2g's pairs (obs off, then on) and 2d's 1 Mbit/s runs."""
    from repro_torch.obs import HistConfig, ObsConfig

    obs = {}
    for name, options in smoke.obs_runs().items():
        if name == "codec_1mbps_int4":
            continue
        off = full_run(cuda_build, smoke.OBS_ITERATIONS, **options)
        on = full_run(cuda_build, smoke.OBS_ITERATIONS, obs=ObsConfig(hist=HistConfig()),
                      **options)
        smoke.check(on["run_digest"] == off["run_digest"], f"obs {name}: on != off")
        obs[name] = {"off": off, "on": on,
                     "obs_ms_per_iteration": on["ms_per_iteration"] - off["ms_per_iteration"]}
    codec = {name: full_run(cuda_build, smoke.ITERATIONS, **options)
             for name, options in smoke.constrained_runs().items() if name != "topk"}
    return {"obs": obs, "codec_1mbps": codec}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree holding repro_torch")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="time only these kernel groups")
    ap.add_argument("--profile-events", action="store_true",
                    help="also profile the events engine's path (c) with int4")
    ap.add_argument("--runs", action="store_true",
                    help="also run 2g's obs pairs and 2d's 1 Mbit/s runs at full width")
    opts = ap.parse_args()
    src = opts.src
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core import anomaly
    from repro_torch.core.aggregation import leaf_shapes
    from repro_torch.fl.tasks import CNNTask
    from repro_torch.kernels import chunk_transfer as ck
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import event_pop as ep
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import hist_bincount as hb
    from repro_torch.kernels import model_distance as md
    from repro_torch.obs import hist as hist_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    main_layout = dc.leaf_layout(leaf_shapes(CNNTask().init(0, "cpu")))
    scale = dc.dense_layout(4 * smoke.MAIN_CODEC_BLOCKS, dc.BLOCK)
    groups = {      # each group's keys of the JSON line
        "event_head": lambda: {"event_head": [
            time_head(ep, "deliver", smoke.MAIN_EDGES, "deliver", gen),
            time_head(ep, "bank", 2 * smoke.MAIN_EDGES, "bank", gen)]},
        "topk_leaves": lambda: {"topk_leaves": [time_topk(dc, main_layout, k, gen)
                                                for k in (1, 8, 33, 128)]},
        "gossip_winner": lambda: {"gossip_winner": smoke.phase_gossip_kernel(gm, cuda_build)},
        "chunk_dedup": lambda: {"chunk_dedup": smoke.phase_dedup_kernel(ck, cuda_build)},
        "record": lambda: {
            "record": [time_record(hist_lib, hb, case, gen)
                       for case in ("merge", "commit", "chunk", "uniform")],
            "hist_bincount": [{k: c[k] for k in ("case", "ms", "plain_ms", "call_ms")}
                              for c in (smoke.hist_case(hb, case, case, gen)
                                        for case in ("merge", "commit", "chunk", "uniform"))]},
        "quant_leaves": lambda: {
            "quant_leaves": [time_quant(dc, main_layout, 127, gen, "main_int8"),
                             time_quant(dc, main_layout, 7, gen, "main_int4"),
                             time_quant(dc, scale, 127, gen, "scale_4x_int8")],
            "encode_decode": [time_encode_decode(dc, main_layout, kind, gen)
                              for kind in ("int8", "int4")]},
        "model_distance": lambda: {"model_distance": time_distance(md, anomaly, gen)},
    }
    out = {"src": src, "card": smoke.nvidia_smi_line()}
    try:
        for name in GROUPS:
            if name in opts.only:
                out.update(groups[name]())
    except smoke.SmokeFailure as e:
        print(f"torch_kernel_ab: FAILED: {e}", file=sys.stderr)
        return 1
    one = torch.zeros(1, device="cuda")
    out["launch_floor_ms"] = smoke.device_ms(lambda t: t.add_(1.0), [(one,)] * HOT_REPS)
    if opts.profile_events:
        prof = smoke.phase_profile(
            "run_dagfl_gossip", label="events (c) int4", engine="events",
            **smoke.events_constrained_runs()["int4"])
        out["profile_events"] = {k: prof.get(k) for k in (
            "wall_ms", "device_idle_share", "event_batches", "host_syncs",
            "host_syncs_per_batch", "event_pop_in_loop", "gossip_winner_in_loop",
            "chunk_dedup_in_loop", "hist_bincount_in_loop", "quant_blocks_in_loop")}
    print(json.dumps(out), flush=True)
    if opts.runs:
        try:
            runs = path_runs(cuda_build)
        except smoke.SmokeFailure as e:
            print(f"torch_kernel_ab: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"src": src, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
