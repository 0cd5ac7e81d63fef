#!/usr/bin/env python3
"""Time the event-queue head, the codec's top-k, the merge-winner and the
chunk-dedup kernels of one source tree.

    python3 scripts/torch_kernel_ab.py [--src DIR]

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
- a launch's floor: the device ms of a one-element in-place add;
- with ``--profile-events``, ``chip_smoke.py``'s profiled window of the
  events engine's path (c) with int4 (40 iterations): the head, winner and
  dedup kernels' device ms a launch in the loop, the host syncs a batch,
  the device's idle share.

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

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (timing helpers, queues, payloads)

HOT_REPS = 200
TOPK_REPS = 40


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree holding repro_torch")
    ap.add_argument("--profile-events", action="store_true",
                    help="also profile the events engine's path (c) with int4")
    opts = ap.parse_args()
    src = opts.src
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core.aggregation import leaf_shapes
    from repro_torch.fl.tasks import CNNTask
    from repro_torch.kernels import chunk_transfer as ck
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import event_pop as ep
    from repro_torch.kernels import gossip_merge as gm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    main_layout = dc.leaf_layout(leaf_shapes(CNNTask().init(0, "cpu")))
    try:
        heads = [time_head(ep, "deliver", smoke.MAIN_EDGES, "deliver", gen),
                 time_head(ep, "bank", 2 * smoke.MAIN_EDGES, "bank", gen)]
        topk = [time_topk(dc, main_layout, k, gen) for k in (1, 8, 33, 128)]
        winner = smoke.phase_gossip_kernel(gm, cuda_build)
        dedup = smoke.phase_dedup_kernel(ck, cuda_build)
    except smoke.SmokeFailure as e:
        print(f"torch_kernel_ab: FAILED: {e}", file=sys.stderr)
        return 1
    one = torch.zeros(1, device="cuda")
    floor_ms = smoke.device_ms(lambda t: t.add_(1.0), [(one,)] * HOT_REPS)
    out = {"src": src, "card": smoke.nvidia_smi_line(), "event_head": heads,
           "topk_leaves": topk, "gossip_winner": winner, "chunk_dedup": dedup,
           "launch_floor_ms": floor_ms}
    if opts.profile_events:
        prof = smoke.phase_profile(
            "run_dagfl_gossip", label="events (c) int4", engine="events",
            **smoke.events_constrained_runs()["int4"])
        out["profile_events"] = {k: prof.get(k) for k in (
            "wall_ms", "device_idle_share", "event_batches", "host_syncs",
            "host_syncs_per_batch", "event_pop_in_loop", "gossip_winner_in_loop",
            "chunk_dedup_in_loop")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
