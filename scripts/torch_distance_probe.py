#!/usr/bin/env python3
"""Where the model-distance kernel's time goes, on one CUDA card.

    python3 scripts/torch_distance_probe.py [--variants NAME ...]

On a machine with a CUDA card and nvcc. Builds ``csrc/model_distance.cu``
as it stands, and variants of it, each with a clock stamp (``%globaltimer``)
per block at four points: the summing warps' start, the end of their loop,
the ticket, and the end of the finish. Then, for the phase 1h shapes of
``chip_smoke.py`` (k = 5 and 16 at the CNN's width, 32 x 100,003) and two
small ones, prints one JSON line a variant and shape:

- ``ms``: device ms a call (CUDA events around 40 calls behind a spin
  kernel, candidates cycled past the 50 MB L2, as ``chip_smoke.device_ms``);
- from one more call's stamps: the blocks' loop times from their start
  (max, min; the first stage's wait included), the ticket and the finish,
  in µs;
- ``sum_ms``: the device ms of ``x.sum()`` on the same copies, one PyTorch
  call that reads the candidates once (a streaming yardstick).

Variants: ``kernel`` (the source as is) and ``loads_only`` (the summing warps
take every stage but form no product: the load path alone). The built
variants go to ``build/kernels/probe`` (gitignored). Development use only:
nothing of the port imports this.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STAMPS = 4096 * 8          # 8 slots a block, 4,096 blocks at most

DEBUG = '''
__device__ long long g_probe[%d];
int probe_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof g_probe);
}
int probe_clear() {
  static long long zeros[%d];
  return (int)cudaMemcpyToSymbol(g_probe, zeros, sizeof zeros);
}
''' % (STAMPS, STAMPS)

EXPORTS = '''
extern "C" int model_distance_probe_read(long long* host) { return probe_read(host); }
extern "C" int model_distance_probe_clear() { return probe_clear(); }
'''

# (anchor in the source, stamp index placed before it)
ANCHORS = [
    ("    float acc[kTile][kTile];\n", 0),
    ("  // the last block to finish sums", 2),
    ("  if (!s_last) return;\n", 3),
    ("  if (tid == 0) *ticket = 0u;", 4),
]

VARIANTS = {
    "kernel": [],
    "loads_only": [("      switch (shape) {", "      if (false) switch (shape) {")],
}

CASES = [("main_k5", 5, 1_663_370), ("main_k16", 16, 1_663_370), ("k32_ragged", 32, 100_003),
         ("k7_n33", 7, 33), ("k1", 1, 4_097)]


def stamp(i: int) -> str:
    return ('if (threadIdx.x == 0) { long long t; '
            'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); '
            f'g_probe[blockIdx.x * 8 + {i}] = t; }}\n')


def variant_source(name: str) -> str:
    src = (ROOT / "src/repro_torch/csrc/model_distance.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"probe: the source has no {old!r} (variant {name})")
        src = src.replace(old, new, 1)
    src = src.replace("namespace {\n", "namespace {\n" + DEBUG, 1)
    for anchor, i in ANCHORS:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe: the source has {src.count(anchor)} of {anchor!r}")
        indent = anchor[:len(anchor) - len(anchor.lstrip())]
        src = src.replace(anchor, indent + stamp(i) + anchor, 1)
    return src + EXPORTS


def build(names):
    from repro_torch.kernels import cuda_build

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name))
        so = out_dir / f"{name}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        running.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in running:
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.model_distance.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.model_distance_workspace.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.model_distance_workspace.restype = ctypes.c_longlong
        lib.model_distance_probe_read.argtypes = [ctypes.c_void_p]
        libs[name] = (lib, [line.strip() for line in report.splitlines() if "registers" in line])
    return libs


def events_ms(fn, reps):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)           # the queue holds while the host enqueues
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe(lib, xs):
    k, n = xs[0].shape
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty((k, k), device="cuda")
    work = torch.empty(lib.model_distance_workspace(k, n), device="cuda")

    def call(i):
        x = xs[i % len(xs)]
        code = lib.model_distance(x.data_ptr(), x.stride(0), k, n, out.data_ptr(), None,
                                  work.data_ptr(), ticket.data_ptr(), x.device.index or 0,
                                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"probe: launch failed ({code})")

    ms = events_ms(call, 40)
    torch.cuda.synchronize()
    lib.model_distance_probe_clear()
    call(0)
    torch.cuda.synchronize()
    raw = (ctypes.c_longlong * STAMPS)()
    lib.model_distance_probe_read(raw)
    blocks = [[raw[b * 8 + i] for i in range(5)] for b in range(STAMPS // 8) if raw[b * 8]]
    finish = [b for b in blocks if b[4]]
    us = 1e-3
    return {"ms": ms, "blocks": len(blocks),
            "loop_us_max": max(b[2] - b[0] for b in blocks) * us,
            "loop_us_min": min(b[2] - b[0] for b in blocks) * us,
            "ticket_us_max": max(b[3] - b[2] for b in blocks) * us,
            "finish_us": (finish[0][4] - finish[0][3]) * us if finish else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=list(VARIANTS))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_distance_probe: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build(opts.variants)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for case, k, n in CASES:
        copies = min(16, max(1, -(-120_000_000 // (4 * k * n))))
        xs = [torch.randn((k, n), generator=gen, device="cuda") for _ in range(copies)]
        sum_ms = events_ms(lambda i: xs[i % len(xs)].sum(), 40)
        for name, (lib, registers) in libs.items():
            print(json.dumps({"card": card, "case": case, "k": k, "N": n, "variant": name,
                              "registers": registers, **probe(lib, xs), "sum_ms": sum_ms}),
                  flush=True)
        del xs
    return 0


if __name__ == "__main__":
    sys.exit(main())
