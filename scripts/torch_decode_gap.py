#!/usr/bin/env python3
"""How far the served model's decode step lies from its full forward, by
precision, and how much of that is the matmuls' shape.

    python3 scripts/torch_decode_gap.py                    # one CUDA card, full width
    python3 scripts/torch_decode_gap.py --arch rwkv6-7b
    python3 scripts/torch_decode_gap.py --device cpu --reduced [--arch rwkv6-7b]

For qwen3-0.6b (the same seeded init in bf16 and in f32: the bf16 weights are
the f32 draws rounded) and a prompt of S tokens, ``prefill`` of S tokens then
``decode_step`` of token S is compared with ``forward`` of S + 1 tokens at its
last position, for S in 64, 1,024 and 8,192. In bf16 prefill and decode run
three times: as they are, then with every ``x @ w`` of fewer rows run at 8
rows, then at forward's S + 1 rows (the added rows zero, the kept rows
returned), so that each matmul takes the kernel of that shape and only its
shape changes. Each case prints one JSON line: the largest and mean |decode -
forward| of the logits, the share over the reference's 2e-2 + 2e-2 |logit|,
prefill's last logits against forward's, and, in bf16, both against the f32
forward.

For rwkv6-7b (``--arch rwkv6-7b``) it does what ``chip_smoke.py`` phase 2j
does: ``prefill`` of S - 32 tokens and 32 ``decode_step``s fed the true
tokens, against ``forward`` of S tokens at those 33 positions, for S in 64,
1,024 and 8,192 (multiples of 32, so forward runs the WKV kernel; decode
runs the sequential scan). In bf16 it also runs prefill and decode with
every ``x @ w`` at forward's S rows, and, for S up to 1,024, forward with
the sequential scan in place of the chunked WKV; each line adds how far
bf16's forward and decode lie from the f32 forward.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


class MatmulRows(TorchFunctionMode):
    """Runs every ``x @ w`` (w a matrix) whose x holds fewer than ``rows``
    rows at ``rows`` rows, the added rows zero, and returns the rows of x."""

    def __init__(self, rows):
        super().__init__()
        self.rows = rows

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in ("matmul", "__matmul__") and args[1].dim() == 2:
            x, w = args
            n = x.numel() // x.shape[-1]
            if n < self.rows:
                flat = x.reshape(n, x.shape[-1])
                padded = torch.cat([flat, flat.new_zeros(self.rows - n, flat.shape[1])])
                return (padded @ w)[:n].reshape(*x.shape[:-1], w.shape[-1])
        return func(*args, **kwargs)


def prefill_decode(model, params, tokens, S):
    """(decode's logits on token S, prefill's last logits)."""
    last, cache = model.prefill(params, tokens[:, :S], cache_len=S + 4)
    step, _ = model.decode_step(params, tokens[:, S:S + 1], cache)
    return step[0, 0].float(), last[0, 0].float()


def case_line(dtype, rows, S, fwd, prev, dec, pre):
    err = (dec - fwd).abs()
    return {"dtype": dtype, "matmul_rows": rows, "prompt": S,
            "decode_vs_forward_max": float(err.max()), "decode_vs_forward_mean": float(err.mean()),
            "share_over_2e-2": float((err > 2e-2 + 2e-2 * fwd.abs()).float().mean()),
            "prefill_vs_forward_max": float((pre - prev).abs().max()),
            "argmax_equal": int(dec.argmax()) == int(fwd.argmax()),
            "logit_abs_max": float(fwd.abs().max())}


def gap_cases(device, reduced, lengths):
    cfg = get_arch("qwen3-0.6b")
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (1, max(lengths) + 1), generator=gen,
                           device=device)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = f32.init(0, device=device)
    ref = {}
    for S in lengths:
        full, _ = f32.forward(p32, tokens[:, :S + 1])
        ref[S] = full[0, -1].float()
        line = case_line("float32", None, S, ref[S], full[0, -2].float(),
                         *prefill_decode(f32, p32, tokens, S))
        print(json.dumps(line), flush=True)
    del p32, full
    bf16 = build_model(cfg)
    params = bf16.init(0, device=device)
    for S in lengths:
        full, _ = bf16.forward(params, tokens[:, :S + 1])
        fwd, prev = full[0, -1].float(), full[0, -2].float()
        del full
        for rows in (None, 8, S + 1):
            if rows is None:
                dec, pre = prefill_decode(bf16, params, tokens, S)
            else:
                with MatmulRows(rows):
                    dec, pre = prefill_decode(bf16, params, tokens, S)
            line = case_line("bfloat16", rows, S, fwd, prev, dec, pre)
            line["forward_vs_f32_forward_max"] = float((fwd - ref[S]).abs().max())
            line["decode_vs_f32_forward_max"] = float((dec - ref[S]).abs().max())
            print(json.dumps(line), flush=True)


RWKV_STEPS = 32        # decode steps held to forward's logits, as chip_smoke.py 2j


def rwkv_rows(model, params, tokens, S):
    """Prefill's last logits on a prompt of S - RWKV_STEPS tokens, then those
    of RWKV_STEPS decode steps fed the true tokens: (RWKV_STEPS + 1, V)."""
    last, cache = model.prefill(params, tokens[:, :S - RWKV_STEPS])
    rows = [last[0, 0].float()]
    for i in range(S - RWKV_STEPS, S):
        step, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
        rows.append(step[0, 0].float())
    return torch.stack(rows)


def forward_rows(model, params, tokens, S, scan=False):
    """Forward's logits of S tokens at the last RWKV_STEPS + 1 positions;
    with ``scan`` every layer's WKV through the sequential route
    (``wkv_scan``: its kernel on the card)."""
    from repro_torch.kernels import wkv as wkv_kernels
    from repro_torch.models import rwkv as rwkv_lib

    if scan:
        rwkv_lib.wkv = wkv_kernels.wkv_scan
    try:
        full, _ = model.forward(params, tokens[:, :S])
    finally:
        rwkv_lib.wkv = wkv_kernels.wkv
    return full[0, S - RWKV_STEPS - 1:].float()


def rwkv_line(dtype, variant, S, fwd, dec):
    err = (dec - fwd).abs()
    return {"dtype": dtype, "variant": variant, "prompt": S,
            "decode_vs_forward_max": float(err.max()), "decode_vs_forward_mean": float(err.mean()),
            "prefill_vs_forward_max": float(err[0].max()),
            "share_over_2e-2": float((err > 2e-2 + 2e-2 * fwd.abs()).float().mean()),
            "argmax_equal": int((dec.argmax(-1) == fwd.argmax(-1)).sum()),
            "logit_abs_max": float(fwd.abs().max())}


def rwkv_gap_cases(device, reduced, lengths):
    cfg = get_arch("rwkv6-7b")
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (1, max(lengths)), generator=gen, device=device)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = f32.init(0, device=device)
    ref = {}
    for S in lengths:
        ref[S] = forward_rows(f32, p32, tokens, S)
        print(json.dumps(rwkv_line("float32", "as is", S, ref[S], rwkv_rows(f32, p32, tokens, S))),
              flush=True)
    del p32
    bf16 = build_model(cfg)
    params = bf16.init(0, device=device)
    for S in lengths:
        fwd = forward_rows(bf16, params, tokens, S)
        dec = rwkv_rows(bf16, params, tokens, S)
        with MatmulRows(S):
            padded = rwkv_rows(bf16, params, tokens, S)
        variants = [("as is", fwd, dec), (f"matmuls at {S} rows", fwd, padded)]
        if S <= 1024:
            variants.append(("forward through the scan",
                             forward_rows(bf16, params, tokens, S, scan=True), dec))
        for variant, want, dec in variants:
            line = rwkv_line("bfloat16", variant, S, want, dec)
            line["forward_vs_f32_forward_max"] = float((want - ref[S]).abs().max())
            line["forward_vs_f32_forward_mean"] = float((want - ref[S]).abs().mean())
            line["decode_vs_f32_forward_max"] = float((dec - ref[S]).abs().max())
            line["decode_vs_f32_forward_mean"] = float((dec - ref[S]).abs().mean())
            print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=("qwen3-0.6b", "rwkv6-7b"))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced model (2 layers, d 256) in bf16: a dry run")
    args = ap.parse_args()
    if args.arch == "rwkv6-7b":
        lengths = (64, 96) if args.reduced else (64, 1024, 8192)
        rwkv_gap_cases(resolve_device(args.device), args.reduced, lengths)
    else:
        lengths = (16, 32) if args.reduced else (64, 1024, 8192)
        gap_cases(resolve_device(args.device), args.reduced, lengths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
