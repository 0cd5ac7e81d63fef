#!/usr/bin/env python3
"""How far the served model's decode step lies from its full forward, by
precision, and how much of that is the matmuls' shape.

    python3 scripts/torch_decode_gap.py                    # one CUDA card, full width
    python3 scripts/torch_decode_gap.py --device cpu --reduced

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced qwen3-0.6b (2 layers, d 256) in bf16: a dry run")
    args = ap.parse_args()
    lengths = (16, 32) if args.reduced else (64, 1024, 8192)
    gap_cases(resolve_device(args.device), args.reduced, lengths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
