#!/usr/bin/env python3
"""Which embedding backward gives the same floats from call to call.

    python3 scripts/torch_lstm_determinism.py [--device cpu] [--calls 4]

Computes the gradient of the paper's LSTM loss (``LSTMTask()``, a
minibatch of 100 lines of 80 tokens) several times on the same inputs and
prints, per parameter, whether every call gave the same bits, for three
ways to embed the tokens: the port's one-hot matmul, ``F.embedding`` and
indexing (``embed[tokens]``); on a card, also the card's name and power
limit. ``--device cpu`` is the dry run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl.tasks import LSTMTask  # noqa: E402


class _Embedded(LSTMTask):
    """``LSTMTask`` with another embedding; everything else the port's."""

    def __init__(self, embed):
        super().__init__()
        object.__setattr__(self, "_embed", embed)

    def logits(self, params, tokens):
        xs = self._embed(tokens.long(), params["embed"]).transpose(0, 1)
        for l in range(self.num_layers):
            xs = self._lstm_layer(params[f"lstm{l}.w"], params[f"lstm{l}.b"], xs)
        return xs.transpose(0, 1) @ params["out"] + params["bout"]


EMBEDDINGS = {
    "one_hot_matmul": None,                        # the port's LSTMTask as it is
    "F.embedding": lambda tokens, w: F.embedding(tokens, w),
    "index": lambda tokens, w: w[tokens],
}


def gradients(task, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(task.loss(leaves, batch), list(leaves.values()))
    return dict(zip(leaves, grads))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    params = LSTMTask().init(0, dev)
    tokens = np.random.default_rng(0).integers(0, 90, (100, 80)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    for name, embed in EMBEDDINGS.items():
        task = LSTMTask() if embed is None else _Embedded(embed)
        calls = [gradients(task, params, batch) for _ in range(args.calls)]
        same = {k: all(torch.equal(calls[0][k], c[k]) for c in calls[1:]) for k in params}
        print(json.dumps({"embedding": name, "device": str(dev), "calls": args.calls,
                          "repeats_bitwise": all(same.values()), "per_leaf": same}))
    if dev.type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(out.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
