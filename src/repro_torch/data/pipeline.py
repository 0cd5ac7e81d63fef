"""Batching utilities + a synthetic token stream (host numpy).

The port's copy of ``repro.data.pipeline``: the same seeds give the same
draws, in the same order.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MinibatchSampler:
    """Uniform with-replacement minibatches from a node-local dataset."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0):
        self.x, self.y, self.batch = x, y, batch
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self.y), self.batch)
        return {"x": self.x[idx], "y": self.y[idx]}


class TokenSampler:
    """Synthetic token stream for LLM local training (dry-run scale tests)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        # Zipf-ish marginal so the loss has structure to learn
        z = self.rng.zipf(1.3, size=(self.batch, self.seq))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks, "labels": toks}


def lines_to_batches(lines: np.ndarray, batch: int, seed: int = 0) -> Iterator[Dict]:
    """Endless with-replacement minibatches of ``lines`` as {"tokens"}."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(lines), batch)
        yield {"tokens": lines[idx]}
