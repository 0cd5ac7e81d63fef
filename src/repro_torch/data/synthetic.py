"""Offline synthetic datasets with the paper's shapes and non-IID structure.

The port's numpy copy of ``repro.data.synthetic``: the same seeds give the
same arrays.

* ``mnist_like``  — stands in for MNIST: 10-class 28x28x1 images made of
  smooth class prototypes + per-sample noise + random shifts.
* ``char_corpus`` — stands in for Shakespeare: a character stream from
  per-role Markov chains over a 90-char alphabet; 80-char lines, highly
  unbalanced roles (the paper's non-IID source for the LSTM task).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

NUM_CLASSES = 10
VOCAB = 90  # printable chars


def _prototypes(rng: np.random.Generator, image_size: int) -> np.ndarray:
    """Smooth per-class patterns: sum of a few random 2-D cosines."""
    protos = np.zeros((NUM_CLASSES, image_size, image_size), np.float32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    for c in range(NUM_CLASSES):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            protos[c] += np.cos(2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
        protos[c] /= np.max(np.abs(protos[c]))
    return protos


@dataclass
class ImageDataset:
    x: np.ndarray   # (N, H, W, 1) float32 in [0, 1]
    y: np.ndarray   # (N,) int32

    def __len__(self):
        return len(self.y)


class MnistLike:
    """Deterministic generator; samples are reproducible given (seed, split)."""

    def __init__(self, image_size: int = 28, seed: int = 0, noise: float = 0.3):
        self.image_size = image_size
        self.noise = noise
        self.protos = _prototypes(np.random.default_rng(seed), image_size)

    def sample(self, rng: np.random.Generator, labels: np.ndarray) -> ImageDataset:
        n = len(labels)
        base = self.protos[labels]                          # (n, s, s)
        shift = rng.integers(-2, 3, size=(n, 2))
        imgs = np.empty_like(base)
        for i in range(n):                                  # small n per shard
            imgs[i] = np.roll(base[i], tuple(shift[i]), axis=(0, 1))
        imgs = imgs + rng.normal(0, self.noise, imgs.shape).astype(np.float32)
        imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min() + 1e-9)
        return ImageDataset(imgs[..., None].astype(np.float32), labels.astype(np.int32))

    def balanced(self, rng: np.random.Generator, n: int) -> ImageDataset:
        labels = rng.integers(0, NUM_CLASSES, n)
        return self.sample(rng, labels)


def add_backdoor_trigger(x: np.ndarray, square: int = 5) -> np.ndarray:
    """Paper §V.A: white square in the upper-left corner."""
    out = x.copy()
    out[:, :square, :square, :] = 1.0
    return out


def paper_partition(
    gen: MnistLike,
    num_nodes: int = 100,
    shard_size: int = 200,
    uniform_per_node: int = 200,
    seed: int = 1,
) -> List[ImageDataset]:
    """2/3 of the train set sorted by label -> 200 shards of ``shard_size``,
    2 shards per node; the remaining 1/3 spread uniformly (Section V.A.1).

    Each node ends up with most samples of two digits + a uniform sprinkle.
    """
    rng = np.random.default_rng(seed)
    shards_per_node = 2
    total_shards = num_nodes * shards_per_node
    # sorted-by-label shard labels: shard i is entirely digit (i * 10 // total)
    reps = -(-total_shards // NUM_CLASSES)  # ceil
    shard_digit = np.repeat(np.arange(NUM_CLASSES), reps)[:total_shards]
    rng.shuffle(shard_digit)

    nodes = []
    for i in range(num_nodes):
        labels = []
        for s in range(shards_per_node):
            digit = shard_digit[i * shards_per_node + s]
            labels.append(np.full(shard_size, digit, np.int64))
        labels.append(rng.integers(0, NUM_CLASSES, uniform_per_node))
        labels = np.concatenate(labels)
        nodes.append(gen.sample(rng, labels))
    return nodes


class CharCorpus:
    """Role-conditioned Markov text: each role has its own transition matrix
    biased toward a role-specific subset of the alphabet (non-IID source)."""

    def __init__(self, num_roles: int = 30, seed: int = 0, order_bias: float = 6.0):
        rng = np.random.default_rng(seed)
        base = rng.dirichlet(np.ones(VOCAB) * 0.3, size=VOCAB).astype(np.float64)
        self.mats = []
        for r in range(num_roles):
            fav = rng.choice(VOCAB, size=12, replace=False)
            m = base.copy()
            m[:, fav] *= order_bias
            m /= m.sum(axis=1, keepdims=True)
            self.mats.append(m.astype(np.float64))
        self.num_roles = num_roles

    def lines(self, rng: np.random.Generator, role: int, n_lines: int, line_len: int = 80):
        m = self.mats[role % self.num_roles]
        out = np.empty((n_lines, line_len), np.int32)
        for i in range(n_lines):
            c = rng.integers(0, VOCAB)
            for t in range(line_len):
                out[i, t] = c
                c = rng.choice(VOCAB, p=m[c])
        return out


def char_partition(
    corpus: CharCorpus, num_nodes: int, lines_per_node: int, seed: int = 2
) -> List[np.ndarray]:
    """Random role per node (paper: roles randomly assigned to 100 nodes)."""
    rng = np.random.default_rng(seed)
    roles = rng.integers(0, corpus.num_roles, num_nodes)
    return [
        corpus.lines(np.random.default_rng(seed + 100 + i), int(roles[i]), lines_per_node)
        for i in range(num_nodes)
    ]
