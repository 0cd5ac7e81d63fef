"""Node population for the simulator: local data + behavior (host numpy).

The port's copy of ``repro.fl.nodes``: the same seeds give the same
population arrays and the same per-node rng streams.

Behaviors (Section V.A.1):
  normal    — trains honestly.
  lazy      — skips training, republishes an existing model (reward farming).
  poisoning — local labels/tokens randomized (wrong data).
  backdoor  — CNN only: 5x5-ish white square trigger, label shifted +1;
              backdoor nodes also run the JOINT attack — they bias tip
              selection toward other backdoor nodes' transactions (§V.A.4).

Nodes are task-agnostic: local data is a dict of row-aligned arrays
({"x","y"} for CNN, {"tokens"} for the LSTM task).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.data.synthetic import (
    CharCorpus,
    MnistLike,
    NUM_CLASSES,
    VOCAB,
    add_backdoor_trigger,
    char_partition,
    paper_partition,
)

BEHAVIORS = ("normal", "lazy", "poisoning", "backdoor")


@dataclass
class SimNode:
    node_id: int
    behavior: str
    train: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    rng: np.random.Generator

    def _rows(self, d: Dict[str, np.ndarray]) -> int:
        return len(next(iter(d.values())))

    def minibatch(self, size: int) -> Dict[str, np.ndarray]:
        n = self._rows(self.train)
        idx = self.rng.integers(0, n, size)
        return {k: v[idx] for k, v in self.train.items()}

    def epoch(self, steps: int, size: int) -> Dict[str, np.ndarray]:
        """``steps`` stacked minibatches — one paper 'iteration' of training."""
        n = self._rows(self.train)
        idx = self.rng.integers(0, n, (steps, size))
        return {k: v[idx] for k, v in self.train.items()}

    def val_batch(self, size: int) -> Dict[str, np.ndarray]:
        n = self._rows(self.test)
        idx = self.rng.integers(0, n, size)          # with replacement: fixed shape
        return {k: v[idx] for k, v in self.test.items()}


def _assign_behaviors(num_nodes, abnormal, num_abnormal, rng):
    ids = set(rng.choice(num_nodes, size=num_abnormal, replace=False).tolist())
    return ["normal" if i not in ids else abnormal for i in range(num_nodes)]


def build_population(
    gen: MnistLike,
    num_nodes: int,
    abnormal: str = "normal",
    num_abnormal: int = 0,
    shard_size: int = 40,
    uniform_per_node: int = 40,
    test_frac: float = 0.25,
    backdoor_frac: float = 0.5,
    seed: int = 0,
) -> List[SimNode]:
    """CNN task: the paper's exact non-IID partition + behavior assignment."""
    data = paper_partition(gen, num_nodes, shard_size, uniform_per_node, seed=seed)
    rng = np.random.default_rng(seed + 7)
    behaviors = _assign_behaviors(num_nodes, abnormal, num_abnormal, rng)

    nodes = []
    for i in range(num_nodes):
        ds = data[i]
        n_test = max(8, int(len(ds.y) * test_frac))
        perm = rng.permutation(len(ds.y))
        te, tr = perm[:n_test], perm[n_test:]
        x_tr, y_tr = ds.x[tr].copy(), ds.y[tr].copy()
        behavior = behaviors[i]

        if behavior == "poisoning":
            y_tr = rng.integers(0, NUM_CLASSES, len(y_tr)).astype(y_tr.dtype)
        elif behavior == "backdoor":
            n_bd = int(len(y_tr) * backdoor_frac)
            pick = rng.choice(len(y_tr), n_bd, replace=False)
            sq = max(3, x_tr.shape[1] // 6)
            x_tr[pick] = add_backdoor_trigger(x_tr[pick], square=sq)
            y_tr[pick] = (y_tr[pick] + 1) % NUM_CLASSES

        nodes.append(
            SimNode(
                node_id=i,
                behavior=behavior,
                train={"x": x_tr, "y": y_tr},
                test={"x": ds.x[te], "y": ds.y[te]},
                rng=np.random.default_rng(seed * 1000 + i),
            )
        )
    return nodes


def build_char_population(
    corpus: CharCorpus,
    num_nodes: int,
    abnormal: str = "normal",
    num_abnormal: int = 0,
    lines_per_node: int = 64,
    test_frac: float = 0.25,
    seed: int = 0,
) -> List[SimNode]:
    """LSTM task: role-partitioned lines (backdoor not applicable — §V.A.1)."""
    assert abnormal != "backdoor", "paper runs backdoor nodes only on the CNN task"
    data = char_partition(corpus, num_nodes, lines_per_node, seed=seed)
    rng = np.random.default_rng(seed + 7)
    behaviors = _assign_behaviors(num_nodes, abnormal, num_abnormal, rng)

    nodes = []
    for i in range(num_nodes):
        lines = data[i]
        n_test = max(4, int(len(lines) * test_frac))
        perm = rng.permutation(len(lines))
        te, tr = perm[:n_test], perm[n_test:]
        tr_lines = lines[tr].copy()
        if behaviors[i] == "poisoning":
            tr_lines = rng.integers(0, VOCAB, tr_lines.shape).astype(tr_lines.dtype)
        nodes.append(
            SimNode(
                node_id=i,
                behavior=behaviors[i],
                train={"tokens": tr_lines},
                test={"tokens": lines[te]},
                rng=np.random.default_rng(seed * 1000 + i),
            )
        )
    return nodes


def backdoor_eval_set(gen: MnistLike, rng: np.random.Generator, n: int = 256):
    """Triggered clean images; attack succeeds if prediction = y+1 (§V.A.3)."""
    ds = gen.balanced(rng, n)
    sq = max(3, ds.x.shape[1] // 6)
    return {"x": add_backdoor_trigger(ds.x, square=sq), "y": ds.y}
