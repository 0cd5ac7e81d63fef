"""The paper's two FL task models (Section V.A) in PyTorch.

* CNN: 2x (5x5 conv -> 2x2 maxpool) -> FC(512) ReLU -> softmax(10)
  (McMahan et al. 2017 MNIST CNN, lr 0.002, cross-entropy).
* LSTM: 8-dim char embedding -> 2x LSTM(256) -> softmax per char
  (the stacked character LSTM, lr 0.3 in the paper).

Parameters keep the reference's layout — HWIO convolution weights,
(in, out) dense weights, NHWC input, LSTM weights ((in + hidden), 4 hidden)
with gates i, f, g, o — at every public function, so a flat bank row is
exactly the reference's ``flatten_params``. The reference nests each LSTM
layer's ``{"w", "b"}``; the port keeps one flat dict whose keys
``lstm{l}.w`` and ``lstm{l}.b`` sort in the reference's leaf order
(``bout``, ``embed``, ``lstm0.b``, ``lstm0.w``, ``lstm1.b``, ``lstm1.w``,
``out``), so ``params_from_jax`` is a copy. Only the CNN's ``logits``
permutes, to PyTorch's NCHW/OIHW, and back before the flatten that feeds
``fc``.

Each task exposes the interface the DAG-FL core consumes:
  init(seed, device) -> params
  eval_fn(params, batch) -> accuracy in [0,1]
  train_fn(params, batch) -> (params, metrics)   # one minibatch SGD step
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import softmax_xent


@dataclass(frozen=True)
class CNNTask:
    image_size: int = 28
    channels: Tuple[int, int] = (32, 64)
    kernel: int = 5
    fc_units: int = 512
    num_classes: int = 10
    learning_rate: float = 0.002

    def init(self, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
        """He-style normal init from a CPU ``torch.Generator`` seeded with
        ``seed``, then moved to ``device``: the same seed gives the same
        parameters on every device.

        The draws differ from the reference's threefry draws on the same
        seed; ``params_from_jax`` carries the reference's parameters in.
        """
        dev = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(seed)
        c1, c2 = self.channels
        k = self.kernel
        fm = self.image_size // 4                   # two 2x2 pools
        fan3 = fm * fm * c2

        def normal(shape, fan):
            return torch.randn(shape, generator=gen) / math.sqrt(fan)

        params = {
            "conv1": normal((k, k, 1, c1), k * k * 1),
            "b1": torch.zeros((c1,)),
            "conv2": normal((k, k, c1, c2), k * k * c1),
            "b2": torch.zeros((c2,)),
            "fc": normal((fan3, self.fc_units), fan3),
            "bfc": torch.zeros((self.fc_units,)),
            "out": normal((self.fc_units, self.num_classes), self.fc_units),
            "bout": torch.zeros((self.num_classes,)),
        }
        return {name: leaf.to(dev) for name, leaf in params.items()}

    def _conv(self, h, w, b):
        # HWIO -> OIHW; "SAME" for an odd kernel at stride 1 pads k // 2 each side
        h = F.conv2d(h, w.permute(3, 2, 0, 1), padding=self.kernel // 2)
        h = torch.relu(h + b[:, None, None])
        return F.max_pool2d(h, 2, 2)

    def logits(self, params, x):
        """x (B, H, W, 1) NHWC -> (B, num_classes)."""
        h = x.permute(0, 3, 1, 2)
        h = self._conv(h, params["conv1"], params["b1"])
        h = self._conv(h, params["conv2"], params["b2"])
        # flatten in (H, W, C) order, as the reference's NHWC reshape does
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(h @ params["fc"] + params["bfc"])
        return h @ params["out"] + params["bout"]

    def loss(self, params, batch):
        return softmax_xent(self.logits(params, batch["x"]), batch["y"])

    def eval_fn(self, params, batch) -> torch.Tensor:
        with torch.no_grad():
            logits = self.logits(params, batch["x"])
            return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())

    def train_fn(self, params, batch):
        return _sgd_step(self, params, batch)

    def attack_success_rate(self, params, batch, target_shift: int = 1) -> torch.Tensor:
        """Backdoor metric (Table III): triggered images classified as y+1."""
        with torch.no_grad():
            logits = self.logits(params, batch["x"])
            target = (batch["y"] + target_shift) % self.num_classes
            return torch.mean((torch.argmax(logits, -1) == target).float())


def _sgd_step(task, params, batch):
    """One SGD step, p - lr * g; returns fresh tensors (no leaf aliases ``params``)."""
    with torch.enable_grad():
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        loss = task.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {
        name: (p - task.learning_rate * g).detach()
        for (name, p), g in zip(leaves.items(), grads)
    }
    return new, {"loss": loss.detach()}


@dataclass(frozen=True)
class LSTMTask:
    vocab: int = 90
    embed_dim: int = 8
    hidden: int = 256
    num_layers: int = 2
    learning_rate: float = 0.3

    def init(self, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
        """Normal init from a CPU ``torch.Generator`` seeded with ``seed``,
        then moved to ``device`` (``CNNTask.init``'s convention)."""
        dev = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(seed)
        params = {
            "embed": torch.randn((self.vocab, self.embed_dim), generator=gen) * 0.1,
            "out": torch.randn((self.hidden, self.vocab), generator=gen) / math.sqrt(self.hidden),
            "bout": torch.zeros((self.vocab,)),
        }
        inp = self.embed_dim
        for l in range(self.num_layers):
            fan = inp + self.hidden
            params[f"lstm{l}.w"] = (torch.randn((fan, 4 * self.hidden), generator=gen)
                                    / math.sqrt(fan))
            params[f"lstm{l}.b"] = torch.zeros((4 * self.hidden,))
            inp = self.hidden
        return {name: leaf.to(dev) for name, leaf in params.items()}

    def _lstm_layer(self, w, b, xs):
        """xs: (T, B, in) -> (T, B, hidden); the reference's scan as a step loop."""
        h = xs.new_zeros((xs.shape[1], self.hidden))
        c = xs.new_zeros((xs.shape[1], self.hidden))
        hs = []
        for x in xs:
            z = torch.cat([x, h], dim=-1) @ w + b
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs)

    def logits(self, params, tokens):
        """tokens (B, T) -> (B, T, V)."""
        # the embedding as a one-hot matmul: its backward sums the colliding
        # rows in a fixed order, so two calls give the same floats on a card
        # and on the CPU; F.embedding's backward on a card and an index's on
        # the CPU change their last bits from call to call outside PyTorch's
        # global deterministic mode (scripts/torch_lstm_determinism.py)
        onehot = F.one_hot(tokens.long(), self.vocab).to(params["embed"].dtype)
        xs = (onehot @ params["embed"]).transpose(0, 1)                    # (T,B,E)
        for l in range(self.num_layers):
            xs = self._lstm_layer(params[f"lstm{l}.w"], params[f"lstm{l}.b"], xs)
        return xs.transpose(0, 1) @ params["out"] + params["bout"]

    def loss(self, params, batch):
        tokens = batch["tokens"]
        logits = self.logits(params, tokens)[:, :-1]
        return softmax_xent(logits, tokens[:, 1:])

    def eval_fn(self, params, batch) -> torch.Tensor:
        with torch.no_grad():
            tokens = batch["tokens"]
            pred = torch.argmax(self.logits(params, tokens)[:, :-1], -1)
            hits = (pred == tokens[:, 1:]).float()
            # XLA's mean: the (exact) f32 sum times the f32 reciprocal of the
            # count, the same on every device; torch.mean on the CPU divides
            return hits.sum() * float(np.float32(1.0) / np.float32(hits.numel()))

    def train_fn(self, params, batch):
        return _sgd_step(self, params, batch)


def make_epoch_train(task):
    """One 'iteration' trains over several minibatches (an epoch, §V.A.1).

    Returns train_fn(params, batch) where each leaf of ``batch`` has a
    leading steps axis; the single-step ``task.train_fn`` runs over it.
    """

    def train(params, batch):
        steps = next(iter(batch.values())).shape[0]
        metrics = {}
        for s in range(steps):
            params, metrics = task.train_fn(params, {k: v[s] for k, v in batch.items()})
        return params, {"loss": metrics["loss"]}

    return train


def bench_cnn_task() -> CNNTask:
    """Scaled-down CNN for CPU runs (the reference's bench scale, lr 0.05)."""
    return CNNTask(image_size=16, channels=(8, 16), fc_units=64, learning_rate=0.05)


def bench_lstm_task() -> LSTMTask:
    """Scaled-down LSTM for CPU runs (the reference's bench scale)."""
    return LSTMTask(hidden=64, num_layers=2, learning_rate=0.3)


def params_from_jax(params: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's parameters (either task) as the port's: a nested
    dict's keys joined by ".", so ``{"lstm0": {"w"}}`` becomes ``lstm0.w``;
    the layouts agree, so each leaf is a copy."""
    dev = resolve_device(device)

    def leaves(tree, prefix=""):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                yield from leaves(leaf, f"{prefix}{name}.")
            else:
                yield f"{prefix}{name}", leaf

    return {name: torch.tensor(np.asarray(leaf), dtype=torch.float32, device=dev)
            for name, leaf in leaves(params)}
