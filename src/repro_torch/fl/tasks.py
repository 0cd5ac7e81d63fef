"""The paper's CNN task (Section V.A) in PyTorch.

CNN: 2x (5x5 conv -> 2x2 maxpool) -> FC(512) ReLU -> softmax(10)
(McMahan et al. 2017 MNIST CNN, lr 0.002, cross-entropy). The LSTM task
comes in a later slice.

Parameters keep the reference's layout — HWIO convolution weights,
(in, out) dense weights, NHWC input — at every public function, so a flat
bank row is exactly the reference's ``flatten_params`` and
``params_from_jax`` is a copy. Only ``logits`` permutes, to PyTorch's
NCHW/OIHW, and back before the flatten that feeds ``fc``.

The task exposes the interface the DAG-FL core consumes:
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
        """One SGD step, p - lr * g; returns fresh tensors (no leaf aliases ``params``)."""
        with torch.enable_grad():
            leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
            loss = self.loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {
            name: (p - self.learning_rate * g).detach()
            for (name, p), g in zip(leaves.items(), grads)
        }
        return new, {"loss": loss.detach()}


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


def params_from_jax(params: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's CNN parameters as the port's: the layouts agree, so a copy."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(leaf), dtype=torch.float32, device=dev)
            for name, leaf in params.items()}
