"""DAG-FL training entry point — the end-to-end training path on one card.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 --nodes 4
    python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu

The port of ``repro.launch.train``: runs ``make_dagfl_train_step``
(selection -> Eq.-1 aggregation -> local training -> cross-validation
scoring -> frontier publish) once a step, every node's model a row of the
node-stacked parameters on one device. Token and validation batches come
from ``data.pipeline.TokenSampler``, the reference's numpy stream; node i's
parameters from the port's seeded ``Model.init(seed + i)``; step t's
selection draw from a generator seeded with ``seed * 7 + t``. Trains the
dense family; other archs raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import DagFLConfig, ModelConfig, TrainConfig
from repro_torch.data.pipeline import TokenSampler
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import train_unported_reason
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding import fl_step as fl_lib


class TrainRun(NamedTuple):
    stacked: dict                  # node-stacked parameters after the last step
    frontier: fl_lib.Frontier
    history: list                  # a dict a step: "s" (wall, synchronised), the metrics


def small_100m() -> ModelConfig:
    """~100M-param dense config for the end-to-end example run."""
    return dataclasses.replace(
        get_arch("qwen3-0.6b"),
        name="qwen3-100m",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab_size=32768,
        dtype="float32",
    )


class Trainer(NamedTuple):
    model: object
    dcfg: DagFLConfig              # alpha, k, tau_max of the selection
    step: Callable                 # make_dagfl_train_step's step
    samplers: list                 # node i's TokenSampler (seed + i)
    val_batch: dict                # {"tokens": (N, 1, min(seq_len, 512))}


def make_trainer(cfg: ModelConfig, nodes: int, batch_per_node: int, seq_len: int, lr: float,
                 seed: int, device) -> Trainer:
    """What ``run`` trains with: the model; the DAG-FL step (fl_step's SGD at
    ``lr``, alpha min(4, N), k 2, no staleness cut); a token sampler a node;
    the validation batch, one sequence a node from its own sampler."""
    model = build_model(cfg)
    tcfg = TrainConfig(optimizer="sgd", learning_rate=lr)
    dcfg = DagFLConfig(num_nodes=nodes, alpha=min(4, nodes), k=2, tau_max=1e9)
    step = fl_lib.make_dagfl_train_step(model, cfg, tcfg, dcfg, nodes)
    samplers = [TokenSampler(cfg.vocab_size, batch_per_node, seq_len, seed=seed + i)
                for i in range(nodes)]
    val = TokenSampler(cfg.vocab_size, 1, min(seq_len, 512), seed=seed + 999)
    val_tokens = np.stack([val.next()["tokens"][0] for _ in range(nodes)])
    val_batch = {"tokens": torch.from_numpy(val_tokens[:, None, :]).to(resolve_device(device))}
    return Trainer(model, dcfg, step, samplers, val_batch)


def next_batch(samplers: list, device) -> dict:
    """The next training batch, ``(N, batch_per_node, seq_len)`` tokens, as
    both the tokens and the labels (``Model.loss`` shifts them)."""
    toks = torch.from_numpy(np.stack([s.next()["tokens"] for s in samplers]))
    toks = toks.to(resolve_device(device))
    return {"tokens": toks, "labels": toks}


def init_stacked(model, nodes: int, seed: int, device) -> dict:
    """Node-stacked parameters, node i's from ``model.init(seed + i)``, one
    node's init alive at a time beside the stack."""
    first = model.init(seed, device=device)
    stacked = tree_map(lambda p: torch.empty((nodes,) + p.shape, dtype=p.dtype,
                                             device=p.device), first)
    for i in range(nodes):
        params = first if i == 0 else model.init(seed + i, device=device)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, params)
        del params
    return stacked


def run(
    cfg: ModelConfig,
    steps: int = 50,
    nodes: int = 4,
    batch_per_node: int = 4,
    seq_len: int = 128,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 10,
    checkpoint: str = "",
    device="cuda",
    params: Optional[dict] = None,
    draws: Optional[Callable[[int], torch.Tensor]] = None,
) -> TrainRun:
    """Train ``nodes`` DAG-FL nodes for ``steps`` steps on ``device``.

    ``params``: node-stacked initial parameters (default the seeded init);
    ``draws``: step -> the selection's (N, N) uniform draw (default a
    generator seeded with ``seed * 7 + step``). Both let a caller replay
    another run's weights and draws (the tests feed the reference's).
    """
    reason = train_unported_reason(cfg)
    if reason:
        raise NotImplementedError(f"training {cfg.name}: {reason}")
    dev = resolve_device(device)
    trainer = make_trainer(cfg, nodes, batch_per_node, seq_len, lr, seed, dev)
    stacked = params if params is not None else init_stacked(trainer.model, nodes, seed, dev)
    n_params = sum(p.numel() for p in tree_leaves(stacked)) // nodes
    print(f"arch={cfg.name} params/node={n_params/1e6:.1f}M nodes={nodes} "
          f"batch/node={batch_per_node} seq={seq_len} device={dev}")

    frontier = fl_lib.init_frontier(nodes, device=dev)
    history = []
    t0 = time.time()
    for step in range(steps):
        t = time.perf_counter()
        batch = next_batch(trainer.samplers, dev)
        draw = draws(step) if draws is not None else seed * 7 + step
        stacked, frontier, metrics = trainer.step(stacked, frontier, batch, trainer.val_batch,
                                                  draw)
        metrics = {name: float(value) for name, value in metrics.items()}   # synchronises
        history.append(dict(metrics, s=time.perf_counter() - t))
        if (step + 1) % log_every == 0 or step == 0:
            dt = (time.time() - t0) / (step + 1)
            print(f"step {step+1:4d}  mean_val_acc={metrics['mean_val_acc']:.4f}  "
                  f"sel_entropy={metrics['selection_entropy']:.3f}  {dt:.2f}s/step")
    if checkpoint:
        save_pytree(checkpoint, {"params": stacked, "frontier": frontier},
                    meta={"arch": cfg.name, "steps": steps})
        print(f"checkpoint -> {checkpoint}.npz")
    return TrainRun(stacked, frontier, history)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs() + ["100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.arch == "100m":
        cfg = small_100m()
    else:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    run(cfg, args.steps, args.nodes, args.batch_per_node, args.seq_len,
        args.lr, checkpoint=args.checkpoint, device=args.device)


if __name__ == "__main__":
    main()
