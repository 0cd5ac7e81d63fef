"""Minimal optimizers over nested dicts of tensors (no external deps).

The port of ``repro.optim.optimizers``. ``make_optimizer(train_cfg)``
returns ``(init_fn, update_fn)`` with ``update_fn(grads, state, params, lr)
-> (new_params, new_state)``. The paper's nodes run plain SGD (lr 0.002 CNN
/ 0.3 LSTM); momentum and Adam exist for the larger architectures' local
training. Updates compute in f32 and cast back to each parameter's dtype,
as the reference does; moments are f32. Leaves are visited in sorted-key
order, the reference's tree order, so the global norm sums them as it does.
Divisions by a norm or a bias correction divide by a tensor (a division by
a Python scalar on the card is a reciprocal multiply).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # first moment / momentum (a tree like params, or None)
    nu: Any                  # second moment (or None)


def tree_map(fn, tree, *rest):
    """``fn`` on the leaves of nested dicts, sharing structure with ``rest``,
    visited (and returned) in sorted-key order, as ``tree_leaves`` lists them."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order (``jax.tree_util``'s)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def value_and_grad(fn, params, *args, has_aux: bool = False):
    """``(fn(params, *args), grads)`` by autograd, ``grads`` a tree like
    ``params`` (whose tensors are not modified): ``jax.value_and_grad``.
    With ``has_aux`` fn returns ``(scalar, aux)`` and only the scalar is
    differentiated. The graph is freed before it returns."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = fn(leaves, *args)
        grads = iter(torch.autograd.grad(out[0] if has_aux else out, tree_leaves(leaves)))
    return out, tree_map(lambda _: next(grads), leaves)


def _device_of(tree):
    return tree_leaves(tree)[0].device


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device_of(params))


def sgd_init(params) -> OptState:
    return OptState(_step0(params), None, None)


def momentum_init(params) -> OptState:
    return OptState(_step0(params), _zeros_like_f32(params), None)


def adam_init(params) -> OptState:
    return OptState(_step0(params), _zeros_like_f32(params), _zeros_like_f32(params))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9), max=1.0)
    # f32 like the reference's bf16 * f32 (a 0-d tensor would not promote bf16)
    return tree_map(lambda g: g.float() * scale, grads), norm


def make_optimizer(cfg: TrainConfig) -> Tuple[Callable, Callable]:
    wd = cfg.weight_decay

    def apply_wd(p, g):
        if wd:
            return g + wd * p.float()
        return g

    if cfg.optimizer == "sgd":
        def update(grads, state, params, lr):
            if cfg.grad_clip:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            new_params = tree_map(
                lambda p, g: (p.float() - lr * apply_wd(p, g.float())).to(p.dtype),
                params, grads)
            return new_params, OptState(state.step + 1, None, None)

        return sgd_init, update

    if cfg.optimizer == "momentum":
        def update(grads, state, params, lr):
            if cfg.grad_clip:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            mu = tree_map(lambda m, g: cfg.momentum * m + g.float(), state.mu, grads)
            new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, mu)
            return new_params, OptState(state.step + 1, mu, None)

        return momentum_init, update

    if cfg.optimizer == "adam":
        b1, b2, eps = 0.9, 0.95, 1e-8

        def update(grads, state, params, lr):
            if cfg.grad_clip:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            step = state.step + 1
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
            nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g.float()),
                          state.nu, grads)
            t = step.float()
            bc1 = 1 - torch.full_like(t, b1) ** t
            bc2 = 1 - torch.full_like(t, b2) ** t

            def upd(p, m, n):
                d = (m / bc1) / (torch.sqrt(n / bc2) + eps)
                return (p.float() - lr * (d + wd * p.float())).to(p.dtype)

            new_params = tree_map(upd, params, mu, nu)
            return new_params, OptState(step, mu, nu)

        return adam_init, update

    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def init_optimizer(cfg: TrainConfig, params) -> OptState:
    init, _ = make_optimizer(cfg)
    return init(params)
