"""Optimizers and learning-rate schedules of the port (``repro.optim``)."""
from repro_torch.optim.optimizers import (
    OptState,
    adam_init,
    clip_by_global_norm,
    global_norm,
    init_optimizer,
    make_optimizer,
    momentum_init,
    sgd_init,
    value_and_grad,
)
from repro_torch.optim.schedules import constant_lr, cosine_lr, warmup_cosine

__all__ = [
    "OptState",
    "adam_init",
    "clip_by_global_norm",
    "global_norm",
    "init_optimizer",
    "make_optimizer",
    "momentum_init",
    "sgd_init",
    "value_and_grad",
    "constant_lr",
    "cosine_lr",
    "warmup_cosine",
]
