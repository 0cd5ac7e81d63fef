"""Shared building blocks of the port's models: initializers, norms, MLPs,
RoPE and the loss.

The port of ``repro.models.layers``. Parameters are nested dicts of tensors;
a transformer's layers are stacked ``(L, ...)`` tensors, so every
initializer takes a ``layers`` count (0: no leading axis). Random init draws
a truncated normal from an explicit ``torch.Generator``: the same shapes and
distribution as the reference, not its threefry bits (tests hand both sides
the same parameters through ``models.transformer.params_from_jax``).

Norms, QK-norm and RoPE compute in f32 and cast back, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _shape(layers: int, *dims: int):
    return ((layers,) if layers else ()) + dims


def truncated_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """f32 standard normal truncated to [-2, 2], by the inverse CDF (as
    ``jax.random.truncated_normal`` draws it): one uniform pass, no rejection
    loop, so no host sync on the card."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype, device, layers: int = 0):
    """(fan_in, fan_out) weight, truncated normal scaled by 1/sqrt(fan_in)."""
    w = truncated_normal(gen, _shape(layers, fan_in, fan_out), device)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return truncated_normal(gen, (vocab, d), device).mul_(0.02).to(dtype)


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` with a gradient that repeats bit for bit: autograd's
    own (``index_put_`` with accumulation) sums repeated tokens in an order
    that changes from call to call on the CPU, and ``index_add_``, serial on
    the CPU, uses float atomics on the card. So the CPU sums by
    ``index_add_`` and the card by the sort-based ``index_put_``."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        if grad.device.type == "cpu":
            out.index_add_(0, tokens.reshape(-1), grad.reshape(-1, ctx.shape[-1]))
        else:
            out.index_put_((tokens,), grad, accumulate=True)
        return out, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table``; differentiable, the same gradient on
    every call (``_EmbedLookup``), where autograd records."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, tokens)
    return table[tokens]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(kind: str, d: int, dtype, device, layers: int = 0) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(_shape(layers, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(_shape(layers, d), dtype=dtype, device=device),
                "bias": torch.zeros(_shape(layers, d), dtype=dtype, device=device)}
    if kind == "nonparam_layernorm":
        return {}
    raise ValueError(kind)


def norm_apply(kind: str, params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    # nonparam_layernorm (OLMo): no affine params
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """QK-norm (Qwen3): RMS-normalise the last (head) dim."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype, device, layers: int = 0,
             d_ff: Optional[int] = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, cfg.d_model, d_ff, dtype, device, layers),
         "wo": dense_init(gen, d_ff, cfg.d_model, dtype, device, layers)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, cfg.d_model, d_ff, dtype, device, layers)
    return p


def mlp_apply(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"]
    if cfg.act == "swiglu":
        h = F.silu(x @ params["wg"]) * h
    elif cfg.act == "geglu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.full_like(exponent, theta), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    ang = positions[..., :, None].float() * freqs                # (..., S, hd/2)
    sin = torch.sin(ang)[..., :, None, :]                        # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def xla_mean(x: torch.Tensor, dims=None) -> torch.Tensor:
    """``jnp.mean`` as XLA takes it: the f32 sum times the f32 reciprocal of
    the count (``torch.mean`` divides, which differs in the last bit where
    the count is not a power of two)."""
    dims = tuple(range(x.dim())) if dims is None else tuple(dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return x.sum(dim=dims) * float(np.float32(1.0) / np.float32(count))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean cross entropy. logits (..., V), labels int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
