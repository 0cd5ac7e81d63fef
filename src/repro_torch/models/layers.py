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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean cross entropy. logits (..., V), labels int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
