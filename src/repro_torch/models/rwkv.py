"""RWKV-6 "Finch" blocks (arXiv:2404.05892) on PyTorch: attention-free time
mix with data-dependent per-channel decay, and a squared-ReLU channel mix.

The port of ``repro.models.rwkv``. Per head the WKV recurrence carries an
(hd_k, hd_v) f32 state ``S``:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,

``w_t = exp(-exp(w0 + lora(x_t)))``. ``time_mix`` dispatches as the
reference does: a sequence of ``T > 1`` steps with ``T`` a multiple of 32
goes through ``kernels.wkv.wkv`` (the chunked route of the hand-written CUDA
kernel on the card, ``wkv_chunked_plain`` on the CPU); any other length,
decode's single step included, through ``kernels.wkv.wkv_scan`` (its
sequential route on the card, ``wkv_scan_plain`` on the CPU). Decode hands
the cache's own WKV state as ``wkv_out``, so the scan updates it in place.

Parameters are nested dicts of tensors; ``rwkv_block_init`` draws a stack of
``layers`` blocks at once (``(L, ...)`` tensors) from an explicit
generator. Decode carries ``RWKVState(tm_shift, cm_shift, wkv)`` per layer.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv import CHUNK as WKV_CHUNK
from repro_torch.kernels.wkv import wkv, wkv_scan
from repro_torch.models.layers import _shape, dense_init, norm_apply, norm_init

DECAY_LORA = 64


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # (B, d)   last input to time-mix
    cm_shift: torch.Tensor   # (B, d)   last input to channel-mix
    wkv: torch.Tensor        # (B, H, hd, hd) recurrent state (f32)


def rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def _uniform(gen: torch.Generator, shape, scale: float, offset: float, dtype, device):
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(generator=gen)
    return u.mul_(scale).add_(offset).to(dtype)


def rwkv_block_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                    layers: int = 0) -> dict:
    """One block's parameters, or ``layers`` stacked blocks: the reference's
    shapes and distributions (``repro.models.rwkv.rwkv_block_init``)."""
    d = cfg.d_model
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    L = layers
    return {
        "ln_tm": norm_init("layernorm", d, dtype, device, L),
        "ln_cm": norm_init("layernorm", d, dtype, device, L),
        # static token-shift lerp coefficients for r, k, v, g and the decay input
        "mu": _uniform(gen, _shape(L, 5, d), 0.5, 0.25, dtype, device),
        "w_r": dense_init(gen, d, d, dtype, device, L),
        "w_k": dense_init(gen, d, d, dtype, device, L),
        "w_v": dense_init(gen, d, d, dtype, device, L),
        "w_g": dense_init(gen, d, d, dtype, device, L),
        "w_o": dense_init(gen, d, d, dtype, device, L),
        # data-dependent decay: w0 + tanh(x @ A) @ B, per channel
        "decay_w0": torch.full(_shape(L, d), -1.0, dtype=dtype, device=device),
        "decay_A": dense_init(gen, d, DECAY_LORA, dtype, device, L),
        "decay_B": dense_init(gen, DECAY_LORA, d, dtype, device, L) * 0.1,
        "bonus_u": _uniform(gen, _shape(L, H, hd), 0.5, 0.0, dtype, device),
        "gn_scale": torch.ones(_shape(L, H, hd), dtype=dtype, device=device),
        "gn_bias": torch.zeros(_shape(L, H, hd), dtype=dtype, device=device),
        # channel mix
        "cm_mu": _uniform(gen, _shape(L, 2, d), 0.5, 0.25, dtype, device),
        "cm_k": dense_init(gen, d, cfg.d_ff, dtype, device, L),
        "cm_v": dense_init(gen, cfg.d_ff, d, dtype, device, L),
        "cm_r": dense_init(gen, d, d, dtype, device, L),
    }


def _shift(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """(B, T, d) -> the previous token (B, T, d); position 0 gets ``first``."""
    return torch.cat([first[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, shift_in: torch.Tensor, wkv_state,
             wkv_out=None):
    """x: (B, T, d). Returns (out, new shift (B, d), new wkv state). With
    ``wkv_out`` (which may be ``wkv_state`` itself) the new state is written
    there and returned."""
    B, T, d = x.shape
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    xx = _shift(x, shift_in)
    mu = p["mu"]
    xr = x + (xx - x) * mu[0]
    xk = x + (xx - x) * mu[1]
    xv = x + (xx - x) * mu[2]
    xg = x + (xx - x) * mu[3]
    xw = x + (xx - x) * mu[4]

    r = (xr @ p["w_r"]).reshape(B, T, H, hd)
    k = (xk @ p["w_k"]).reshape(B, T, H, hd)
    v = (xv @ p["w_v"]).reshape(B, T, H, hd)
    g = F.silu(xg @ p["w_g"])

    # data-dependent decay in (0, 1): w = exp(-exp(dd)), kept in log space
    # (logw = -exp(dd) <= 0), clamped in f32
    dd = p["decay_w0"] + torch.tanh(xw @ p["decay_A"]) @ p["decay_B"]
    logw = -torch.exp(torch.clamp(dd.float(), max=10.0)).reshape(B, T, H, hd)

    if T > 1 and T % WKV_CHUNK == 0:
        y, new_state = wkv(r, k, v, logw, p["bonus_u"], wkv_state)
        if wkv_out is not None:
            new_state = wkv_out.copy_(new_state)
    else:
        y, new_state = wkv_scan(r, k, v, logw, p["bonus_u"], wkv_state, out=wkv_out)

    # per-head group norm (population variance, as jnp.var)
    yf = y.float()
    mean = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, unbiased=False)
    y = (yf - mean) * torch.rsqrt(var + 1e-5)
    y = y * p["gn_scale"].float() + p["gn_bias"].float()
    y = y.reshape(B, T, d).to(x.dtype) * g
    return y @ p["w_o"], x[:, -1, :], new_state


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, shift_in: torch.Tensor):
    xx = _shift(x, shift_in)
    xk = x + (xx - x) * p["cm_mu"][0]
    xr = x + (xx - x) * p["cm_mu"][1]
    k = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), x[:, -1, :]


def rwkv_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, state: RWKVState,
                     wkv_out=None) -> Tuple[torch.Tensor, RWKVState]:
    """One block. ``wkv_out``: where the new WKV state goes (``time_mix``)."""
    h = norm_apply("layernorm", p["ln_tm"], x)
    tm_out, tm_shift, wkv_state = time_mix(cfg, p, h, state.tm_shift, state.wkv, wkv_out)
    x = x + tm_out
    h = norm_apply("layernorm", p["ln_cm"], x)
    cm_out, cm_shift = channel_mix(cfg, p, h, state.cm_shift)
    return x + cm_out, RWKVState(tm_shift, cm_shift, wkv_state)


def rwkv_empty_state(cfg: ModelConfig, batch: int, dtype, device, layers: int = 0) -> RWKVState:
    """Zero state for ``batch`` sequences, or ``layers`` stacked ``(L, B, ...)``."""
    H, hd = rwkv_heads(cfg), cfg.rwkv_head_dim
    return RWKVState(
        tm_shift=torch.zeros(_shape(layers, batch, cfg.d_model), dtype=dtype, device=device),
        cm_shift=torch.zeros(_shape(layers, batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros(_shape(layers, batch, H, hd, hd), dtype=torch.float32, device=device),
    )
