"""GQA/MQA attention with full or sliding-window masking, QK-norm, QKV bias.

The port of ``repro.models.attention``. Three entry points:
  * ``attn_forward``      — train/prefill over a whole sequence (optionally
                            returning the KV cache),
  * ``attn_decode_step``  — one new token against a cache,
  * the cache helpers     — full cache (S slots) or ring-buffer window cache.

Layouts: activations (B, S, D); q/k/v (B, S, H, hd); caches (B, S, KV, hd).
Attention itself goes through ``kernels.flash_attention``: ``flash_attention``
(the (B, S, H, hd) tensors passed permuted, read in place by the kernel) and
``decode_attention``; while autograd records (training), ``attn_forward``
takes ``flash_attention_train``, the same forward with the backward kernel
behind it. ``sdpa`` and ``chunked_sdpa`` keep the reference's plain
functions in this layout, for tests and for callers without a card.

The cache is written in place (the reference returns a new one): a decode
step writes slot ``pos % slots`` (sliding window) or ``min(pos, slots - 1)``
(full attention) of ``cache.k``/``cache.v``, and ``length`` is a host int,
so a step reads nothing back from the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (
    CHUNK_Q,
    NEG_INF,
    decode_attention,
    flash_attention,
    flash_attention_block_plain,
    flash_attention_plain,
    flash_attention_train,
)
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, S_cache, KV, hd), (L, ...) when stacked
    v: torch.Tensor         # (B, S_cache, KV, hd)
    length: int             # tokens written so far (global position), on the host


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device, layers: int = 0) -> dict:
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    lead = (layers,) if layers else ()
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dtype, device, layers),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device, layers),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device, layers),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dtype, device, layers),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(lead + (width * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    return q, k, v


def causal_mask(S: int, window: int = 0, dtype=torch.float32, device=None) -> torch.Tensor:
    """(S, S) additive mask; window>0 => sliding-window causal."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window:
        ok = ok & (j > i - window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def sdpa(q, k, v, q_offset: int, window: int = 0) -> torch.Tensor:
    """Grouped-query attention for one query block, plain PyTorch.

    q (B,Sq,H,hd), k/v (B,Sk,KV,hd); queries at absolute positions
    q_offset..q_offset+Sq-1 of a causal sequence.
    """
    out = flash_attention_block_plain(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), q_offset, window)
    return out.transpose(1, 2)


def chunked_sdpa(q, k, v, window: int = 0, block_q: int = CHUNK_Q) -> torch.Tensor:
    """The reference's query-blocked attention in the model's layout: the
    plain version of the prefill kernel, blocks of ``block_q`` rows."""
    out = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                window, block_q)
    return out.transpose(1, 2)


def _window(cfg: ModelConfig) -> int:
    return cfg.window_size if cfg.attention == "sliding_window" else 0


def attn_forward(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    return_cache: bool = False,
    cache_len: int = 0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Train/prefill path. Returns (out (B,S,D), cache?)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    window = _window(cfg)
    attend = flash_attention
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        attend = flash_attention_train
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window)
    out = out.transpose(1, 2).reshape(B, S, -1) @ params["wo"]

    cache = None
    if return_cache:
        slots = cache_len or S
        if window and slots > window:
            slots = window
        if window and S > slots:
            # ring-buffer layout: global position p lives at slot p % slots
            ck = torch.roll(k[:, S - slots:], S % slots, dims=1)
            cv = torch.roll(v[:, S - slots:], S % slots, dims=1)
        else:
            if slots < S:
                raise ValueError(f"full-attn cache needs >= {S} slots, got {slots}")
            ck = torch.zeros((B, slots) + k.shape[2:], dtype=k.dtype, device=k.device)
            cv = torch.zeros_like(ck)
            ck[:, :S] = k
            cv[:, :S] = v
        cache = KVCache(ck, cv, S)
    return out, cache


def empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                length: int = 0, layers: int = 0) -> KVCache:
    """Cache with ``max_len`` logical context; ring-buffer sized when windowed.

    ``length`` = number of tokens considered already present (one decode
    step then appends token ``length``). ``layers > 0`` stacks that many.
    """
    hd = cfg.resolved_head_dim()
    slots = max_len
    if cfg.attention == "sliding_window":
        slots = min(max_len, cfg.window_size)
    lead = (layers,) if layers else ()
    k = torch.zeros(lead + (batch, slots, cfg.num_kv_heads, hd), dtype=dtype, device=device)
    return KVCache(k, torch.zeros_like(k), int(length))


def attn_decode_step(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,              # (B, 1, D)
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One token against the cache, written in place. Ring buffer when
    sliding-window."""
    B = x.shape[0]
    pos = cache.length                                  # global position
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    slots = cache.k.shape[1]
    slot = pos % slots if cfg.attention == "sliding_window" else min(pos, slots - 1)
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    # the valid slots are a prefix for both layouts: the reference's mask is
    # idx <= pos (full) or the ring's last `slots` positions (window)
    lengths = torch.full((B,), min(pos + 1, slots), dtype=torch.int32, device=x.device)
    out = decode_attention(q[:, 0], cache.k, cache.v, lengths)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, KVCache(cache.k, cache.v, pos + 1)
