"""Architecture registry of the port: ``--arch <id>`` resolution.

The port's copy of ``repro.configs.registry`` (``pairs_for_dryrun`` stays
with the dry-run launcher, which is not ported).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi_k2
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.olmo_1b import CONFIG as _olmo_1b
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen2_5
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2

ARCHS: Dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        _olmo_1b,
        _deepseek_v2,
        _gemma_2b,
        _qwen3,
        _kimi_k2,
        _musicgen,
        _paligemma,
        _rwkv6,
        _zamba2,
        _qwen2_5,
    )
}

# Architectures whose full replica is too large for one model group of the
# reference's TPU layout: their DAG-FL node granularity is a whole pod.
POD_GRANULARITY = frozenset({"deepseek-v2-236b", "kimi-k2-1t-a32b"})


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """The sub-quadratic variant used for ``long_500k``.

    SSM/hybrid archs are already sub-quadratic; full-attention archs switch
    to sliding-window attention (window 8,192: a bounded, ring-buffer KV
    cache).
    """
    if cfg.sub_quadratic():
        return cfg
    return replace(cfg, attention="sliding_window", window_size=8192)
