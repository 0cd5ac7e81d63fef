"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers; ONE shared full-attention block (weights reused) applied
every 6 layers, ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=80,              # expand*d_model / 64 head dim
    ssm_expand=2,
    shared_attn_every=6,
    norm="rmsnorm",
    act="gelu",
    citation="arXiv:2411.15242 (Zamba2 suite)",
)
