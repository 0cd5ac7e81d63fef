"""Kimi K2 — trillion-parameter MoE, 32B activated [arXiv:2501.kimi2].

Paper-table spec: 61L, d_model=7168, 64 heads (GQA kv=8), 384 routed experts
top-8 with expert hidden 2048, plus 1 shared expert; vocab 163840.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                # dense hidden for the first dense layer
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    num_shared_experts=1,
    experts_per_token=8,
    first_dense_layers=1,
    norm="rmsnorm",
    act="swiglu",
    citation="arXiv:2501.kimi2 (Kimi K2, paper-table spec)",
)
