"""Qwen2.5-14B — dense decoder, GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B card
(family spec scaled per assignment table)]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    citation="hf:Qwen/Qwen2.5-0.5B (Qwen2.5 family)",
)
