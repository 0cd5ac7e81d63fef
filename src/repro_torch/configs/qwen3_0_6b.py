"""Qwen3-0.6B — dense decoder with QK-norm and GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
    citation="hf:Qwen/Qwen3-8B model card (Qwen3 family)",
)
