"""RWKV-6 (Finch) 7B — attention-free RNN with data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    rwkv_head_dim=64,          # 64 wkv heads of dim 64
    norm="layernorm",
    act="gelu",                # channel-mix uses squared relu internally
    citation="arXiv:2404.05892 (Eagle and Finch: RWKV-5/6)",
)
