"""MusicGen-Large — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

The EnCodec tokenizer/codec is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings; this config is the transformer backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,            # EnCodec codebook size
    norm="layernorm",
    act="gelu",
    frontend_tokens=256,        # conditioning frames from the stubbed codec
    frontend_dim=2048,
    citation="arXiv:2306.05284 (Simple and Controllable Music Generation)",
)
