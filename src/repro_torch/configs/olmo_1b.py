"""OLMo-1B — dense decoder, non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,           # MHA (GQA kv=16)
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_layernorm",  # OLMo uses LN without scale/bias
    act="swiglu",
    tie_embeddings=True,
    citation="arXiv:2402.00838 (OLMo: Accelerating the Science of LMs)",
)
