"""PaliGemma-3B — SigLIP vision encoder + Gemma decoder [arXiv:2407.07726].

The SigLIP ViT + projector are a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings; this config is the Gemma LM backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # MQA (gemma backbone)
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    norm="rmsnorm",
    act="geglu",
    frontend_tokens=256,       # 224px / 14 patch -> 256 patches from SigLIP
    frontend_dim=1152,         # SigLIP So400m width
    tie_embeddings=True,
    citation="arXiv:2407.07726 (PaliGemma)",
)
