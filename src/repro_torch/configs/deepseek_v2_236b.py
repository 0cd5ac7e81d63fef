"""DeepSeek-V2 236B — MoE with Multi-head Latent Attention [arXiv:2405.04434].

MLA: KV compressed to kv_lora_rank=512 (+64 decoupled RoPE dims); MoE with
2 shared + 160 routed experts, top-6 routing, expert hidden 1536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: all heads decompress from the latent
    head_dim=128,              # qk nope head dim
    v_head_dim=128,
    d_ff=12288,                # dense-MLP hidden (first dense layer)
    moe_d_ff=1536,             # per-expert hidden
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    first_dense_layers=1,
    norm="rmsnorm",
    act="swiglu",
    citation="arXiv:2405.04434 (DeepSeek-V2)",
)
