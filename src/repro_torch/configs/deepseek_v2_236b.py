"""DeepSeek-V2 (236B) [arXiv:2405.04434] — MLA kv_lora=512, MoE 2 shared + 160 routed top-6."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,            # MLA: per-head KV reconstructed from shared latent
    head_dim=128,
    d_ff=12288,                  # dense FFN on non-MoE (first) layer
    vocab_size=102400,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    mlp_variant="swiglu",
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    moe_layer_period=1,          # every layer MoE (the JAX package's first-layer-dense simplification)
)
