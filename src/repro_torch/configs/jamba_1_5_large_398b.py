"""Jamba-1.5-Large (398B) [arXiv:2403.19887] -- hybrid Mamba+attention 1:7, MoE 16e top-2.

Layer pattern: period 8, one attention layer per 8 (offset 4 as in Jamba);
MoE every other layer (period 2, offset 1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attention="gqa",
    rope_theta=1e4,              # Jamba attention uses no RoPE; kept for uniformity
    mlp_variant="swiglu",
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_period=8,
    attn_layer_offset=4,
)
