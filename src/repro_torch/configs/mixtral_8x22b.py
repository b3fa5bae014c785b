"""Mixtral-8x22B [arXiv:2401.04088] — MoE 8 experts top-2, GQA(kv=8), SWA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    attention="gqa",
    sliding_window=4096,        # SWA per assignment [arXiv:2401.04088]
    rope_theta=1e6,
    mlp_variant="swiglu",
    num_experts=8,
    top_k=2,
    moe_d_ff=16384,
    moe_layer_period=1,          # every layer MoE
)
