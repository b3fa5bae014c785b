"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family] — dense, GQA(kv=8), RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    attention="gqa",
    rope_theta=5e5,
    mlp_variant="swiglu",
    tie_embeddings=True,
)
