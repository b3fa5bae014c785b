"""GPT2-7B — the paper's own memory-validation model (Fig 6), vanilla MHA GPT.

GPT-2 architecture scaled to ~7B (the paper's "GPT2-7B"): 32 layers, h=4096.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=16384,
    vocab_size=50257,
    attention="gqa",
    mlp_variant="gelu",
    tie_embeddings=True,
)
