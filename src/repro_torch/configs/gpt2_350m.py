"""GPT2-350M — the paper's own memory-validation model (Fig 6), vanilla MHA GPT."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-350m",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    attention="gqa",
    mlp_variant="gelu",
    tie_embeddings=True,
)
