"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family] — dense, GQA(kv=8), RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    attention="gqa",
    rope_theta=1e4,
    mlp_variant="swiglu",
)
