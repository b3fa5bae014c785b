"""StarCoder2-7B [arXiv:2402.19173] — dense, GQA(kv=4), RoPE, sliding window 4096."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    attention="gqa",
    sliding_window=4096,        # native SWA [arXiv:2402.19173]
    rope_theta=1e5,
    mlp_variant="gelu",
)
