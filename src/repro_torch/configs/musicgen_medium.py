"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

The EnCodec conv codec (mel/conv frontend) is a STUB per spec: the decoder
consumes precomputed frame embeddings plus discrete codebook tokens
(vocab 2048). MHA (kv = heads = 24).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attention="gqa",             # kv == heads -> plain MHA
    rope_theta=1e4,
    mlp_variant="gelu",
    modality="audio",
    num_modal_tokens=0,          # conditioning embeddings folded into token stream
)
