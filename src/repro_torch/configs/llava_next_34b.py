"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-mistral-7b-hf family] — VLM backbone.

The ViT/SigLIP vision tower + projector is a STUB per spec: ``input_specs``
provides precomputed anyres patch embeddings (2880 = 5 tiles x 576 patches)
of shape (batch, num_modal_tokens, d_model); the decoder consumes them
prepended to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    rope_theta=5e6,
    mlp_variant="swiglu",
    modality="vision",
    num_modal_tokens=2880,       # anyres: 5 tiles x 24x24 patches
)
