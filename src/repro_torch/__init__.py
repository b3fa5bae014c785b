"""PyTorch / CUDA port of the Frenzy reproduction's model side.

It serves the dense GQA archs (llama3.2-3b, starcoder2-3b) and trains them
and gpt2-350m on one NVIDIA H100, with hand-written Hopper kernels for
attention forward and backward (``kernels/csrc/flash_attention.cu``,
``flash_attention_bwd.cu``), split-KV decode attention
(``flash_decode.cu``) and the fused Adam update (``adam_update.cu``).  It
imports torch and never JAX or the JAX package ``repro``; its subpackages
mirror that package's names.
"""
