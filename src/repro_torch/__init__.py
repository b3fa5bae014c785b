"""PyTorch / CUDA port of the Frenzy reproduction's model side.

It serves the dense GQA archs (llama3.2-3b, starcoder2-3b) on an NVIDIA
H100, with hand-written Hopper kernels for prefill attention
(``kernels/csrc/flash_attention.cu``) and split-KV decode attention
(``kernels/csrc/flash_decode.cu``).  It imports torch and never JAX or the
JAX package ``repro``; its subpackages mirror that package's names.
"""
