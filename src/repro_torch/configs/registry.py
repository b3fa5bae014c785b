"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced smoke
variants: the JAX package's twelve configurations, field for field.

The port builds every one of them: dense GQA/MHA transformers
(llama3.2-3b, stablelm-12b at head dim 160, starcoder2-3b/7b with a
sliding window, gpt2-350m/7b with GELU and tied embeddings, musicgen-medium
over EnCodec tokens), MoE (mixtral-8x22b top-2 with a sliding window,
deepseek-v2-236b with MLA attention and a MoE FFN on every layer),
attention-free Mamba2 (mamba2-130m), the hybrid jamba-1.5-large-398b
(blocks of 8 layers: Mamba2 mixers with one GQA layer at offset 4, MoE FFNs
on the odd layers and dense ones on the even) and the VLM backbone
llava-next-34b, whose decoder takes a prefix of precomputed patch
embeddings (``modal_embeds``) before the text tokens."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_v2_236b, gpt2_350m, gpt2_7b,
                                 jamba_1_5_large_398b, llama3_2_3b,
                                 llava_next_34b, mamba2_130m, mixtral_8x22b,
                                 musicgen_medium, stablelm_12b, starcoder2_3b,
                                 starcoder2_7b)
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig

_MODULES = [
    starcoder2_7b, starcoder2_3b, stablelm_12b, mixtral_8x22b, mamba2_130m,
    jamba_1_5_large_398b, deepseek_v2_236b, llama3_2_3b, llava_next_34b,
    musicgen_medium, gpt2_350m, gpt2_7b,
]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 assigned architectures (gpt2-* are the paper's own extras).
ASSIGNED = [
    "starcoder2-7b", "starcoder2-3b", "stablelm-12b", "mixtral-8x22b",
    "mamba2-130m", "jamba-1.5-large-398b", "deepseek-v2-236b", "llama3.2-3b",
    "llava-next-34b", "musicgen-medium",
]

# long_500k applicability (sub-quadratic / windowed attention only).
LONG_CONTEXT_OK = {
    "starcoder2-7b", "starcoder2-3b", "mixtral-8x22b", "mamba2-130m",
    "jamba-1.5-large-398b",
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


def smoke_config(name: str) -> ModelConfig:
    """Reduced variant of the same family: <=2 layers*period, d_model<=512,
    <=4 experts, a modal prefix of 8 embeddings (the JAX package's
    ``smoke_config``)."""
    cfg = get_arch(name)
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=256,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.attention != "none":
        kw["num_heads"] = 8
        kw["num_kv_heads"] = min(cfg.num_kv_heads, 4) or 4
        if cfg.num_kv_heads == cfg.num_heads:   # keep MHA archs MHA
            kw["num_kv_heads"] = 8
    if cfg.attention == "mla":
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32, num_kv_heads=8)
    if cfg.d_ff:
        kw["d_ff"] = 512
    if cfg.num_experts:
        kw["num_experts"] = 4
        kw["num_shared_experts"] = min(cfg.num_shared_experts, 1)
        kw["top_k"] = 2
        kw["moe_d_ff"] = 128
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 32
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.num_modal_tokens:
        kw["num_modal_tokens"] = 8
    period = cfg.block_period
    kw["num_layers"] = period * min(2, cfg.num_layers // period)
    return cfg.scaled(**kw)
