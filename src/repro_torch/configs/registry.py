"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced smoke
variants.  The port runs llama3.2-3b (full attention), starcoder2-3b
(sliding window, which exercises the ring cache), gpt2-350m (MHA with GELU
and tied embeddings, the paper's memory-validation model, which the port
trains), deepseek-v2-236b (MLA attention and a MoE FFN on every layer,
which the port serves), mamba2-130m (attention-free Mamba2 SSD layers,
which the port serves and trains) and jamba-1.5-large-398b (blocks of 8
layers: Mamba2 mixers with one GQA layer at offset 4, MoE FFNs on the odd
layers and dense ones on the even, which the port serves)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_v2_236b, gpt2_350m,
                                 jamba_1_5_large_398b, llama3_2_3b,
                                 mamba2_130m, starcoder2_3b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in (llama3_2_3b, starcoder2_3b,
                                           gpt2_350m, deepseek_v2_236b,
                                           mamba2_130m, jamba_1_5_large_398b)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced variant of the same family: <=2 layers*period, d_model<=512,
    <=4 experts (the JAX package's ``smoke_config``, restricted to the
    archs the port runs: no modal prefix)."""
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
    period = cfg.block_period
    kw["num_layers"] = period * min(2, cfg.num_layers // period)
    return cfg.scaled(**kw)
