"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced smoke
variants.  The port runs the dense GQA archs only: llama3.2-3b (full
attention), starcoder2-3b (sliding window, which exercises the ring cache)
and gpt2-350m (MHA with GELU and tied embeddings, the paper's
memory-validation model, which the port trains)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import gpt2_350m, llama3_2_3b, starcoder2_3b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in (llama3_2_3b, starcoder2_3b,
                                           gpt2_350m)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced variant of the same family: <=2 layers*period, d_model<=512
    (the JAX package's ``smoke_config``, restricted to dense GQA archs)."""
    cfg = get_arch(name)
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=256,
        vocab_size=512,
        head_dim=32,
        num_heads=8,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 4,
    )
    if cfg.num_kv_heads == cfg.num_heads:       # keep MHA archs MHA
        kw["num_kv_heads"] = 8
    if cfg.d_ff:
        kw["d_ff"] = 512
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    period = cfg.block_period
    kw["num_layers"] = period * min(2, cfg.num_layers // period)
    return cfg.scaled(**kw)
