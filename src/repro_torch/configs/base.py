"""Model and training configuration dataclasses.

The port keeps its own copies of the JAX package's ``ModelConfig``,
``ShapeConfig`` (with ``INPUT_SHAPES``) and ``TrainConfig``, field for
field and with the same derived properties, so that it imports nothing of
``repro``.  ``tests/test_torch_isolation.py``
holds the copies equal.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    attention: str = "gqa"           # gqa | mla | none
    num_heads: int = 0               # query heads
    num_kv_heads: int = 0            # kv heads (== num_heads for MHA)
    head_dim: int = 0                # per-head dim (0 -> d_model // num_heads)
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention

    # --- MLA (DeepSeek-V2) [arXiv:2405.04434] ---
    q_lora_rank: int = 0             # 0 -> direct q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- feed-forward ---
    d_ff: int = 0                    # dense FFN hidden size (0 -> no dense FFN)
    mlp_variant: str = "swiglu"      # swiglu | gelu

    # --- MoE ---
    num_experts: int = 0             # routed experts (0 -> dense only)
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden size (0 -> d_ff)
    moe_layer_period: int = 1        # layer l is MoE iff l % period == offset
    moe_layer_offset: int = 0

    # --- SSM (Mamba2 SSD) [arXiv:2405.21060] ---
    ssm_state: int = 0               # d_state (N)
    ssm_conv: int = 4                # depthwise conv width
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64           # P; n_ssm_heads = d_inner // P

    # --- hybrid (Jamba): layer l is attention iff
    #     l % attn_layer_period == attn_layer_offset; else mamba ---
    attn_layer_period: int = 0       # 0 -> pure (all attention or all ssm)
    attn_layer_offset: int = 0

    # --- modality frontend stubs ---
    modality: str = "text"           # text | vision | audio
    num_modal_tokens: int = 0        # precomputed frontend embeddings per sample

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---------- derived ----------
    def __post_init__(self):
        if self.attention != "none" and self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, l: int) -> str:
        """'attn' or 'ssm' for layer index l."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_layer_period:
            return ("attn" if l % self.attn_layer_period == self.attn_layer_offset
                    else "ssm")
        return "attn"

    def layer_is_moe(self, l: int) -> bool:
        if not self.num_experts:
            return False
        return l % self.moe_layer_period == self.moe_layer_offset

    @property
    def block_period(self) -> int:
        """Smallest repeating layer-pattern period (one stacked block)."""
        p = 1
        if self.attn_layer_period:
            p = self.attn_layer_period
        if self.num_experts:
            p = p * self.moe_layer_period // math.gcd(p, self.moe_layer_period)
        assert self.num_layers % p == 0, (self.name, p, self.num_layers)
        return p

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced variant of the same family (for smoke tests)."""
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    cache_len: int = 0               # decode: existing KV/state length


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode", cache_len=32_768),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode", cache_len=524_288),
}


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int = 0              # per-data-shard microbatch (0 = auto)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    steps: int = 1000
    zero: int = 1                    # 0: replicated opt state over data;
                                     # 1: opt state sharded over data;
                                     # 3: params also sharded over data
    remat: str = "block"             # none | block (checkpoint each layer block)
    seed: int = 0
