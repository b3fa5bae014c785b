"""Analytic GPU/TPU memory models — the heart of MARP (paper §IV-A).

The JAX package's ``repro.core.memory_model``, function for function and
constant for constant, so that the port predicts the peaks the reference
predicts (``tests/test_torch_memory_model.py`` holds them equal).  In
place of ``xla_peak_bytes``, which reads XLA's compile-time
``memory_analysis()``, it has ``dryrun_peak_bytes``, which reads the
port's dry run (``launch.op_analysis``: a step traced on the meta device);
a card measures its peak with ``torch.cuda.max_memory_allocated()``.

Two models:

* **paper** — the exact formulas from the paper (vanilla GPT, mixed-precision
  Adam, no remat):  ``W = V·h + l·(12h² + 13h)``, static ``20W/t``,
  activations ``s·b·h·l·(10 + 24/t + 5·a·s/(h·t))``.

* **exact** — generalised to every assigned architecture family: analytic
  parameter count mirroring ``repro.models`` exactly (validated in tests
  against ``jax.eval_shape``), static bytes parameterised by ZeRO level, and
  an activation model matching our actual implementation (block remat +
  chunked attention), validated against ``compiled.memory_analysis()`` in
  EXPERIMENTS.md §Memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import moe_capacity

# Control-plane hot path: every function below is called per (d, t) candidate
# by MARP's plan sweep, which itself runs per queued job per scheduler event.
# All pure functions of hashable args are memoized (ModelConfig is a frozen
# dataclass), and the per-layer Python loops are collapsed into
# layer-kind-aggregated closed forms: a block's layers take one of at most
# four shapes — (attn|ssm) x (moe|dense) — so we compute each distinct shape
# once and weight by its count instead of looping over ``num_layers``.


@lru_cache(maxsize=4096)
def layer_kind_counts(cfg: ModelConfig) -> tuple:
    """(n_ssm, n_attn) layer counts — closed form of ``cfg.layer_kind``."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return L, 0
    if cfg.attn_layer_period:
        p, o = cfg.attn_layer_period, cfg.attn_layer_offset
        # l % p == o has solutions below L only when o < p and o < L
        n_attn = (L - 1 - o) // p + 1 if o < p and o < L else 0
        return L - n_attn, n_attn
    return 0, L


@lru_cache(maxsize=4096)
def moe_layer_count(cfg: ModelConfig) -> int:
    """#layers with ``cfg.layer_is_moe`` — closed form."""
    if not cfg.num_experts:
        return 0
    L, p, o = cfg.num_layers, cfg.moe_layer_period, cfg.moe_layer_offset
    return (L - 1 - o) // p + 1 if o < p and o < L else 0

# ------------------------------------------------------------ paper mode ----

def paper_param_count(vocab: int, hidden: int, layers: int) -> int:
    """W = V·h + l·(12h² + 13h)   (paper §IV-A)."""
    return vocab * hidden + layers * (12 * hidden ** 2 + 13 * hidden)


def paper_static_bytes(W: int, t: int) -> float:
    """20 bytes/param mixed-precision Adam state, tensor-parallel split."""
    return 20.0 * W / t


def paper_activation_bytes(s: int, b_micro: int, h: int, l: int, a: int,
                           t: int) -> float:
    """sbhl(10 + 24/t + 5as/(ht))   (paper §IV-A, Korthikanti et al.)."""
    return s * b_micro * h * l * (10.0 + 24.0 / t + 5.0 * a * s / (h * t))


def paper_peak_bytes(cfg: ModelConfig, global_batch: int, seq: int,
                     d: int, t: int) -> float:
    W = paper_param_count(cfg.vocab_size, cfg.d_model, cfg.num_layers)
    b_micro = global_batch / d
    return (paper_static_bytes(W, t)
            + paper_activation_bytes(seq, b_micro, cfg.d_model,
                                     cfg.num_layers, cfg.num_heads, t))


# ------------------------------------------------------------ exact mode ----

@lru_cache(maxsize=4096)
def analytic_param_count(cfg: ModelConfig) -> int:
    """Mirror of ``init_params`` (both packages') — validated in tests.

    Closed form over layer kinds (integer arithmetic, so aggregating by
    count is exactly equal to the per-layer sum it replaces).
    """
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    total = V * d                                      # embed
    if not cfg.tie_embeddings:
        total += d * V                                 # lm_head
    total += d                                         # final_norm
    nm = 3 if cfg.mlp_variant == "swiglu" else 2
    n_ssm, n_attn = layer_kind_counts(cfg)
    n_moe = moe_layer_count(cfg)
    total += L * d                                     # norm1, every layer
    if n_ssm:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        ch = di + 2 * n
        total += n_ssm * (d * (2 * di + 2 * n + h)     # in_proj
                          + cfg.ssm_conv * ch + ch     # conv w+b
                          + 3 * h                      # A_log, D, dt_bias
                          + di                         # gated norm
                          + di * d)                    # out_proj
    if n_attn:
        if cfg.attention == "mla":
            rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            H = cfg.num_heads
            total += n_attn * (d * rq + rq + rq * H * (dn + dr)
                               + d * (rkv + dr) + rkv
                               + rkv * H * dn + rkv * H * dv
                               + H * dv * d)
        else:
            H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            total += n_attn * (d * H * hd + 2 * d * K * hd + H * hd * d)
    # feed-forward: moe layers always carry an FFN; dense layers only when
    # d_ff > 0 (each FFN layer also carries norm2)
    n_dense_ffn = (L - n_moe) if cfg.d_ff > 0 else 0
    total += (n_moe + n_dense_ffn) * d                 # norm2
    if n_moe:
        E, f = cfg.num_experts, cfg.moe_d_ff
        per_moe = d * E + E * d * f * nm
        if cfg.num_shared_experts:
            per_moe += d * (cfg.num_shared_experts * f) * nm
        total += n_moe * per_moe
    total += n_dense_ffn * d * cfg.d_ff * nm
    return total


def static_bytes(cfg: ModelConfig, t: int, d: int, zero: int = 1) -> float:
    """Model-state bytes per device for our trainer.

    bf16 params (2 B) + bf16 grad accumulator (2 B) + fp32 master + Adam m,v
    (12 B) = 16 B/param, plus 4 B/param transient fp32 grad during the update
    = the paper's 20 B/param when unsharded.  `t` divides everything; ZeRO
    level controls which terms `d` also divides.
    """
    W = analytic_param_count(cfg)
    if zero >= 3:
        p_params = 2.0 * W / (t * d)
    else:
        p_params = 2.0 * W / t
    if zero >= 1:
        p_grads = 2.0 * W / (t * d)
        p_opt = 12.0 * W / (t * d)
        p_update = 4.0 * W / (t * d)
    else:
        p_grads = 2.0 * W / t
        p_opt = 12.0 * W / t
        p_update = 4.0 * W / t
    return p_params + p_grads + p_opt + p_update


@lru_cache(maxsize=8192)
def _block_working_bytes(cfg: ModelConfig, s: int, mb: int, t: int,
                         q_chunk: int = 2048) -> float:
    """Peak transient bytes while (re)computing one layer block.

    A layer's working set depends only on (kind, is_moe), so the per-layer
    loop collapses to at most four distinct evaluations; the max over the
    block equals the max over distinct shapes (bit-identical to the seed
    per-layer scan).
    """
    d = cfg.d_model
    per_layer = {}
    for j in range(cfg.block_period):
        kind = cfg.layer_kind(j)
        shape_key = (kind, cfg.layer_is_moe(j))
        if shape_key in per_layer:
            continue
        if kind == "ssm":
            di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            L = min(128, s)
            nc = max(s // L, 1)
            b = (mb * s * (2 * di + 2 * n + h) * 2 / t        # in_proj out
                 + mb * s * (di + 2 * n) * 2 / t              # conv out
                 + mb * nc * L * L * h * 4 / t                # intra-chunk scores+decay
                 + mb * nc * h * (di // h) * n * 4 / t        # chunk states
                 + mb * s * di * 4 / t)                       # y fp32
        elif cfg.attention == "mla":
            H = cfg.num_heads
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            qc = min(q_chunk, s)
            b = (mb * s * H * (dn + dr) * 2 * 2 / t           # q, k reconstructed
                 + mb * s * H * dv * 2 / t                    # v
                 + mb * H * qc * qc * 4 / t                   # one score chunk fp32
                 + mb * s * (cfg.kv_lora_rank + dr) * 2)      # latent (replicated)
        else:
            H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            qc = min(q_chunk, s)
            kv_span = min(s, (cfg.sliding_window or s) + qc)
            b = (mb * s * (H + 2 * K) * hd * 2 / t            # q,k,v
                 + mb * H * qc * min(qc, kv_span) * 4 / t     # one score chunk
                 + mb * s * H * hd * 4 / t)                   # acc fp32
        if cfg.layer_is_moe(j):
            E, f = cfg.num_experts, cfg.moe_d_ff
            T = mb * s
            C = moe_capacity(T, E, cfg.top_k)
            b += E * C * d * 2 / t + E * C * f * 2 * 2 / t    # xg + expert hidden
            if cfg.num_shared_experts:
                b += T * cfg.num_shared_experts * f * 2 * 2 / t
        elif cfg.d_ff:
            b += mb * s * cfg.d_ff * 2 * 2 / t                # h (+gate)
        per_layer[shape_key] = b
    # backward of one block keeps ~fwd working set + grads of it
    return 2.0 * max(per_layer.values())


@lru_cache(maxsize=8192)
def activation_bytes(cfg: ModelConfig, s: int, mb: int, t: int,
                     remat: str = "block") -> float:
    """Activation bytes per device for micro-batch ``mb`` and sequence ``s``."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    nb = L // cfg.block_period
    logits = mb * s * (V / t) * (2 + 4 + 4)            # bf16 logits + fp32 lse/grad
    x_io = 4 * mb * s * d * 2                          # embeds + residual copies
    wb = _block_working_bytes(cfg, s, mb, t)
    if remat == "block":
        stored = nb * mb * s * d * 2 * cfg.block_period  # per-sublayer carry inputs
        return stored + wb + logits + x_io
    # no remat: everything live (paper-style accounting, generalised).
    # Repeated addition (not multiplication) keeps the float result
    # bit-identical to the seed per-layer accumulation.
    total = 0.0
    for _ in range(cfg.block_period):
        total += wb / 2.0 + mb * s * d * 2 * 2
    return total * nb + logits + x_io


# Calibrated against compiled.memory_analysis() (EXPERIMENTS.md §Memory):
# XLA reserves ~0.8 GiB/device of runtime workspace (collective buffers,
# loop carries, convert scratch) independent of model size.
XLA_RUNTIME_OVERHEAD = int(0.8 * 1024 ** 3)


@lru_cache(maxsize=8192)
def exact_peak_bytes(cfg: ModelConfig, global_batch: int, seq: int,
                     d: int, t: int, *, zero: int = 1, microbatch: int = 0,
                     remat: str = "block") -> float:
    """Predicted peak bytes/device for our trainer under plan (d, t)."""
    shard_batch = max(global_batch // d, 1)
    mb = microbatch or min(shard_batch, 1)
    mb = max(min(mb, shard_batch), 1)
    return (static_bytes(cfg, t, d, zero)
            + activation_bytes(cfg, seq, mb, t, remat)
            + XLA_RUNTIME_OVERHEAD)


@lru_cache(maxsize=4096)
def active_param_count(cfg: ModelConfig) -> int:
    """Parameters active per token: a MoE layer counts its top_k routed
    experts and the shared ones (the JAX package's
    ``repro.core.marp._active_analytic``, which the calibration prices
    with)."""
    total = analytic_param_count(cfg)
    if not cfg.num_experts:
        return total
    nm = 3 if cfg.mlp_variant == "swiglu" else 2
    n_moe = moe_layer_count(cfg)
    per_e = cfg.d_model * cfg.moe_d_ff * nm
    return total - n_moe * per_e * (cfg.num_experts - cfg.top_k)


def lora_param_count(cfg: ModelConfig, rank: int) -> int:
    """Trainable adapter params of a LoRA finetune: the A+B factor pair
    (``2 * d_model * rank`` params) on each of the four attention
    projections per layer — the same adapter shape
    ``ckpt.checkpoint.lora_state_bytes`` serializes."""
    return 4 * 2 * cfg.d_model * rank * cfg.num_layers


@lru_cache(maxsize=8192)
def lora_peak_bytes(cfg: ModelConfig, global_batch: int, seq: int,
                    d: int, t: int, *, rank: int, zero: int = 1,
                    microbatch: int = 0, remat: str = "block") -> float:
    """Predicted peak bytes/device of a LoRA finetune under plan (d, t).

    The frozen base model still streams through every device (bf16 params,
    2 B/param, tensor-sharded) and the forward/backward activations are
    those of full training — gradients flow through the base layers to
    reach the adapters — but the 18 B/param grad + optimizer + update
    state exists only for the adapter params (20 B/param on them,
    ZeRO-shardable).  That is what makes mid-sized finetunes *small*:
    a few-GB slice instead of a whole card, the sliceable end of the
    fractional-GPU packing axis."""
    shard_batch = max(global_batch // d, 1)
    mb = microbatch or min(shard_batch, 1)
    mb = max(min(mb, shard_batch), 1)
    W = analytic_param_count(cfg)
    frozen = 2.0 * W / t                       # bf16 base, no train state
    A = lora_param_count(cfg, rank)
    denom = (t * d) if zero >= 1 else t
    adapter = 20.0 * A / denom                 # full train state, adapters only
    return (frozen + adapter
            + activation_bytes(cfg, seq, mb, t, remat)
            + XLA_RUNTIME_OVERHEAD)


# --------------------------------------------------- dry-run accounting ----

def dryrun_peak_bytes(stats) -> Optional[int]:
    """Peak bytes/device from a dry-run trace (``launch.op_analysis.OpStats``
    of one step on the meta device) -- the counterpart of the JAX
    package's ``xla_peak_bytes``: what was live when the step began (its
    arguments, ``entry_bytes``) plus the most the step added at once (its
    temporaries and outputs, ``temp_bytes``), each storage rounded up to
    the CUDA caching allocator's 512 bytes, so that it compares with
    ``torch.cuda.max_memory_allocated()`` over the same step.  None where
    the trace followed no storages: the peak is missing, never guessed."""
    if stats.entry_bytes is None or stats.temp_bytes is None:
        return None
    return int(stats.entry_bytes + stats.temp_bytes)


# ----------------------------------------------------------- serve mode -----

@lru_cache(maxsize=8192)
def serve_bytes_split(cfg: ModelConfig, batch: int, cache_len: int,
                      d: int, t: int, *, zero: int = 0) -> tuple:
    """(weight, cache, workspace) bytes/device for decode — the components
    of ``serve_peak_bytes``, exposed so serve-plan ranking can charge the
    weight stream and the cache slice separately."""
    W = analytic_param_count(cfg)
    wbytes = 2.0 * W / (t * d if zero >= 3 else t)
    n_ssm, n_attn = layer_kind_counts(cfg)
    cache = 0.0
    if n_ssm:
        ch = cfg.d_inner + 2 * cfg.ssm_state
        cache += n_ssm * batch * ((cfg.ssm_conv - 1) * ch * 2
                                  + cfg.n_ssm_heads * cfg.ssm_head_dim
                                  * cfg.ssm_state * 4) / t
    if n_attn:
        if cfg.attention == "mla":
            cache += n_attn * batch * cache_len * (cfg.kv_lora_rank
                                                   + cfg.qk_rope_head_dim) * 2 / d
        else:
            S = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
            cache += n_attn * batch * S * 2 * cfg.num_kv_heads \
                * cfg.head_dim * 2 / (d * t)
    work = batch * cfg.d_model * 64 * 2                # decode workspace (small)
    return wbytes, cache, work


def serve_peak_bytes(cfg: ModelConfig, batch: int, cache_len: int,
                     d: int, t: int, *, zero: int = 0) -> float:
    """Peak bytes/device for decode: bf16 weights + KV/SSM cache + workspace."""
    return sum(serve_bytes_split(cfg, batch, cache_len, d, t, zero=zero))
