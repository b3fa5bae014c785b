"""RoPE and the GQA attention layer: full-sequence (prefill) attention and
single-token decode over a ring KV cache.

Weights keep the JAX package's layouts -- ``wq`` (d, H, hd), ``wk``/``wv``
(d, K, hd), ``wo`` (H, hd, d) -- so parameters convert leaf for leaf.  The
attention itself goes through ``repro_torch.kernels.dispatch``: the
hand-written kernels for CUDA tensors, the plain versions for CPU tensors.

Decode writes the new token's k/v into the cache **in place** (the JAX
functions return a new cache): no decode step copies the cache.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch

Pos = Union[int, torch.Tensor]


# ---------------------------------------------------------------- RoPE ------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,) or (..., seq).
    Split-half layout, computed in fp32 and cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    angles = positions[..., :, None].float() * freqs          # (..., s, d/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., s, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- GQA ------

def gqa_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
            "wo": (H, hd, d)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out_project(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    b, s, H, hd = o.shape
    return o.reshape(b, s, H * hd) @ wo.reshape(H * hd, -1)


def gqa_project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    return q, k, v


def gqa_attend_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence (prefill) attention.  Returns (out, kv) where kv holds
    the k/v tensors for cache construction."""
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    o = dispatch.attention(q, k, v, causal=True, window=cfg.sliding_window)
    return _out_project(o, p["wo"]), {"k": k, "v": v}


def ring_index(pos: Pos, S: int, b: int, device):
    """Rope positions, ring-buffer write slot and (b, S) validity mask of a
    decode step.

    ``pos`` is the absolute position of the incoming token: an int (every
    row at the same position) or a (b,) tensor of per-row positions.  Slot
    i holds absolute position i + S*floor((pos - i)/S); it is valid iff its
    age (slot - i) % S is at most min(pos, S-1), so the newest slot is
    always valid.  Returns (positions (1,) or (b, 1), slot int or (b,),
    valid (b, S) bool).
    """
    idx = torch.arange(S, device=device)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        posv = pos.to(device=device, dtype=torch.long)
        slot = posv % S
        age = (slot[:, None] - idx[None, :]) % S
        return posv[:, None], slot, age <= torch.clamp(posv[:, None], max=S - 1)
    pos = int(pos)
    slot = pos % S
    valid = ((slot - idx) % S) <= min(pos, S - 1)
    return (torch.tensor([pos], device=device), slot,
            valid.expand(b, S).contiguous())


def gqa_attend_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], ring: tuple
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); cache: {'k', 'v'} of (b, S, K, hd); ring:
    ``ring_index(pos, S, b, device)`` for the incoming token's absolute
    position ``pos`` (the JAX function takes ``pos`` and derives it; every
    layer of a step shares it, so the port derives it once per step).

    The new k/v are written into ``cache`` in place; the returned cache is
    the same tensors."""
    b = x.shape[0]
    k_cache, v_cache = cache["k"], cache["v"]
    positions, slot, valid = ring
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    rows = torch.arange(b, device=x.device) if isinstance(slot, torch.Tensor) \
        else slice(None)
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]
    o = dispatch.flash_decode(q, k_cache, v_cache, valid)
    return _out_project(o, p["wo"]), cache
