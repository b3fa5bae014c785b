"""Kernel dispatch: the ops the model calls, chosen by the device of the
input tensors.

* a CUDA tensor goes to the hand-written kernel, which launches or raises;
* a CPU tensor goes to the plain PyTorch version in the kernel's ``ref.py``.

There is no environment variable, no fallback on error and no capability
check: a card the kernel was not built for fails loudly.  ``force("ref")``
runs the plain version on any device; tests and ``chip_smoke.py`` use it to
hold the kernel path against the plain path on the card.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_decode import flash_decode_gqa, gqa_decode_ref

_forced_ref = False


@contextmanager
def force(impl: Optional[str]) -> Iterator[None]:
    """``force("ref")`` sends every op to its plain version while the
    context is open; ``force(None)`` restores choice by device."""
    global _forced_ref
    if impl not in (None, "ref"):
        raise ValueError(f"force() takes 'ref' or None, got {impl!r}")
    prev, _forced_ref = _forced_ref, impl == "ref"
    try:
        yield
    finally:
        _forced_ref = prev


def _use_kernel(x: torch.Tensor) -> bool:
    if _forced_ref or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {x.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D), H = K*G.  Returns (b, sq, H, D)."""
    fn = flash_attention if _use_kernel(q) else attention_ref
    return fn(q, k, v, causal=causal, window=window,
              softmax_scale=softmax_scale)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor, *,
                 softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention over a (ring) KV cache.

    q: (b, 1, H, D); k_cache, v_cache: (b, S, K, D); valid: (b, S) bool.
    Returns (b, 1, H, D)."""
    fn = flash_decode_gqa if _use_kernel(q) else gqa_decode_ref
    return fn(q, k_cache, v_cache, valid, softmax_scale=softmax_scale)
