"""Flash attention as a differentiable op on the card: a
``torch.autograd.Function`` whose forward launches the forward kernel with
its log-sum-exp output and whose backward launches the backward kernel.

The JAX package differentiates its attention by autodiff; this computes the
same gradient with kernels, so that the training path on a CUDA tensor
never falls to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_lse)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale, q_offset):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     softmax_scale=softmax_scale,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softmax_scale = causal, window, softmax_scale
        ctx.q_offset = q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window, softmax_scale=ctx.softmax_scale,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              softmax_scale: Optional[float] = None,
                              q_offset: int = 0) -> torch.Tensor:
    """``flash_attention`` with a gradient: CUDA tensors only."""
    return _FlashAttention.apply(q, k, v, causal, window, softmax_scale,
                                 q_offset)
