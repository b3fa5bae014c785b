"""RMSNorm as a differentiable op on the card: a ``torch.autograd.Function``
whose forward launches the kernel and keeps its row scales, and whose
backward is ``ref.rms_norm_bwd_ref`` in PyTorch (the JAX package
differentiates its norm by autodiff; no kernel is needed for it)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rms_norm.ref import rms_norm_bwd_ref
from repro_torch.kernels.rms_norm.rms_norm import rms_norm


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rms_norm(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm_bwd_ref(g, x, scale, rstd)
        return dx, dscale, None


def rms_norm_trainable(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """``rms_norm``'s output with a gradient: CUDA tensors only."""
    return _RMSNorm.apply(x, scale, eps)
