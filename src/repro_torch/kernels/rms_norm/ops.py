"""RMSNorm and Mamba2's gated norm as differentiable ops on the card:
``torch.autograd.Function``s whose forward launches the norm kernel and
keeps its row scales, and whose backward launches the gradient kernel
(``csrc/rms_norm.cu``; the JAX package differentiates these norms by
autodiff, which XLA fuses).  The gated op saves x, z and the row scales,
never a float32 copy of z."""
from __future__ import annotations

import torch

from repro_torch.kernels.rms_norm.rms_norm import rms_norm, rms_norm_bwd


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rms_norm(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(g.contiguous(), x, scale, rstd)
        return dx, dscale, None


class _GatedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, z, scale, eps):
        y, rstd = rms_norm(x, scale, eps, z=z)
        ctx.save_for_backward(x, z, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, z, scale, rstd = ctx.saved_tensors
        dx, dz, dscale = rms_norm_bwd(g.contiguous(), x, scale, rstd, z=z)
        return dx, dz, dscale, None


def rms_norm_trainable(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """``rms_norm``'s output with a gradient: CUDA tensors only."""
    return _RMSNorm.apply(x, scale, eps)


def gated_rms_norm_trainable(x: torch.Tensor, z: torch.Tensor,
                             scale: torch.Tensor, eps: float = 1e-5
                             ) -> torch.Tensor:
    """The gated ``rms_norm``'s output with a gradient: CUDA tensors only."""
    return _GatedRMSNorm.apply(x, z, scale, eps)
