"""The plain PyTorch RMSNorm (the JAX package's ``models/common.py::
rms_norm``, float32 inside) and the gradient the kernel's autograd op
takes, from the row scales the kernel writes."""
from __future__ import annotations

from typing import Tuple

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    """RMSNorm over the last axis with fp32 internals and the scale cast to
    fp32; output in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm_bwd_ref(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                     rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rms_norm_ref`` for the output gradient g, from
    rstd = rsqrt(mean(x^2) + eps) per row (x.shape[:-1], float32):
    dx = rstd (g s - x_hat mean(g s x_hat)), dscale = sum over rows of
    g x_hat, x_hat = x rstd, in float32 and then in the inputs' dtypes."""
    xhat = x.float() * rstd[..., None]
    gs = g.float() * scale.float()
    dx = rstd[..., None] * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (g.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
