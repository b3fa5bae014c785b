"""The plain PyTorch RMSNorm and Mamba2's gated norm (the JAX package's
``models/common.py::rms_norm`` and ``gated_rms_norm``, float32 inside) and
their gradients from the row scales the forward writes: what
``csrc/rms_norm.cu``'s kernels compute.  The CPU runs these; on a card
only the tests and ``chip_smoke.py`` call them."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


def gated_rms_norm_ref(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated norm: ``rms_norm_ref(x * silu(z))``, the gate computed
    in fp32 and rounded to x's dtype before the product."""
    return rms_norm_ref(x * F.silu(z.float()).to(x.dtype), scale, eps)


def gated_rms_norm_bwd_ref(g: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, rstd: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dx, dz, dscale) of ``gated_rms_norm_ref`` for the output gradient
    g, from rstd of u = x * gate: the norm's gradient du (in x's dtype,
    ``rms_norm_bwd_ref`` of u), then the product's two gradients in x's
    dtype and silu's in float32, rounded where autograd rounds them."""
    zf = z.float()
    gate = F.silu(zf).to(x.dtype)
    du, dscale = rms_norm_bwd_ref(g, x * gate, scale, rstd)
    sig = torch.sigmoid(zf)
    dz = (du * x).float() * sig * (1 + zf * (1 - sig))
    return du * gate, dz.to(z.dtype), dscale
