"""Shared numeric building blocks (norms, init, activation)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.parallel.collectives import ModelParallel


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm with fp32 internals and the scale cast to fp32; output in
    x's dtype.  On the card, the hand-written kernel
    (``kernels/csrc/rms_norm.cu``), whose summation order makes a row's
    output independent of the rows beside it; on the CPU, the plain
    version."""
    return dispatch.rms_norm(x, scale, eps)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated norm: RMSNorm(x * silu(z)), the gate computed in fp32
    and rounded to x's dtype before the product.  On the card one kernel
    computes the gate, the product and the norm (``kernels/csrc/
    rms_norm.cu``), and its gradient one more; on the CPU, the plain
    version."""
    return dispatch.gated_rms_norm(x, z, scale, eps)


def gated_rms_norm_sharded(x: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, eps: float, width: int,
                           par: ModelParallel) -> torch.Tensor:
    """``gated_rms_norm`` over a ``width`` split on the model axis: x, z
    and scale are this rank's slice of the channels, and the row's mean
    of squares spans every rank's (its float32 sum of squares summed over
    the model axis by ``par.sum_model``).  Plain PyTorch, as the plain
    RMSNorm computes it, on the card too: the sum of squares needs an
    all-reduce between the sum and the scale, which the one-pass norm
    kernel (``gated_rms_norm``'s on one device) has no place for.  The JAX
    package computes this norm in XLA, so it is no TPU kernel."""
    g = (x * F.silu(z.float()).to(x.dtype)).float()
    ss = par.sum_model(g.square().sum(dim=-1, keepdim=True))
    return (g * torch.rsqrt(ss / width + eps) * scale.float()).to(x.dtype)


def _truncated_normal(gen: torch.Generator, shape: Sequence[int],
                      device=None) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], float32, on ``device`` (default
    the generator's)."""
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=device or gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)


def dense_init(gen: torch.Generator, shape: Sequence[int], fan_in: int, *,
               scale: float = 1.0, dtype: torch.dtype = torch.bfloat16,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, std = scale / sqrt(fan_in)."""
    return _truncated_normal(gen, shape, device).mul_(
        scale / fan_in ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], device=None
               ) -> torch.Tensor:
    return _truncated_normal(gen, shape, device).mul_(0.02).to(torch.bfloat16)


def mlp(variant: str, x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        w3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense FFN: silu(x w1) * (x w3) for ``swiglu``, else gelu(x w1);
    then w2."""
    h = x @ w1
    h = act("swiglu", h) * (x @ w3) if variant == "swiglu" else act("gelu", h)
    return h @ w2


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":  # caller handles the gate; this is the inner nonlinearity
        return F.silu(x)
    if name == "gelu":    # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)
