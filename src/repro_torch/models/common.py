"""Shared numeric building blocks (norms, init, activation)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch


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
    and rounded to x's dtype before the product."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), scale, eps)


def _truncated_normal(gen: torch.Generator, shape: Sequence[int]
                      ) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], float32, on the generator's
    device."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)


def dense_init(gen: torch.Generator, shape: Sequence[int], fan_in: int, *,
               scale: float = 1.0, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    """Truncated-normal fan-in init, std = scale / sqrt(fan_in)."""
    return _truncated_normal(gen, shape).mul_(scale / fan_in ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return _truncated_normal(gen, shape).mul_(0.02).to(torch.bfloat16)


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
