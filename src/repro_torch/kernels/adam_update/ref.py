"""Plain PyTorch mixed-precision Adam: the fused kernel's plain version,
the formulas of the JAX package's ``adam_ref``, in float32."""
from __future__ import annotations

import torch


def adam_ref(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             master: torch.Tensor, *, lr: float, beta1: float, beta2: float,
             eps: float, wd: float, c1: float, c2: float):
    """All float32 except the returned bfloat16 params; c1/c2 are the bias
    corrections 1 - beta^t.  Returns new (m', v', master', params)."""
    g = g.float()
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * torch.square(g)
    update = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + wd * master
    master2 = master - lr * update
    return m2, v2, master2, master2.to(torch.bfloat16)
