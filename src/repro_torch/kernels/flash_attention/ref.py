"""Plain PyTorch attention: the flash attention kernel's plain version
(causal + sliding window, GQA).  Materialises the full score matrix in
float32, as the JAX package's ``attention_ref`` does."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D); H = K*G.  fp32 softmax."""
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    G = H // K
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qr = q.reshape(b, sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * scale
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, H, D).to(q.dtype)
