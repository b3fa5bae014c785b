"""Plain PyTorch attention: the flash attention kernels' plain versions
(causal + sliding window, GQA).  Each materialises the full score matrix
in float32, as the JAX package's ``attention_ref`` does: the forward, the
row log-sum-exp the forward kernel saves for training, and the explicit
backward formulas the backward kernel computes.

``q_offset``: query row i sits at position ``q_offset + i`` of the key
axis, whose positions start at 0 (one rank's rows of the sharded step's
sequence fallback), so the causal mask keeps key j iff j <= q_offset + i
and the window iff j > q_offset + i - window."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: int, scale: float, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled scores (b, K, G, sq, sk) in float32, NEG_INF where masked,
    and the (sq, sk) mask of live pairs."""
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    qr = q.reshape(b, sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * scale
    qp = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return torch.where(ok, s, NEG_INF), ok


def _scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softmax_scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D); H = K*G.  fp32 softmax."""
    b, sq, H, D = q.shape
    s, _ = _masked_scores(q, k, causal, window, _scale(q, softmax_scale),
                          q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, H, D).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softmax_scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Row log-sum-exp of the masked scaled scores, float32 (b, H, sq): what
    the forward kernel saves for the backward.  A row with no live key
    gives about NEG_INF."""
    b, sq, H, _ = q.shape
    s, _ = _masked_scores(q, k, causal, window, _scale(q, softmax_scale),
                          q_offset)
    return torch.logsumexp(s, dim=-1).reshape(b, H, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softmax_scale: Optional[float] = None,
                      q_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention gradient from the saved output and log-sum-exp, by the
    explicit formulas in float32: P = exp(S*scale - lse) on live pairs,
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO O)), dQ = dS K scale,
    dK = dS^T Q scale.  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    G = H // K
    scale = _scale(q, softmax_scale)
    s, ok = _masked_scores(q, k, causal, window, scale, q_offset)
    p = torch.where(ok, torch.exp(s - lse.float().reshape(b, K, G, sq, 1)),
                    0.0)
    dof = do.float().reshape(b, sq, K, G, D)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    di = (do.float() * o.float()).sum(-1).reshape(b, sq, K, G)
    ds = p * (dp - di.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(b, sq, K, G, D)) * scale
    return (dq.reshape(b, sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
