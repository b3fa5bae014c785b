"""Plain PyTorch versions of the split-KV flash decode kernel.

``gqa_decode_ref`` is the whole-cache softmax, expression for expression the
JAX package's ``gqa_decode_ref``: the score product runs in the inputs'
dtype and is widened to float32 afterwards.  It is the CPU path of
``dispatch.flash_decode``.

``gqa_decode_splitk`` is the two-pass split-KV computation the kernel does:
one (acc, m, l) partial per cache block, masked rows giving p = 0, then the
running-max merge.  The two differ on a row with no valid entry: the
whole-cache softmax returns the mean of V there, the split-KV merge returns
0 (l = 0 gives 0 / 1e-30).  The kernel follows the split-KV semantics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gqa_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, valid: torch.Tensor, *,
                   softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention over a (possibly ring) KV cache.

    q: (b, 1, H, D); k_cache, v_cache: (b, S, K, D); valid: (b, S) bool.
    Returns (b, 1, H, D) in v's dtype.
    """
    b, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(b, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float() * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, H, D)


def _combine_partials(acc, m, l):
    """Merge per-block partials over the block axis (axis 1) with the
    running-max rescale."""
    m_g = m.amax(dim=1)
    alpha = torch.exp(m - m_g.unsqueeze(1))
    l_g = (l * alpha).sum(dim=1)
    out = (acc * alpha[..., None]).sum(dim=1)
    return out / torch.clamp(l_g, min=1e-30)[..., None]


def gqa_decode_splitk(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, valid: torch.Tensor, *,
                      block_s: int,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Split-KV flash decode: one (acc, m, l) partial per cache block of
    ``block_s`` rows, then the two-pass merge."""
    b, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(b, K, G, D)
    accs, ms, ls = [], [], []
    for s0 in range(0, S, block_s):
        kb = k_cache[:, s0:s0 + block_s]
        vb = v_cache[:, s0:s0 + block_s]
        ok = valid[:, None, None, s0:s0 + block_s]
        s = torch.einsum("bkgd,bskd->bkgs", qr, kb).float() * scale
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(dim=-1)                          # (b, K, G)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(vb.dtype), vb).float())
        ms.append(m)
    out = _combine_partials(torch.stack(accs, 1), torch.stack(ms, 1),
                            torch.stack(ls, 1))
    return out.to(v_cache.dtype).reshape(b, 1, H, D)
