"""Plain PyTorch versions of the split-KV flash decode kernels, GQA and
MLA.

``gqa_decode_ref`` and ``mla_decode_ref`` are the whole-cache softmax,
expression for expression the JAX package's: the score products run in the
inputs' dtype and are widened to float32 afterwards.  They are the CPU
paths of ``dispatch.flash_decode`` and ``dispatch.mla_flash_decode``.

``gqa_decode_splitk`` and ``mla_decode_splitk`` are the two-pass split-KV
computation the kernels do: one (acc, m, l) partial per cache block, masked
rows giving p = 0, then the running-max merge.  The two differ on a row
with no valid entry: the whole-cache softmax returns the mean of V (of
c_kv for MLA) there, the split-KV merge returns 0 (l = 0 gives 0 / 1e-30).
The kernels follow the split-KV semantics.

``return_lse=True`` gives the output in float32 beside each (b, h)'s
log-sum-exp of the scores, for a merge of partial results across ranks; a
row with no valid entry then gives 0 and -inf, as the kernels do, in all
four.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gqa_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, valid: torch.Tensor, *,
                   softmax_scale: Optional[float] = None,
                   return_lse: bool = False):
    """Single-token GQA attention over a (possibly ring) KV cache.

    q: (b, 1, H, D); k_cache, v_cache: (b, S, K, D); valid: (b, S) bool.
    Returns (b, 1, H, D) in v's dtype; with ``return_lse``, (out float32,
    lse (b, H) float32), p rounded to v's dtype before p.V as the kernel
    does.
    """
    b, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(b, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float() * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if return_lse:
        return _with_lse(s, valid[:, None, None, :], v_cache, "bkgs,bskd->bkgd",
                         (b, 1, H, D), (b, H))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, H, D)


def _with_lse(s, ok, v, spec, out_shape, lse_shape):
    """(p.V float32, log-sum-exp) of float32 scores ``s`` masked by
    ``ok`` (masked entries already NEG_INF): p = exp(s - m) rounded to v's
    dtype, l = the sum of the unrounded p; a row with no valid entry gives
    0 and -inf."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum(spec, p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -math.inf)
    return out.reshape(out_shape), lse.reshape(lse_shape)


def _combine_partials(acc, m, l, return_lse=False):
    """Merge per-block partials over the block axis (axis 1) with the
    running-max rescale; with ``return_lse`` also each row's
    log-sum-exp (-inf where no block held a valid entry)."""
    m_g = m.amax(dim=1)
    alpha = torch.exp(m - m_g.unsqueeze(1))
    l_g = (l * alpha).sum(dim=1)
    out = (acc * alpha[..., None]).sum(dim=1)
    out = out / torch.clamp(l_g, min=1e-30)[..., None]
    if not return_lse:
        return out
    return out, torch.where(l_g > 0, m_g + torch.log(l_g), -math.inf)


def gqa_decode_splitk(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, valid: torch.Tensor, *,
                      block_s: int,
                      softmax_scale: Optional[float] = None,
                      return_lse: bool = False):
    """Split-KV flash decode: one (acc, m, l) partial per cache block of
    ``block_s`` rows, then the two-pass merge; ``return_lse`` as for
    ``gqa_decode_ref``."""
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
                            torch.stack(ls, 1), return_lse)
    if return_lse:
        return out[0].reshape(b, 1, H, D), out[1].reshape(b, H)
    return out.to(v_cache.dtype).reshape(b, 1, H, D)


def mla_decode_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   c_kv: torch.Tensor, k_rope: torch.Tensor,
                   valid: torch.Tensor, *, denom: float,
                   return_lse: bool = False):
    """Matrix-absorbed MLA decode attention in latent space.

    q_lat: (b, H, r); q_rope: (b, H, dr); c_kv: (b, S, r); k_rope:
    (b, S, dr); valid: (b, S) bool; denom = sqrt(dn + dr).  Returns o_lat
    (b, H, r) in c_kv's dtype; with ``return_lse``, (o_lat float32, lse
    (b, H) float32), p rounded to c_kv's dtype before p.c_kv as the kernel
    does."""
    s_nope = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope, k_rope)
    scores = (s_nope + s_rope).float() / denom
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    if return_lse:
        b, H, r = q_lat.shape
        return _with_lse(scores, valid[:, None, :], c_kv, "bhs,bsr->bhr",
                         (b, H, r), (b, H))
    pr = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", pr.to(c_kv.dtype), c_kv)


def mla_decode_splitk(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor,
                      valid: torch.Tensor, *, denom: float,
                      block_s: int, return_lse: bool = False):
    """Split-KV MLA latent decode: one (acc, m, l) partial per cache block
    of ``block_s`` rows, then the two-pass merge.  A row with no valid
    entry gives 0; ``return_lse`` as for ``mla_decode_ref``."""
    accs, ms, ls = [], [], []
    for s0 in range(0, c_kv.shape[1], block_s):
        cb = c_kv[:, s0:s0 + block_s]
        rb = k_rope[:, s0:s0 + block_s]
        ok = valid[:, None, s0:s0 + block_s]
        s = (torch.einsum("bhr,bsr->bhs", q_lat, cb)
             + torch.einsum("bhd,bsd->bhs", q_rope, rb)).float() / denom
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(dim=-1)                          # (b, H)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhs,bsr->bhr", p.to(cb.dtype), cb).float())
        ms.append(m)
    out = _combine_partials(torch.stack(accs, 1), torch.stack(ms, 1),
                            torch.stack(ls, 1), return_lse)
    return out if return_lse else out.to(c_kv.dtype)
