"""Plain PyTorch versions of the Mamba2 SSD scan kernel.

``ssd_chunked`` is the JAX package's chunked scan (``models/mamba2.py``),
expression for expression, with two changes that follow the Pallas kernel
(``kernels/ssd_scan/ssd_scan.py``):

* a sequence that is not a whole number of chunks is padded to one with
  dt = 0, where the JAX ``ssd_chunked`` asserts.  A padded row has no decay
  (exp(0) = 1) and no input (dt x B = 0), so the state and the real rows'
  outputs are those of the unpadded sequence;
* C.B^T is computed in float32.  The JAX ``ssd_chunked`` computes it in the
  inputs' dtype; in bfloat16 at N = 128 that rounding alone moves y past
  the kernel tolerance (5e-2) from the sequential recurrence, where the
  Pallas kernel, which widens B and C first, stays within it.

``ssd_scan_ref`` is the kernel's plain version, the JAX dispatch's
``_ssd_ref``: softplus and A = -exp(A_log) in float32, then ``ssd_chunked``.
It is the CPU path of ``dispatch.ssd``.

``ssd_naive`` is the sequential recurrence, the JAX package's ``ssd_ref``
oracle; the tests hold the other two against it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (already softplus'ed); A: (h,)
    (negative); B, C: (b, s, n); D: (h,).  Returns (y (b, s, h, p) in x's
    dtype, final state (b, h, p, n) float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    s_p = -(-s // L) * L
    if s_p != s:                     # ragged tail: pad with dt = 0
        x = F.pad(x, (0, 0, 0, 0, 0, s_p - s))
        dt = F.pad(dt, (0, 0, 0, s_p - s))
        B = F.pad(B, (0, 0, 0, s_p - s))
        C = F.pad(C, (0, 0, 0, s_p - s))
    nc = s_p // L

    dA = (dt * A).reshape(b, nc, L, h)                    # log-decay per step
    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, n)
    Cc = C.reshape(b, nc, L, n)

    cum = torch.cumsum(dA, dim=2)                         # (b, nc, L, h)
    # intra-chunk (diagonal blocks): decay(i, j) = exp(cum_i - cum_j), i >= j.
    # Mask BEFORE exp: above the diagonal seg is large and positive.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b, nc, Li, Lj, h)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal[None, None, :, :, None], seg, -1e9)
    decay = torch.exp(seg)
    scores = torch.einsum("bcin,bcjn->bcij", Cc.float(), Bc.float()
                          )[..., None] * decay
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtc.float(),
                          xc.float())

    # per-chunk input states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (b, nc, L, h)
    chunk_states = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                                (dtc * decay_to_end).float(), Bc.float(),
                                xc.float())               # (b, nc, h, p, n)

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y_off = []
    for c in range(nc):                                   # the inter-chunk scan
        y_off.append(torch.einsum("bin,bhpn,bih->bihp", Cc[:, c].float(),
                                  state, torch.exp(cum[:, c])))
        state = (state * torch.exp(cum[:, c, -1, :])[:, :, None, None]
                 + chunk_states[:, c])
    y_off = torch.stack(y_off, dim=1)                     # (b, nc, L, h, p)

    y = y_diag + y_off + (D[None, None, :, None] * x.float()
                          ).reshape(b, nc, L, h, p)
    return y.reshape(b, s_p, h, p)[:, :s].to(x.dtype), state


def ssd_scan_ref(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor, *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt_raw (pre-softplus): (b, s, h); A_log, D,
    dt_bias: (h,) float32; B, C: (b, s, n).  Returns (y (b, s, h, p) in x's
    dtype, final state (b, h, p, n) float32)."""
    dt = F.softplus(dt_raw.float() + dt_bias)
    A = -torch.exp(A_log)
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def ssd_naive(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one step per position, in float32:
    state <- state exp(dt A) + dt x B^T, y = C . state + D x.  Same
    arguments and results as ``ssd_chunked``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A)                     # (b, h)
        upd = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * xf
    return y.to(x.dtype), state
