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

``ssd_scan_bwd_ref`` is the plain version of the scan's gradient kernel
(``csrc/ssd_scan_bwd.cu``), the chunked backward written out: the JAX
package has no such kernel and differentiates ``ssd_chunked`` by
autodiff; the tests hold this against ``jax.vjp`` of that path and against
torch's autograd through ``ssd_scan_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    dtype, final state (b, h, p, n) float32).  On the meta device (shapes
    only) the scan takes one chunk whatever ``chunk`` says: one pass."""
    if x.device.type == "meta":
        chunk = max(x.shape[1], 1)
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


def ssd_scan_bwd_ref(x: torch.Tensor, dt_raw: torch.Tensor,
                     A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                     D: torch.Tensor, dt_bias: torch.Tensor, dy: torch.Tensor,
                     d_state: Optional[torch.Tensor] = None, *,
                     chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan_ref``'s (y, final state) with respect to
    its inputs, given dy (b, s, h, p) and, optionally, d_state (b, h, p, n)
    for the final state (None: the state is not used).  Returns (dx,
    ddt_raw, dA_log, dB, dC, dD, ddt_bias): dx, ddt_raw, dB, dC in the
    dtypes of x, dt_raw, B, C; the (h,) vectors float32.

    All in float32, chunk by chunk (chunk length L, a ragged tail padded
    with dt = 0 as the forward pads it).  With cum the in-chunk cumsum of
    dt A, e_i = exp(cum_i), w_j = dt_j exp(cum_L - cum_j), S_c the state
    entering chunk c and G_c the gradient of the state leaving it:

    * forward recompute: S_{c+1} = exp(cum_L) S_c + sum_j w_j x_j B_j^T;
    * the reverse pass over the chunks: G_{c-1} = exp(cum_L) G_c
      + sum_i e_i dy_i C_i^T, from G_last = d_state;
    * the diagonal block y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j)
      dt_j x_j, the carried-state output e_i S_c C_i, and the state update
      each give their share of dx, dB, dC, ddt and of the gradient of cum;
    * cum's gradient becomes each step's log-decay gradient by a reverse
      cumsum over the chunk; the chain through a = dt A, A = -exp(A_log) and
      dt = softplus(dt_raw + dt_bias) ends it.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    s_p = -(-s // L) * L
    nc = s_p // L
    xf, Bf, Cf, dyf = x.float(), B.float(), C.float(), dy.float()
    r = dt_raw.float() + dt_bias                       # (b, s, h)
    dt = F.softplus(r)
    A = -torch.exp(A_log)
    if s_p != s:                     # ragged tail: pad with dt = 0
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, s_p - s)) for t in (xf, dyf))
        Bf, Cf, dt = (F.pad(t, (0, 0, 0, s_p - s)) for t in (Bf, Cf, dt))
    xc, dyc = xf.reshape(b, nc, L, h, p), dyf.reshape(b, nc, L, h, p)
    Bc, Cc = Bf.reshape(b, nc, L, n), Cf.reshape(b, nc, L, n)
    dtc = dt.reshape(b, nc, L, h)

    cum = torch.cumsum(dtc * A, dim=2)                 # (b, nc, L, h)
    last = cum[:, :, -1]                               # (b, nc, h)
    e = torch.exp(cum)
    to_end = torch.exp(last[:, :, None] - cum)         # exp(cum_L - cum_j)
    w = dtc * to_end

    # the states entering each chunk, and the gradients of those leaving it
    upd = torch.einsum("bclh,bclhp,bcln->bchpn", w, xc, Bc)
    dfrom_y = torch.einsum("bclh,bclhp,bcln->bchpn", e, dyc, Cc)
    run = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    S = []
    for c in range(nc):
        S.append(run)
        run = run * torch.exp(last[:, c])[:, :, None, None] + upd[:, c]
    S = torch.stack(S, dim=1)                          # (b, nc, h, p, n)
    run = (torch.zeros_like(run) if d_state is None else d_state.float())
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = run
        run = run * torch.exp(last[:, c])[:, :, None, None] + dfrom_y[:, c]
    G = torch.stack(G, dim=1)                          # (b, nc, h, p, n)

    # the diagonal blocks: decay(i, j) = exp(cum_i - cum_j), j <= i
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b, nc, i, j, h)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -1e9))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    dyx = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    M = cb * decay                                     # y_i = sum_j M_ij dt_j x_j
    Q = dyx * decay * dtc[:, :, None]                  # dL/d(C_i . B_j)
    Z = cb * Q                                         # the (i, j) terms' share

    GB = torch.einsum("bchpn,bcjn->bcjhp", G, Bc)      # G B_j
    u = torch.einsum("bcjhp,bcjhp->bcjh", xc, GB)      # x_j . G B_j
    dx = (dtc[..., None] * torch.einsum("bcijh,bcihp->bcjhp", M, dyc)
          + w[..., None] * GB + D[:, None] * dyc)
    dB = (torch.einsum("bcijh,bcin->bcjn", Q, Cc)
          + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xc, G))
    dyS = torch.einsum("bcihp,bchpn->bcihn", dyc, S)   # dy_i^T S
    dC = (torch.einsum("bcijh,bcjn->bcin", Q, Bc)
          + torch.einsum("bcih,bcihn->bcin", e, dyS))
    ddt = torch.einsum("bcijh->bcjh", M * dyx) + to_end * u
    dcum = (Z.sum(3) - Z.sum(2)
            + e * torch.einsum("bcihn,bcin->bcih", dyS, Cc) - w * u)
    dcum[:, :, -1] += (torch.exp(last) * torch.einsum("bchpn,bchpn->bch", G, S)
                       + (w * u).sum(2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + A * da
    dA = (dtc * da).sum((0, 1, 2))

    ddt = ddt.reshape(b, s_p, h)[:, :s]
    dr = ddt * torch.sigmoid(r)                        # softplus' derivative
    dx = dx.reshape(b, s_p, h, p)[:, :s]
    dB, dC = (t.reshape(b, s_p, n)[:, :s] for t in (dB, dC))
    dD = torch.einsum("bshp,bshp->h", dy.float(), x.float())
    return (dx.to(x.dtype), dr.to(dt_raw.dtype), dA * A, dB.to(B.dtype),
            dC.to(C.dtype), dD, dr.sum((0, 1)))
