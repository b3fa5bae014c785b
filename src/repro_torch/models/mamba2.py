"""Mamba2 SSD (state-space duality) mixer [arXiv:2405.21060], the JAX
package's ``models/mamba2.py`` in PyTorch.

The full-sequence scan goes through ``repro_torch.kernels.dispatch.ssd``:
the hand-written ``ssd_scan`` kernel for a CUDA tensor, the plain chunked
scan for a CPU tensor.  Layout follows the Mamba2 reference: projections
to z, [x | B | C] and dt, a depthwise causal conv over [x | B | C], SSD
with a scalar A per head, the gated RMSNorm, out_proj.  One B/C group.
The single-token decode step is plain PyTorch, as in the JAX package.

One rank of the sharded step (``mamba2_forward(..., par)``) holds its
heads' channels (``sharding.ssm_split``): h/t whole heads when the model
axis divides the h heads, else h/g heads of P g/t channels each (g =
gcd(h, t); mamba2-130m at t = 16: 3 heads of 32).  It holds those
channels' columns of ``in_zx`` ([z | x] of them,
``parallel.collectives.SSM_LEAVES``), ``conv_x`` and ``norm`` and their
rows of ``out_proj``; its heads' columns of ``in_dt`` and entries of
``A_log``, ``D`` and ``dt_bias`` when t divides h, else all of them (the
JAX package keeps them whole) and it slices its heads; ``in_bc`` and
``conv_bc`` are replicated and read the pre-``to_model`` input.  Its
decode caches follow ``sharding.cache_specs``: the SSD state of its heads
(b, h/t, p, n), or the whole state when t does not divide h, and the
rank's contiguous ch/t channels of the pre-conv window [x | B | C]
(``conv_window_shard``), which splits heads and B|C where it falls;
``mamba2_decode(..., par)`` gathers the window's three rows whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import gated_rms_norm, gated_rms_norm_sharded
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.collectives import ModelParallel

Params = Dict[str, torch.Tensor]


def mamba2_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's mixer leaves (mamba2.py:24-46 of the JAX package): the
    projections split by role -- [z | x], [B | C], dt -- the conv weights
    and biases of x and of [B | C], the float32 A_log, D and dt_bias, the
    gated norm's scale and out_proj."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {"in_zx": (d, 2 * di), "in_bc": (d, 2 * n), "in_dt": (d, h),
            "conv_x_w": (cfg.ssm_conv, di), "conv_x_b": (di,),
            "conv_bc_w": (cfg.ssm_conv, 2 * n), "conv_bc_b": (2 * n,),
            "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm": (di,),
            "out_proj": (di, d)}


def _project(cfg: ModelConfig, p: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> z (b, s, di), xBC (b, s, di + 2n) pre-conv, dt_raw
    (b, s, h)."""
    di = cfg.d_inner
    zx = x @ p["in_zx"]
    return (zx[..., :di], torch.cat([zx[..., di:], x @ p["in_bc"]], dim=-1),
            x @ p["in_dt"])


def _conv_params(p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.cat([p["conv_x_w"], p["conv_bc_w"]], dim=1),
            torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=0))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d, then silu in float32.  xBC: (batch, s, ch);
    w: (width, ch); b: (ch,)."""
    width, s = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = pad[:, :s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu((out + b).float()).to(xBC.dtype)


def mamba2_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   par: Optional[ModelParallel] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  x: (b, s, d).  Returns (out (b, s, d), the
    decode cache: conv, the last w - 1 *pre-conv* xBC rows (b, w - 1, ch),
    left-padded with zeros when s < w - 1, and ssd, the final state
    (b, h, p, n) float32).  With ``par``, x is the replicated
    (pre-``to_model``) input, out the rank's share (the caller sums it over
    the model axis) and the cache its heads' channels."""
    if par is not None:
        return _forward_rank(cfg, p, x, par)
    b, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv
    z, xBC, dt_raw = _project(cfg, p, x)
    conv_state = (xBC[:, s - (w - 1):] if s >= w - 1
                  else F.pad(xBC, (0, 0, w - 1 - s, 0)))
    xBC = _causal_conv(xBC, *_conv_params(p))
    # the kernel takes contiguous tensors: split the conv output's channels
    xs = xBC[..., :di].reshape(b, s, h, hp).contiguous()
    B = xBC[..., di:di + n].contiguous()
    C = xBC[..., di + n:].contiguous()
    y, state = dispatch.ssd(xs, dt_raw, p["A_log"], B, C, p["D"],
                            p["dt_bias"])
    y = gated_rms_norm(y.reshape(b, s, di), z, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": conv_state, "ssd": state.float()}


def _rank_heads(cfg: ModelConfig, par: ModelParallel
                ) -> Tuple[int, int, Optional[int]]:
    """(the rank's SSD heads, the channels of each, the first of its heads
    in the whole vectors, or None when the model axis divides the heads:
    then ``in_dt``, ``A_log``, ``D`` and ``dt_bias`` hold its heads
    alone)."""
    _, q, hl, pl = sh.ssm_split(cfg, par.t)
    return hl, pl, None if q == 1 else (par.model_idx // q) * hl


def _rank_vectors(cfg: ModelConfig, p: Params, par: ModelParallel,
                  h0: Optional[int]) -> Tuple[torch.Tensor, ...]:
    """The rank's heads' A_log, D and dt_bias.  Whole on every rank when
    the model axis does not divide the heads: through ``to_model`` before
    the slice, since each rank's gradient of them sums its channels
    only."""
    names = ("A_log", "D", "dt_bias")
    if h0 is None:
        return tuple(p[k] for k in names)
    hl = sh.ssm_split(cfg, par.t)[2]
    return tuple(par.to_model(p[k])[h0:h0 + hl] for k in names)


def _gather_channels(cfg: ModelConfig, x: torch.Tensor,
                     par: ModelParallel) -> torch.Tensor:
    """The rank's x channels (..., di_l) gathered over the model axis into
    d_inner's order (..., di)."""
    whole = par.gather_model(x, -1)
    if sh.ssm_split(cfg, par.t)[1] == 1:
        return whole                       # rank order is d_inner's
    return sh.ssm_natural_order(whole, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                par.t)


def _forward_rank(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  par: ModelParallel
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``mamba2_forward`` on this rank's heads and channels
    (``sharding.ssm_split``).  B and C come from the replicated ``in_bc``
    and ``conv_bc`` on x and go through ``to_model`` after the conv, so
    the SSD gradient's dB and dC (summed over the rank's heads) are summed
    over the model axis once; the depthwise conv runs on x's and on
    [B | C]'s channels apart, which is exact.  When the model axis does
    not divide the heads, ``in_dt`` and the per-head vectors are whole, as
    in the JAX package, and the rank takes its heads' slice after the
    replicated product (``_rank_vectors``)."""
    b, s, _ = x.shape
    n, w = cfg.ssm_state, cfg.ssm_conv
    hl, pl, h0 = _rank_heads(cfg, par)
    di = hl * pl
    xm = par.to_model(x)
    zx = xm @ p["in_zx"]
    z, xs = zx[..., :di], zx[..., di:]
    # in_dt whole: every head's dt_raw from the input before to_model,
    # through to_model (each rank's gradient covers its channels only),
    # then the rank's heads
    dt_raw = (xm @ p["in_dt"] if h0 is None else
              par.to_model(x @ p["in_dt"])[..., h0:h0 + hl].contiguous())
    A_log, D, dt_bias = _rank_vectors(cfg, p, par, h0)
    bc = x @ p["in_bc"]
    pre = torch.cat([xs, bc], dim=-1)
    conv_state = (pre[:, s - (w - 1):] if s >= w - 1
                  else F.pad(pre, (0, 0, w - 1 - s, 0)))
    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc = par.to_model(_causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    y, state = dispatch.ssd(xs.reshape(b, s, hl, pl).contiguous(), dt_raw,
                            A_log, bc[..., :n].contiguous(),
                            bc[..., n:].contiguous(), D, dt_bias)
    y = gated_rms_norm_sharded(y.reshape(b, s, di), z, p["norm"],
                               cfg.norm_eps, cfg.d_inner, par)
    return y @ p["out_proj"], {"conv": conv_state, "ssd": state.float()}


def _conv_sharded(cfg: ModelConfig, conv: torch.Tensor) -> bool:
    """Whether a conv window (b, w - 1, ch or ch/t) holds a ch/t slice
    (``sharding.enforce_divisibility`` keeps it whole when t does not
    divide ch)."""
    return conv.shape[-1] != cfg.d_inner + 2 * cfg.ssm_state


def conv_window_shard(cfg: ModelConfig, raw: torch.Tensor,
                      par: ModelParallel) -> torch.Tensor:
    """The spec's shard of the prefill's conv window from the rank's own
    pre-conv rows ``raw`` (b, w - 1, di_l + 2n) = [x of its channels | B |
    C] (``_forward_rank``): x gathered over the model axis into d_inner's
    order, then the rank's contiguous ch/t channels of [x | B | C] (all of
    them when t does not divide ch), in storage of their own."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    dil = raw.shape[-1] - 2 * cfg.ssm_state
    whole = torch.cat([_gather_channels(cfg, raw[..., :dil], par),
                       raw[..., dil:]], dim=-1)
    if ch % par.t:
        return whole
    w = ch // par.t
    return whole[..., par.model_idx * w:(par.model_idx + 1) * w].contiguous()


def _gather_state(cfg: ModelConfig, state: torch.Tensor,
                  par: ModelParallel) -> torch.Tensor:
    """The whole SSD state (b, h, p, n) from every rank's (b, h_l, p_l, n)
    (one all-gather over the model axis): rank r's slice lies at its
    group's heads and its share of their channels."""
    b, hl, pl, n = state.shape
    g, q = sh.ssm_split(cfg, par.t)[:2]
    got = par.gather_model(state, 0).view(g, q, b, hl, pl, n)
    return got.permute(2, 0, 3, 1, 4, 5).reshape(
        b, cfg.n_ssm_heads, cfg.ssm_head_dim, n)


def ssd_state_shard(cfg: ModelConfig, state: torch.Tensor,
                    par: ModelParallel) -> torch.Tensor:
    """The spec's shard of the prefill's SSD state from the rank's own
    (b, h_l, p_l, n) (``_forward_rank``): itself when the model axis
    divides the heads, else the whole state (``sharding.cache_specs``
    keeps it whole, as in the JAX package)."""
    if _rank_heads(cfg, par)[2] is None:
        return state
    return _gather_state(cfg, state, par)


def c_dot_state(C: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """y_ssd = C . state over the state width N, float32.  C: (b, n); state:
    (b, h, p, n) float32.  Returns (b, h, p).

    An elementwise product and a sum over the last axis, not a batched
    matrix product: the reduction walks each output's N values the same
    way whatever the batch, so a row alone gives the same bits as in a
    batch of 8 (a cuBLAS batched product picks its summation by shape).
    The continuous batchers rely on that to match per-request greedy."""
    return (C.float()[:, None, None, :] * state).sum(dim=-1)


def mamba2_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor],
                  par: Optional[ModelParallel] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x: (b, 1, d); cache: conv (b, w - 1, ch), ssd
    (b, h, p, n) float32.  Returns (out (b, 1, d), the new cache in fresh
    tensors).  With ``par`` (one rank's heads and cache shards, x the
    replicated input) see ``_decode_rank``."""
    if par is not None:
        return _decode_rank(cfg, p, x, cache, par)
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z, xBC_new, dt_raw = _project(cfg, p, x)                   # (b, 1, *)
    window = torch.cat([cache["conv"], xBC_new], dim=1)        # (b, w, ch)
    conv_w, conv_b = _conv_params(p)
    conv_out = torch.sum(window * conv_w[None], dim=1, keepdim=True)
    xBC = F.silu((conv_out + conv_b).float()).to(x.dtype)
    xs = xBC[..., :di].reshape(b, h, hp)
    B = xBC[:, 0, di:di + n]                                   # (b, n)
    C = xBC[:, 0, di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])       # (b, h)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                # (b, h)
    state = cache["ssd"] * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, B.float(), xs.float())
    y = c_dot_state(C, state) + p["D"][None, :, None] * xs.float()
    y = gated_rms_norm(y.reshape(b, 1, di).to(x.dtype), z, p["norm"],
                       cfg.norm_eps)
    return y @ p["out_proj"], {"conv": window[:, 1:], "ssd": state}


def _decode_rank(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], par: ModelParallel
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``mamba2_decode`` on this rank's heads and channels
    (``sharding.ssm_split``): one all-gather over the model axis brings
    the cached window's ch/t slices (w - 1 rows) and the new row's x
    channels of every rank; the conv runs on the rank's x channels and the
    replicated B|C of the whole window, the state update on its heads'
    channels, the gated norm over every rank's channels
    (``gated_rms_norm_sharded``), and ``out`` is its rows of
    ``out_proj``'s share, which the caller sums over the model axis.  The
    new window keeps the rank's ch/t slice.  When the model axis does not
    divide the heads the cache holds the whole SSD state, as the spec
    says: the rank updates its slice of it and one more all-gather
    (``_gather_state``) returns the whole."""
    b = x.shape[0]
    n, di = cfg.ssm_state, cfg.d_inner
    hl, pl, h0 = _rank_heads(cfg, par)
    dil = hl * pl
    zx = x @ p["in_zx"]
    z, x_new = zx[..., :dil], zx[..., dil:]                    # (b, 1, di_l)
    dt_raw = x @ p["in_dt"]
    if h0 is not None:
        dt_raw = dt_raw[..., h0:h0 + hl]
    bc_new = x @ p["in_bc"]                                    # (b, 1, 2n)
    conv = cache["conv"]
    rows, sharded = conv.shape[1], _conv_sharded(cfg, conv)
    if sharded:
        sent = torch.cat([conv.reshape(b, -1), x_new.reshape(b, -1)], dim=1)
        got = par.gather_model(sent, 1).view(b, par.t, -1)
        cw = conv.shape[-1]
        old = got[..., :rows * cw].reshape(b, par.t, rows, cw)
        old = old.transpose(1, 2).reshape(b, rows, par.t * cw)
        x_all = got[..., rows * cw:].reshape(b, 1, di)
        if h0 is not None:
            x_all = sh.ssm_natural_order(x_all, cfg.n_ssm_heads,
                                         cfg.ssm_head_dim, par.t)
    else:
        old, x_all = conv, _gather_channels(cfg, x_new, par)
    window = torch.cat([old, torch.cat([x_all, bc_new], dim=-1)], dim=1)
    if h0 is None:                     # the rank's heads: contiguous
        lo = par.model_idx * dil
        x_win = window[..., lo:lo + dil]
    else:
        x_win = sh.ssm_rank_channels(window[..., :di], cfg.n_ssm_heads,
                                     cfg.ssm_head_dim, par.t, par.model_idx)
    mine = torch.cat([x_win, window[..., di:]], dim=-1)
    conv_w = torch.cat([p["conv_x_w"], p["conv_bc_w"]], dim=1)
    conv_b = torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=0)
    conv_out = torch.sum(mine * conv_w[None], dim=1, keepdim=True)
    xBC = F.silu((conv_out + conv_b).float()).to(x.dtype)
    xs = xBC[..., :dil].reshape(b, hl, pl)
    B = xBC[:, 0, dil:dil + n]
    C = xBC[:, 0, dil + n:]
    A_log, D, dt_bias = _rank_vectors(cfg, p, par, h0)
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias)
    dA = torch.exp(dt * -torch.exp(A_log))
    old_state = cache["ssd"]
    if h0 is not None:
        c0 = (par.model_idx % sh.ssm_split(cfg, par.t)[1]) * pl
        old_state = old_state[:, h0:h0 + hl, c0:c0 + pl]
    state = old_state * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, B.float(), xs.float())
    y = c_dot_state(C, state) + D[None, :, None] * xs.float()
    y = gated_rms_norm_sharded(y.reshape(b, 1, dil).to(x.dtype), z,
                               p["norm"], cfg.norm_eps, di, par)
    new = window[:, 1:]
    if sharded:
        cw = conv.shape[-1]
        new = new[..., par.model_idx * cw:(par.model_idx + 1) * cw]
    if h0 is not None:
        state = _gather_state(cfg, state, par)
    return y @ p["out_proj"], {"conv": new, "ssd": state}
