"""RoPE and the attention layers, GQA and MLA: full-sequence (prefill)
attention and single-token decode over a ring cache.

Weights keep the JAX package's layouts -- GQA ``wq`` (d, H, hd),
``wk``/``wv`` (d, K, hd), ``wo`` (H, hd, d); MLA as in ``mla_param_shapes``
-- so parameters convert leaf for leaf.  The attention itself goes through
``repro_torch.kernels.dispatch``: the hand-written kernels for CUDA
tensors, the plain versions for CPU tensors.

Decode writes the new token's cache entries **in place** (the JAX
functions return a new cache): no decode step copies the cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import rms_norm
from repro_torch.parallel.act import constrain
from repro_torch.parallel.collectives import (ModelParallel,
                                              merge_decode_partials)

Pos = Union[int, torch.Tensor]


# ---------------------------------------------------------------- RoPE ------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,) or (..., seq).
    Split-half layout, computed in fp32 and cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    angles = positions[..., :, None].float() * freqs          # (..., s, d/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., s, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- GQA ------

def gqa_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
            "wo": (H, hd, d)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out_project(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    b, s, H, hd = o.shape
    return o.reshape(b, s, H * hd) @ wo.reshape(H * hd, -1)


def gqa_project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    return q, k, v


def gqa_attend_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     par: Optional[ModelParallel] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence (prefill) attention.  Returns (out, kv) where kv holds
    the k/v tensors for cache construction.

    With ``par`` (one rank of the sharded step; x after ``to_model``) the
    weights hold the rank's heads, or on the head_dim / seq fallback
    (``par.attn_head_sharded`` false) its head_dim columns
    (``_gqa_attend_seq``); either way ``out`` is the rank's partial
    output, which the caller sums over the model axis."""
    if par is not None and not par.attn_head_sharded:
        return _gqa_attend_seq(cfg, p, x, positions, par)
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    b, s = x.shape[:2]
    # one rank of the sharded step holds its heads (no-op on one device)
    constrain(q, (b, s, cfg.num_heads, cfg.head_dim), None, None, "heads",
              "head_dim")
    constrain(k, (b, s, cfg.num_kv_heads, cfg.head_dim), None, None,
              "heads", "head_dim")
    o = dispatch.attention(q, k, v, causal=True, window=cfg.sliding_window)
    return _out_project(o, p["wo"]), {"k": k, "v": v}


def _gqa_attend_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor, par: ModelParallel
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One rank of the head_dim / seq fallback (the JAX package's
    ``"seq"`` activation sharding): ``wq``/``wk``/``wv`` hold the rank's
    hd/t columns and ``wo`` its hd/t rows.  k and v are gathered whole
    over head_dim; q moves to the rank's s/t sequence rows with every
    column, and only then takes RoPE (the split-half rotation pairs column
    i with i + hd/2, so a head_dim shard cannot be rotated); the attention
    runs those rows against every key at query offset r s/t, and its output
    moves back to the rank's columns for ``wo``.  The cache entries are
    the rank's hd/t columns of the rotated k and v (the spec's shard), in
    storage of their own, so the gathered k and v do not outlive the
    layer."""
    b, s, _ = x.shape
    if s % par.t:
        raise ValueError(f"{cfg.name}: sequence {s} does not split over the "
                         f"model axis of {par.t} (the head_dim / seq "
                         f"fallback shards the sequence)")
    rows = s // par.t
    lo = par.model_idx * rows
    q = par.head_dim_to_seq(_project(x, p["wq"]))          # (b, s/t, H, hd)
    k = par.gather_model_sum(_project(x, p["wk"]), -1)     # (b, s, K, hd)
    v = par.gather_model_sum(_project(x, p["wv"]), -1)
    q = apply_rope(q, positions[..., lo:lo + rows], cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    constrain(q, (b, s, cfg.num_heads, cfg.head_dim), None, "seq", "heads",
              "head_dim")
    constrain(k, (b, s, cfg.num_kv_heads, cfg.head_dim), None, None,
              "heads", "head_dim")
    o = dispatch.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           q_offset=lo)
    w = p["wk"].shape[-1]
    cols = slice(par.model_idx * w, (par.model_idx + 1) * w)
    return (_out_project(par.seq_to_head_dim(o), p["wo"]),
            {"k": k[..., cols].contiguous(), "v": v[..., cols].contiguous()})


def ring_index(pos: Pos, S: int, b: int, device):
    """Rope positions, ring-buffer write slot and (b, S) validity mask of a
    decode step.

    ``pos`` is the absolute position of the incoming token: an int (every
    row at the same position) or a (b,) tensor of per-row positions.  Slot
    i holds absolute position i + S*floor((pos - i)/S); it is valid iff its
    age (slot - i) % S is at most min(pos, S-1), so the newest slot is
    always valid.  Returns (positions (1,) or (b, 1), slot int or (b,),
    valid (b, S) bool).
    """
    idx = torch.arange(S, device=device)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        posv = pos.to(device=device, dtype=torch.long)
        slot = posv % S
        age = (slot[:, None] - idx[None, :]) % S
        return posv[:, None], slot, age <= torch.clamp(posv[:, None], max=S - 1)
    pos = int(pos)
    slot = pos % S
    valid = ((slot - idx) % S) <= min(pos, S - 1)
    return (torch.tensor([pos], device=device), slot,
            valid.expand(b, S).contiguous())


def shard_ring(ring: tuple, lo: int, n: int) -> tuple:
    """``ring_index``'s ring for a rank holding slots [lo, lo + n) of the
    S: (positions, the write slot in the rank's cache -- an int, None when
    another rank holds it, or per row a (b,) tensor that is -1 on the rows
    another rank holds --, valid (b, n))."""
    positions, slot, valid = ring
    if isinstance(slot, torch.Tensor):
        local = slot - lo
        local = torch.where((local >= 0) & (local < n), local, -1)
    else:
        local = slot - lo if lo <= slot < lo + n else None
    return positions, local, valid[:, lo:lo + n].contiguous()


def _write_slot(t: torch.Tensor, slot, new: torch.Tensor) -> None:
    """t[row, slot] = new[row] for each row of a cache layer t (b, S, ...)
    at ``shard_ring``'s local slot (None: nothing; a -1 row: kept)."""
    if slot is None:
        return
    if not isinstance(slot, torch.Tensor):
        t[:, slot] = new
        return
    rows = torch.arange(t.shape[0], device=t.device)
    at = slot.clamp(min=0)
    keep = (slot < 0).view(-1, *([1] * (new.ndim - 1)))
    t[rows, at] = torch.where(keep, t[rows, at], new)


def gqa_attend_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], ring: tuple,
                      par: Optional[ModelParallel] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); cache: {'k', 'v'} of (b, S, K, hd); ring:
    ``ring_index(pos, S, b, device)`` for the incoming token's absolute
    position ``pos`` (the JAX function takes ``pos`` and derives it; every
    layer of a step shares it, so the port derives it once per step).

    The new k/v are written into ``cache`` in place; the returned cache is
    the same tensors.

    With ``par`` (one rank of a sharded decode): ``cache`` holds the
    rank's shard under ``sharding.cache_specs`` and ``ring`` is
    ``shard_ring``'s for its slots.  Head-sharded, the rank's H/t query
    heads decode against its K/t cache heads; on the head_dim / seq
    fallback see ``_gqa_decode_seq``.  When the data axes split the slots
    (``par.seq_split``) each rank decodes its own and the partial results
    merge over the data axes by their log-sum-exp.  ``out`` is the rank's
    partial output through its rows of ``wo``, which the caller sums over
    the model axis."""
    if par is not None and not par.attn_head_sharded:
        return _gqa_decode_seq(cfg, p, x, cache, ring, par)
    positions, slot, valid = ring
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    _write_slot(cache["k"], slot, k[:, 0])
    _write_slot(cache["v"], slot, v[:, 0])
    if par is None or not par.seq_split:
        o = dispatch.flash_decode(q, cache["k"], cache["v"], valid)
    else:
        o, lse = dispatch.flash_decode(q, cache["k"], cache["v"], valid,
                                       return_lse=True)
        o = merge_decode_partials(o, lse, par.data_group)[0].to(x.dtype)
    return _out_project(o, p["wo"]), cache


def _gqa_decode_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], ring: tuple,
                    par: ModelParallel
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of a rank on the head_dim / seq fallback: the
    weights hold its hd/t columns (``wo`` its rows) and the cache layer
    (b, S, K, hd/t) its columns of every slot.  The new token's q, k and
    v (one position) are gathered whole over head_dim in one all-gather
    and rotated; the rank's columns of k and v go to the ring slot.  The
    layer's cache then moves to S/t slots with every column
    (``par.head_dim_to_seq``; nothing requires grad, so no graph is
    recorded), ``flash_decode_gqa`` runs all H heads over
    them with their log-sum-exp, the t partial results merge over the
    model axis (and over the data axes when they split the slots), and
    the rank keeps its hd/t columns of the output for ``wo``.  Every rank
    decodes different slots: the kernel is on the path."""
    positions, slot, valid = ring
    H, K = p["wq"].shape[1], p["wk"].shape[1]
    w = p["wq"].shape[-1]
    cols = slice(par.model_idx * w, (par.model_idx + 1) * w)
    qkv = torch.cat([_project(x, p[n]) for n in ("wq", "wk", "wv")], dim=2)
    q, k, v = par.gather_model(qkv, -1).split([H, K, K], dim=2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    _write_slot(cache["k"], slot, k[:, 0, :, cols])
    _write_slot(cache["v"], slot, v[:, 0, :, cols])
    k_seq = par.head_dim_to_seq(cache["k"])
    v_seq = par.head_dim_to_seq(cache["v"])
    n = k_seq.shape[1]
    mine = valid[:, par.model_idx * n:(par.model_idx + 1) * n].contiguous()
    o, lse = dispatch.flash_decode(q, k_seq, v_seq, mine, return_lse=True)
    del k_seq, v_seq
    o, lse = merge_decode_partials(o, lse, par.model_group)
    if par.seq_split:
        o, lse = merge_decode_partials(o, lse, par.data_group)
    return _out_project(o[..., cols].to(x.dtype), p["wo"]), cache


# ----------------------------------------------------------------- MLA ------
# DeepSeek-V2 multi-head latent attention [arXiv:2405.04434].  The cache
# holds only the compressed latent c_kv (kv_lora_rank) and one shared RoPE
# key (qk_rope_head_dim) per position; decode absorbs W^UK into the query
# and W^UV into the output, so the per-head K/V are never built for it.

def mla_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, H = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq_a": (d, r_q), "q_ln": (r_q,), "wq_b": (r_q, H, dn + dr),
            "wkv_a": (d, r_kv + dr), "kv_ln": (r_kv,), "wk_b": (r_kv, H, dn),
            "wv_b": (r_kv, H, dv), "wo": (H, dv, d)}


def _mla_cq(cfg: ModelConfig, p: dict, x: torch.Tensor,
            par: Optional[ModelParallel] = None) -> torch.Tensor:
    """The normed query latent (b, s, r_q).  With ``par``: ``wq_a`` holds
    r_q/t columns, whose latent is gathered and normed whole on every rank
    and goes through ``to_model`` before ``wq_b``'s local shard (the
    gradient rule of ``parallel.collectives``)."""
    if par is None:
        return rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    return par.to_model(rms_norm(par.gather_model(par.to_model(x)
                                                  @ p["wq_a"], -1),
                                 p["q_ln"], cfg.norm_eps))


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor, par: Optional[ModelParallel] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (b, s, H, dn), q_rope (b, s, H, dr)); RoPE on the dr slice;
    with ``par`` of ``wq_b``'s local heads."""
    dn = cfg.qk_nope_head_dim
    q = _project(_mla_cq(cfg, p, x, par), p["wq_b"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (b, s, r), k_rope (b, s, dr)): the normed latent and the one
    RoPE key head all query heads share."""
    r_kv = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]                                # (b, s, r + dr)
    c_kv = rms_norm(kv[..., :r_kv], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, r_kv:], positions, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def mla_attend_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     par: Optional[ModelParallel] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence (prefill) MLA: per-head k/v from the latent, q and k
    concatenated to width dn + dr with the shared RoPE key broadcast over
    the heads, v zero-padded to that width so one attention call serves,
    and the output sliced back to dv.  Returns (out, {c_kv, k_rope}).

    With ``par`` (one rank of the sharded step; x the replicated,
    pre-``to_model`` input): the latent and the RoPE key are computed on
    every rank from x and go through ``to_model`` to ``wk_b``/``wv_b``'s
    local heads; ``out`` is the rank's heads' share through its rows of
    ``wo``, which the caller sums over the model axis; on the head_dim /
    seq fallback see ``_mla_attend_seq``."""
    if par is not None and not par.attn_head_sharded:
        return _mla_attend_seq(cfg, p, x, positions, par)
    b, s, _ = x.shape
    H = p["wq_b"].shape[1]                             # this rank's heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, positions, par)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kv_c, kv_r = c_kv, k_rope
    if par is not None:
        kv_c, kv_r = par.to_model(c_kv), par.to_model(k_rope)
    k_nope = _project(kv_c, p["wk_b"])
    v = _project(kv_c, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kv_r[:, :, None, :].expand(b, s, H, dr)], dim=-1)
    v = F.pad(v, (0, dn + dr - dv))
    o = dispatch.attention(q, k, v, causal=True,
                           softmax_scale=1.0 / math.sqrt(dn + dr))
    return (_out_project(o[..., :dv], p["wo"]),
            {"c_kv": c_kv, "k_rope": k_rope})


def _mla_attend_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor, par: ModelParallel
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One rank of MLA on the head_dim / seq fallback (the JAX package's
    ``"seq"`` activation sharding, as ``_gqa_attend_seq``): ``wq_b``,
    ``wk_b`` and ``wv_b`` hold the rank's (dn + dr)/t, dn/t and dv/t
    columns of every head and ``wo`` its dv/t rows.  q moves to the rank's
    s/t sequence rows with every column (``par.head_dim_to_seq``) and only
    then takes RoPE on its dr columns (a column shard cannot be rotated);
    k's dn and v's dv columns, projected from the latent every rank
    computes (through ``to_model``), are gathered whole
    (``gather_model_sum``), the shared RoPE key joins k on every rank, and
    the attention runs the rank's rows against every key at query offset
    r s/t; its output moves back to the rank's dv/t columns for ``wo``.
    The cache entries are the whole latent and RoPE key, replicated over
    the model axis as ``sharding.cache_specs`` has them."""
    b, s, _ = x.shape
    if s % par.t:
        raise ValueError(f"{cfg.name}: sequence {s} does not split over the "
                         f"model axis of {par.t} (the head_dim / seq "
                         f"fallback shards the sequence)")
    H = p["wq_b"].shape[1]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rows = s // par.t
    lo = par.model_idx * rows
    q = par.head_dim_to_seq(_project(_mla_cq(cfg, p, x, par), p["wq_b"]))
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:],
                                           positions[..., lo:lo + rows],
                                           cfg.rope_theta)], dim=-1)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kv_c, kv_r = par.to_model(c_kv), par.to_model(k_rope)
    k_nope = par.gather_model_sum(_project(kv_c, p["wk_b"]), -1)
    v = par.gather_model_sum(_project(kv_c, p["wv_b"]), -1)
    k = torch.cat([k_nope, kv_r[:, :, None, :].expand(b, s, H, dr)], dim=-1)
    v = F.pad(v, (0, dn + dr - dv))
    constrain(q, (b, s, H, dn + dr), None, "seq", "heads", "head_dim")
    o = dispatch.attention(q, k, v, causal=True, q_offset=lo,
                           softmax_scale=1.0 / math.sqrt(dn + dr))
    return (_out_project(par.seq_to_head_dim(o[..., :dv].contiguous()),
                         p["wo"]),
            {"c_kv": c_kv, "k_rope": k_rope})


def mla_attend_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], ring: tuple,
                      par: Optional[ModelParallel] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Matrix-absorbed MLA decode: scores and values in latent space.

    x: (b, 1, d); cache: {'c_kv' (b, S, r), 'k_rope' (b, S, dr)}; ring:
    ``ring_index(pos, S, b, device)`` as for ``gqa_attend_decode``.  The
    new latent and RoPE key are written into ``cache`` in place; the
    returned cache is the same tensors.

    With ``par`` (one rank of a sharded decode; x the replicated input):
    the latent cache is replicated over the model axis
    (``sharding.cache_specs``), every rank writes the new latent, and the
    rank's H/t heads go through its ``wq_b``, ``wk_b``, ``wv_b``, the
    kernel and its rows of ``wo``; the caller sums ``out`` over the model
    axis.  When the data axes split the slots (``par.seq_split``: ``ring``
    is ``shard_ring``'s, and only the slot's owner writes it) each rank
    decodes its own with their log-sum-exp and the partial results merge
    over the data axes; on the head_dim / seq fallback see
    ``_mla_decode_seq``."""
    if par is not None and not par.attn_head_sharded:
        return _mla_decode_seq(cfg, p, x, cache, ring, par)
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions, slot, valid = ring
    q_nope, q_rope = _mla_q(cfg, p, x, positions, par)
    c_new, kr_new = _mla_latent(cfg, p, x, positions)
    _write_slot(cache["c_kv"], slot, c_new[:, 0])
    _write_slot(cache["k_rope"], slot, kr_new[:, 0])
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], p["wk_b"])
    args = (q_lat.contiguous(), q_rope[:, 0].contiguous(), cache["c_kv"],
            cache["k_rope"], valid)
    if par is None or not par.seq_split:
        o_lat = dispatch.mla_flash_decode(*args, denom=math.sqrt(dn + dr))
    else:
        o_lat, lse = dispatch.mla_flash_decode(
            *args, denom=math.sqrt(dn + dr), return_lse=True)
        o_lat = merge_decode_partials(o_lat[:, None], lse,
                                      par.data_group)[0][:, 0].to(x.dtype)
    o = torch.einsum("bhr,rhd->bhd", o_lat, p["wv_b"])
    return _out_project(o[:, None], p["wo"]), cache


def _mla_decode_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], ring: tuple,
                    par: ModelParallel
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of a rank on MLA's head_dim / seq fallback: the
    weights hold its columns of every head (``_mla_attend_seq``) and the
    cache the whole latent, replicated over the model axis.  The new
    token's q is gathered whole over its columns (one position) and its
    RoPE columns rotated; the rank's dn/t columns of q_nope through its
    ``wk_b`` give a partial q_lat, summed over the model axis.  The rank
    then decodes its own S/t of the cache's slots (the valid mask cut to
    them: the kernel reads no other row, and nothing is copied) with their
    log-sum-exp, and the t partial results merge over the model axis (and
    over the data axes when they split the slots), so every rank reads
    S/t of the cache, where a rank with the whole q_lat and the whole
    cache would read it all; its ``wv_b`` and ``wo`` rows give its share of
    the output, which the caller sums over the model axis."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions, slot, valid = ring
    q = par.gather_model(_project(_mla_cq(cfg, p, x, par), p["wq_b"]), -1)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)[:, 0]
    c_new, kr_new = _mla_latent(cfg, p, x, positions)
    _write_slot(cache["c_kv"], slot, c_new[:, 0])
    _write_slot(cache["k_rope"], slot, kr_new[:, 0])
    w = p["wk_b"].shape[-1]
    cols = slice(par.model_idx * w, (par.model_idx + 1) * w)
    q_lat = par.from_model(torch.einsum("bhd,rhd->bhr", q[:, 0, :, cols],
                                        p["wk_b"]))
    n = -(-valid.shape[1] // par.t)
    mine = torch.zeros_like(valid)
    lo = par.model_idx * n
    mine[:, lo:lo + n] = valid[:, lo:lo + n]
    o_lat, lse = dispatch.mla_flash_decode(
        q_lat.contiguous(), q_rope.contiguous(), cache["c_kv"],
        cache["k_rope"], mine, denom=math.sqrt(dn + dr), return_lse=True)
    o_lat, lse = merge_decode_partials(o_lat[:, None], lse, par.model_group)
    if par.seq_split:
        o_lat, lse = merge_decode_partials(o_lat, lse, par.data_group)
    o = torch.einsum("bhr,rhd->bhd", o_lat[:, 0].to(x.dtype), p["wv_b"])
    return _out_project(o[:, None], p["wo"]), cache
