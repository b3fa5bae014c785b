"""Mixture-of-Experts FFN with row-local, sort-based capacity dispatch (the
JAX package's ``models/moe.py``).

Routing, sort and pack happen independently per sequence row (the batch
dim): each row has its own capacity of C slots per expert, so a row's
result does not depend on the rows beside it.  Expert weights carry a
leading E axis and the expert products are batched matrix products over
it; their FLOPs are the active ones (top_k x tokens x d x f), plus the
empty slots of the capacity.

Leaves per layer: ``router`` (d, E) float32, ``w1``/``w3`` (E, d, f),
``w2`` (E, f, d) and, with shared experts, ``shared_w1``/``shared_w3``
(d, S*f) and ``shared_w2`` (S*f, d).

One rank of the sharded step (``par``) routes and dispatches every row
as one device does, on the replicated input, then runs its own part on
the model axis: its E/t experts' slots when t divides E (expert
parallel), else every expert's slots on its f/t columns (ffn-sharded
experts), and its S*f/t columns of the shared experts; the combine reads
zeros for other ranks' slots and one all-reduce sums the partial outputs.
The load-balance statistics are averaged over the data axis, so the aux
loss is the global microbatch's, as in the JAX step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act, mlp
from repro_torch.parallel.collectives import ModelParallel

CAPACITY_FACTOR = 1.25


def moe_capacity(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float = CAPACITY_FACTOR) -> int:
    c = int(math.ceil(tokens * top_k * capacity_factor / num_experts))
    return max(8, -(-c // 8) * 8)                      # multiple of 8


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    shapes = {"router": (d, E), "w1": (E, d, f), "w2": (E, f, d)}
    if cfg.mlp_variant == "swiglu":
        shapes["w3"] = (E, d, f)
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        shapes["shared_w1"] = (d, fs)
        shapes["shared_w2"] = (fs, d)
        if cfg.mlp_variant == "swiglu":
            shapes["shared_w3"] = (d, fs)
    return shapes


def _expert_ffn(cfg: ModelConfig, p: dict, xg: torch.Tensor) -> torch.Tensor:
    """xg: (b, E, C, d) -> (b, E, C, d), one batched product per weight
    with the experts as the batch."""
    b, E, C, d = xg.shape
    xe = xg.transpose(0, 1).reshape(E, b * C, d)
    h = act(cfg.mlp_variant, torch.bmm(xe, p["w1"]))
    if cfg.mlp_variant == "swiglu":
        # the pre-activation is freed before the second product, and with no
        # graph to record the gate multiplies in place: at a 32,768-token
        # prefill of jamba each (E, C, f) tensor is 4 GB
        g = torch.bmm(xe, p["w3"])
        h = g.mul_(h) if not torch.is_grad_enabled() else h * g
    return torch.bmm(h, p["w2"]).view(E, b, C, d).transpose(0, 1)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
            par: Optional[ModelParallel] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (out (b, s, d) in x's dtype, aux loss fp32).
    With ``par``, x is the replicated (pre-``to_model``) input, ``p`` this
    rank's shards and ``out`` summed over the model axis."""
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = moe_capacity(s, E, k)

    logits = x.float() @ p["router"]                   # fp32 router
    probs = torch.softmax(logits, dim=-1)
    # the combine weights feed the rank's experts: their gradient is
    # summed over the model axis; the aux loss reads probs before that
    w, idx = torch.topk(probs if par is None else par.to_model(probs), k,
                        dim=-1)                        # (b, s, k)
    w = w / w.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))                        # (E,)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    if par is not None:                                # the global microbatch
        me, ce = par.mean_data(me), par.mean_data(ce)
    aux = E * torch.sum(me * ce)

    # row-local sort-based dispatch; the sort must be stable, as jnp.argsort
    # is, or slot order and capacity drops differ from the JAX package's
    sk = s * k
    flat_e = idx.reshape(b, sk)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_tok = order // k                            # token of each entry
    sorted_w = torch.gather(w.reshape(b, sk), 1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)           # (b, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(sk, device=x.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    dest = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)

    # every kept entry has its own slot; dropped entries all land in the
    # dummy column E*C, which is cut off; empty slots gather the zero token
    # row s
    slot_tok = torch.full((b, E * C + 1), s, dtype=torch.long,
                          device=x.device).scatter_(1, dest, sorted_tok)[:, :-1]
    slot_w = torch.zeros((b, E * C + 1), dtype=torch.float32,
                         device=x.device).scatter_(1, dest, sorted_w)[:, :-1]
    if par is not None:
        entry_dest = torch.empty_like(dest).scatter_(1, order, dest)
        return _moe_rank(cfg, p, par.to_model(x), slot_tok, slot_w,
                         entry_dest, C, par), aux
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xg = torch.gather(x_pad, 1, slot_tok[..., None].expand(b, E * C, d))
    yg = _expert_ffn(cfg, p, xg.view(b, E, C, d)).reshape(b, E * C, d)
    yg = yg * slot_w[..., None].to(yg.dtype)

    # combine: each token gathers its <= k slot outputs through the inverse
    # of dest (dropped entries read an appended zero row) and sums them in
    # fp32, then casts once.  No scatter-add: on CUDA it adds with atomics
    # in a run-dependent order.  JAX's bf16 scatter-add rounds after every
    # add, so bf16 results agree within tolerance, not bit for bit.
    entry_dest = torch.empty_like(dest).scatter_(1, order, dest)   # (b, s*k)
    y_pad = torch.cat([yg, yg.new_zeros(b, 1, d)], dim=1)
    picked = torch.gather(y_pad, 1, entry_dest[..., None].expand(b, sk, d))
    out = picked.view(b, s, k, d).float().sum(dim=2).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + mlp(cfg.mlp_variant, x, p["shared_w1"], p["shared_w2"],
                        p.get("shared_w3"))
    return out, aux


def _moe_rank(cfg: ModelConfig, p: dict, x: torch.Tensor,
              slot_tok: torch.Tensor, slot_w: torch.Tensor,
              entry_dest: torch.Tensor, C: int, par: ModelParallel
              ) -> torch.Tensor:
    """One model rank's routed and shared experts from the dispatch every
    rank computed, summed over the model axis: ``moe_ffn``'s gather,
    experts and combine restricted to the rank's slots (the one-device
    lines are left as they are, so its step's memory stays what was
    measured).  x: (b, s, d) after ``to_model``.  Expert-parallel (``w1``
    holds E/t experts): the rank's slots [lo, lo + E/t C); ffn-sharded:
    every slot on its f/t columns.  Entries in other ranks' slots read the
    appended zero row."""
    b, s, d = x.shape
    k = cfg.top_k
    n = p["w1"].shape[0] * C                           # the rank's slots
    lo = par.model_idx * n if p["w1"].shape[0] < cfg.num_experts else 0
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xg = torch.gather(x_pad, 1, slot_tok[:, lo:lo + n, None].expand(b, n, d))
    yg = _expert_ffn(cfg, p, xg.view(b, n // C, C, d)).reshape(b, n, d)
    yg = yg * slot_w[:, lo:lo + n, None].to(yg.dtype)
    local = entry_dest - lo
    local = torch.where((local >= 0) & (local < n), local, n)
    y_pad = torch.cat([yg, yg.new_zeros(b, 1, d)], dim=1)
    picked = torch.gather(y_pad, 1, local[..., None].expand(b, s * k, d))
    out = picked.view(b, s, k, d).float().sum(dim=2).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + mlp(cfg.mlp_variant, x, p["shared_w1"], p["shared_w2"],
                        p.get("shared_w3"))
    return par.from_model(out)
