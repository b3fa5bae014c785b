"""Mixed-precision Adam matching the paper's 20-byte/param accounting:
bf16 params (2) + bf16 grads (2, transient) + their fp32 sum over the
microbatches (4, transient) + fp32 master (4) + Adam m (4) + v (4).

The per-leaf update goes through ``repro_torch.kernels.dispatch``: the
hand-written fused kernel (one pass over the state) for CUDA tensors, the
plain PyTorch formulas for CPU tensors.  The JAX step donates its state and
returns new arrays; here the state is updated **in place**: m, v and master
are overwritten and the bf16 params are written into the model's own
tensors, so no step holds two copies of the state.

Leaves are visited in the JAX package's pytree order (dict keys sorted),
so the global grad norm sums them in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import dispatch

Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in sorted-key order (the JAX package's pytree order)."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: Tree, leaves: List[torch.Tensor]) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` in its leaf order."""
    it = iter(leaves)

    def build(t: Tree) -> Tree:
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(like)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def lr_at(tc: TrainConfig, step: int) -> float:
    """Linear warmup then cosine decay to 10%, in float32 as the JAX
    package computes it."""
    f = np.float32
    s = f(step)
    warm = np.minimum((s + f(1.0)) / f(max(tc.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(tc.warmup_steps))
                   / f(max(tc.steps - tc.warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(0.1) + f(0.45) * (f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(tc.learning_rate) * warm * cos)


def init_opt_state(params: Tree) -> Dict[str, Tree]:
    """fp32 master copy (fresh storage even for fp32 params: never aliased,
    since the update writes both) and zero m, v."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    return {"master": master, "m": tree_map(torch.zeros_like, master),
            "v": tree_map(torch.zeros_like, master)}


def global_norm(grads: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adam_update(tc: TrainConfig, params: Tree, opt: Dict[str, Tree],
                grads: Tree, step: int) -> torch.Tensor:
    """One Adam step, in place.  grads are fp32, already mean-reduced.
    Returns the global grad norm (reported, never clipped)."""
    lr = lr_at(tc, step)
    t = np.float32(step) + np.float32(1.0)
    c1 = float(np.float32(1.0) - np.float32(tc.beta1) ** t)
    c2 = float(np.float32(1.0) - np.float32(tc.beta2) ** t)
    gnorm = global_norm(grads)
    for g, m, v, mp, p in zip(tree_leaves(grads), tree_leaves(opt["m"]),
                              tree_leaves(opt["v"]),
                              tree_leaves(opt["master"]),
                              tree_leaves(params)):
        # decoupled weight decay on stacked leaves of ndim >= 2, the JAX
        # package's rule: the per-layer norms (nb, d) are decayed,
        # final_norm (d,) is not
        wd = tc.weight_decay if mp.ndim >= 2 else 0.0
        dispatch.adam_update_leaf(g, m, v, mp, p, lr=lr, beta1=tc.beta1,
                                  beta2=tc.beta2, eps=tc.eps, wd=wd, c1=c1,
                                  c2=c2)
    return gnorm
