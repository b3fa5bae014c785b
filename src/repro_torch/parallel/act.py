"""Logical activation-sharding annotations (the JAX package's
``repro/parallel/act.py``).

Model and step code name an activation's dims logically -- ``batch``,
``heads``, ``seq``, ``experts``, ``vocab``, ... -- and the active context
(set by the sharded train step) resolves them to mesh axes for the current
(cfg, mesh), dropping axes that do not divide the dim.  The JAX package
hands the result to GSPMD as a sharding constraint.  The port has no GSPMD:
every rank computes on plain local tensors, so ``constrain`` checks that a
local tensor has the shape its logical shape takes under the resolved
sharding, and raises otherwise.  With no context active it is a no-op.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import sharding as sh

_CTX = threading.local()


def resolve(mesh, cfg) -> Dict[Optional[str], Any]:
    """{logical dim: mesh axis, tuple of axes or None} for (cfg, mesh)."""
    tp = sh.axis_sizes(mesh).get("model", 1)
    heads_ok = sh.attn_head_sharded(cfg, tp)
    return {
        "batch": (tuple(sh.data_axes(mesh)) or None),
        "heads": "model" if heads_ok else None,
        # context parallelism: when head counts do not divide the model
        # axis, attention activations shard the sequence dim instead
        "seq": None if heads_ok else "model",
        "head_dim": None,
        "experts": "model" if sh.expert_sharded(cfg, tp) else None,
        "expert_ffn": None if sh.expert_sharded(cfg, tp) else "model",
        # MoE dispatch slots: capacity over the data axes
        "capacity": (tuple(sh.data_axes(mesh)) or None),
        "ffn": "model",
        "inner": "model",
        "heads_inner": ("model" if cfg.ssm_state
                        and cfg.n_ssm_heads % tp == 0 else None),
        "vocab": "model" if cfg.vocab_size % tp == 0 else None,
        "model_dim": None,
        None: None,
    }


@contextmanager
def activation_sharding(mesh, cfg):
    prev = getattr(_CTX, "ctx", None)
    _CTX.ctx = (sh.axis_sizes(mesh), resolve(mesh, cfg))
    try:
        yield
    finally:
        _CTX.ctx = prev


def resolved_spec(shape: Sequence[int], dims: Sequence[Optional[str]],
                  sizes: Dict[str, int], resolved: Dict) -> Tuple[Any, ...]:
    """The spec of an activation of logical ``shape`` whose dims are named
    ``dims`` (the dims past them unnamed): each name's axes, dropped where
    they do not divide the dim (a one-axis tuple becomes the axis)."""
    entries = []
    dims = tuple(dims) + (None,) * (len(shape) - len(dims))
    for dim_size, name in zip(shape, dims):
        ax = resolved.get(name)
        if ax is not None:
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            if dim_size % n != 0:
                ax = None
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]
        entries.append(ax)
    return tuple(entries)


def constrain(x: torch.Tensor, shape: Sequence[int], *dims) -> torch.Tensor:
    """x, after checking that its (local) shape is the shard of logical
    ``shape`` under the active context's resolution of ``dims``.  Raises
    ValueError otherwise; no-op with no context active."""
    ctx = getattr(_CTX, "ctx", None)
    if ctx is None:
        return x
    sizes, resolved = ctx
    spec = resolved_spec(shape, dims, sizes, resolved)
    want = tuple(n // sh._axis_size(sizes, ax) for n, ax in zip(shape, spec))
    if tuple(x.shape) != want:
        raise ValueError(f"activation {tuple(x.shape)} is not the shard of "
                         f"{tuple(shape)} under {spec} ({dims})")
    return x
