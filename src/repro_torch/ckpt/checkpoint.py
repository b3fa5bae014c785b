"""Minimal checkpointing of nested dicts of tensors (single-host npz +
structure manifest): the JAX package's ``repro.ckpt.checkpoint`` for torch
state.

The layout is the reference's, so a checkpoint crosses between the two
packages both ways: ``ckpt_%08d.npz`` holds the leaves as ``leaf_{i}`` in
the order ``jax.tree_util.tree_flatten`` gives a nested dict (keys sorted
at every level), bfloat16 widened to float32 (npz has no bfloat16), and
``ckpt_%08d.json`` the tree's structure, the leaf count and the step.

This module also prices checkpoint traffic for the control plane:
``state_bytes``/``migration_seconds`` give the serialized training-state
size of a model and the save+restore cost of moving a job between
placements — the lifecycle engine charges elastic migrations and
preemption restarts with it.  jax/numpy are imported lazily so the
scheduler hot path can import these estimates without touching device
state.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

#: Per-parameter bytes in a serialized training checkpoint: the npz backend
#: widens bf16 params to fp32 (4) and stores both Adam moments in fp32 (8).
CKPT_BYTES_PER_PARAM = 12


def lora_state_bytes(cfg, rank: int) -> int:
    """Serialized adapter-state size of a LoRA finetune: the A+B factor
    pair on each of the four attention projections (``2 * d_model * rank``
    params per factor pair, 4 pairs per layer), with the same fp32
    params + both-Adam-moments widening as full checkpoints.  The frozen
    base model is never part of the checkpoint — re-materialized from the
    pretrained weights at restore — which is what makes finetune jobs
    near-free to preempt and migrate."""
    per_layer = 4 * 2 * cfg.d_model * rank
    return int(per_layer) * cfg.num_layers * CKPT_BYTES_PER_PARAM


def state_bytes(cfg, lora_rank: int = 0) -> int:
    """Serialized training-state size (params + optimizer moments) of a
    model config — what one checkpoint save/restore actually moves.
    ``lora_rank > 0`` prices a LoRA finetune (adapters only)."""
    if lora_rank > 0:
        return lora_state_bytes(cfg, lora_rank)
    from repro_torch.core.memory_model import analytic_param_count
    return int(analytic_param_count(cfg)) * CKPT_BYTES_PER_PARAM


def migration_seconds(cfg, bandwidth: float = 16 * 2 ** 30,
                      lora_rank: int = 0) -> float:
    """Checkpoint-restore migration cost: save the state at the old
    placement plus restore it at the new one, at ``bandwidth`` bytes/s."""
    return 2.0 * state_bytes(cfg, lora_rank=lora_rank) / float(bandwidth)


def checkpoint_seconds(cfg, bandwidth: float = 16 * 2 ** 30,
                      lora_rank: int = 0) -> float:
    """One durable periodic-checkpoint save: the serialized training state
    streamed out once at ``bandwidth`` bytes/s (the restore half is priced
    separately by ``migration_seconds`` when a restart happens).  This is
    the ``C`` of the Young–Daly interval ``sqrt(2*C*MTBF)`` — for LoRA
    finetunes it is near-free because only the adapters are saved."""
    return state_bytes(cfg, lora_rank=lora_rank) / float(bandwidth)


def kv_handoff_bytes(cfg, batch: int, cache_len: int) -> float:
    """KV/SSM-cache bytes one prefilled request batch occupies — what a
    prefill replica ships to a decode replica in disaggregated serving."""
    from repro_torch.core.memory_model import serve_bytes_split
    _, cache, _ = serve_bytes_split(cfg, batch, cache_len, 1, 1)
    return float(cache)


def kv_handoff_seconds(cfg, batch: int, cache_len: int,
                       bandwidth: float = 16 * 2 ** 30) -> float:
    """Priced prefill->decode KV-cache handoff: the same two-sided
    send + receive pattern as ``migration_seconds``, applied to the
    request's cache slice instead of the training state.  MARP charges
    this per request so a disaggregated plan never looks free."""
    return 2.0 * kv_handoff_bytes(cfg, batch, cache_len) / float(bandwidth)


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, keys sorted at every level: the leaf
    order of ``jax.tree_util.tree_flatten``."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_flatten(tree[key], f"{path}.{key}" if path else key))
    return out


def treedef_str(tree: Any) -> str:
    """The structure of a nested dict as the JAX package writes it into the
    manifest (``str`` of its ``PyTreeDef``)."""
    def walk(t):
        if not isinstance(t, dict):
            return "*"
        return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
    return f"PyTreeDef({walk(tree)})"


def save(path: str, step: int, tree: Dict[str, Any]) -> str:
    """Write the leaves of ``tree`` (a nested dict of tensors) at ``step``;
    returns the npz file's path.  The npz is written to a temporary name
    and renamed, so a reader never sees half a checkpoint."""
    import numpy as np
    import torch
    os.makedirs(path, exist_ok=True)
    leaves = [leaf for _, leaf in _flatten(tree)]
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:       # npz cannot store bf16: widen
            t = t.float()
        return t.numpy()

    arrs = {f"leaf_{i}": to_np(leaf) for i, leaf in enumerate(leaves)}
    np.savez(fname + ".tmp.npz", **arrs)
    os.replace(fname + ".tmp.npz", fname)
    with open(os.path.join(path, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump({"treedef": treedef_str(tree), "n_leaves": len(leaves),
                   "step": step}, f)
    return fname


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore(path: str, step: int, like: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint at ``step`` as a nested dict shaped like ``like``,
    each leaf in the dtype and on the device of ``like``'s leaf."""
    import numpy as np
    import torch
    data = np.load(os.path.join(path, f"ckpt_{step:08d}.npz"))
    n = len(_flatten(like))
    if n != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, the tree {n}")
    index = iter(range(n))

    def build(t: Any, where: str) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k], f"{where}.{k}" if where else k)
                    for k in sorted(t)}
        arr = data[f"leaf_{next(index)}"]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{where}: checkpoint shape {arr.shape} !="
                             f" {tuple(t.shape)}")
        return torch.from_numpy(arr).to(device=t.device, dtype=t.dtype)

    return build(like, "")
