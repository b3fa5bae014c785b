"""The single-device training step: microbatch gradient accumulation
(per-block remat inside the forward) and mixed-precision Adam.

The JAX package's step also shards the state and the activations over a
mesh; on one device there is one data shard and nothing to shard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import cross_entropy, forward, init_params
from repro_torch.train.optimizer import (adam_update, init_opt_state,
                                         tree_leaves, tree_unflatten)

AUX_WEIGHT = 0.01

Batch = Dict[str, torch.Tensor]


def resolve_microbatches(tc: TrainConfig, global_batch: int) -> int:
    """Number of grad-accumulation steps (one data shard)."""
    per_shard = max(global_batch, 1)
    mb = min(tc.microbatch or 1, per_shard)
    return max(per_shard // mb, 1)


def make_train_state(cfg: ModelConfig, tc: TrainConfig, device="cuda"
                     ) -> Dict[str, Any]:
    """bf16 params drawn from ``tc.seed``, fp32 optimizer state, step 0."""
    params = init_params(cfg, tc.seed, device=device)
    return {"params": params, "opt": init_opt_state(params), "step": 0}


def accumulate_grads(cfg: ModelConfig, tc: TrainConfig, params: Dict[str, Any],
                     batch: Batch, n_micro: int
                     ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Mean fp32 gradients over ``n_micro`` microbatches and the mean
    cross-entropy.  Each microbatch differentiates ce + AUX_WEIGHT * aux,
    aux being the MoE load-balance loss summed over the layers (0 without
    MoE), as the JAX step does.  Marks the params as requiring grad.  Each microbatch's
    grads (in the params' dtype) are added into the fp32 sum and cleared,
    as the JAX step casts each microbatch's grads to fp32 before summing."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    mb = batch["tokens"].shape[0] // n_micro
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        inputs = {k: micro[k] for k in ("tokens", "modal_embeds")
                  if k in micro}
        logits, _, aux = forward(cfg, params, inputs,
                                 remat=tc.remat != "none", want_aux=True)
        # labels cover the whole (modal + text) sequence
        ce = cross_entropy(logits[:, :-1], micro["labels"][:, 1:])
        (ce + AUX_WEIGHT * aux).backward()
        for a, p in zip(acc, leaves):
            a.add_(p.grad)
            p.grad = None
        loss_sum = loss_sum + ce.detach()
    for a in acc:
        a.div_(n_micro)
    return tree_unflatten(params, acc), loss_sum / n_micro


def build_train_step(cfg: ModelConfig, tc: TrainConfig, global_batch: int,
                     seq_len: int) -> Tuple[Callable, int]:
    """Returns (step, n_micro); step(state, batch) -> (state, metrics) with
    metrics {"loss", "grad_norm"} as 0-d tensors.  The state is updated in
    place and returned.  batch: tokens and labels, (global_batch, seq_len)
    integer tensors on the state's device; for a VLM config tokens hold
    seq_len - num_modal_tokens text positions, and modal_embeds
    (global_batch, num_modal_tokens, d) come before them."""
    n_micro = resolve_microbatches(tc, global_batch)
    if global_batch % n_micro:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{n_micro} microbatches")

    def step(state: Dict[str, Any], batch: Batch):
        want = (global_batch, seq_len - cfg.num_modal_tokens)
        if batch["tokens"].shape != want:
            raise ValueError(f"batch {tuple(batch['tokens'].shape)} != "
                             f"{want}")
        grads, loss = accumulate_grads(cfg, tc, state["params"], batch,
                                       n_micro)
        gnorm = adam_update(tc, state["params"], state["opt"], grads,
                            state["step"])
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step, n_micro
