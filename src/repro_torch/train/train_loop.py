"""The training step: microbatch gradient accumulation (per-block remat
inside the forward) and mixed-precision Adam, on one device or as one rank
of a (d, t) plan over a ("data", "model") or ("pod", "data", "model") mesh
at ZeRO 0, 1 or 3 (d = pod x data).

With no mesh (or a 1 x 1 one) the step holds the whole state and runs as
it always has.  On a larger mesh each rank holds its shards of the state
(``state_specs``: the params under ``param_specs(zero_data = zero >= 3)``,
the fp32 master, m and v under ``param_specs(zero_data = zero >= 1)``) and
runs the JAX package's sharded step (``repro/train/train_loop.py:61-129``)
with explicit collectives (``parallel.collectives``) where the JAX package
leaves them to GSPMD: the batch splits over the data axes; each
microbatch's bf16 gradients are summed over the data axes into the fp32
accumulator in the optimizer's placement (reduce-scattered at ZeRO >= 1,
all-reduced at ZeRO 0); Adam runs on each rank's local shards with the
global grad norm; the params return to their placement (all-gathered over
data at ZeRO 1).  When the head shards the vocabulary the logits stay each
model rank's V/t columns and the loss is their vocabulary-parallel
cross-entropy.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels import dispatch
from repro_torch.models import cross_entropy, forward, init_params, param_shapes
from repro_torch.models.transformer import grad_sinks
from repro_torch.parallel import act
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (check_sharded_supported,
                                           n_data_shards)
from repro_torch.train.optimizer import (adam_update, init_opt_state, lr_at,
                                         tree_leaves, tree_map, tree_unflatten)

AUX_WEIGHT = 0.01
#: called with the microbatch's index after each microbatch of a step's
#: gradient accumulation (``launch.dryrun.trace_train`` reads its counts
#: there); None: nothing is called
MICRO_DONE: Optional[Callable[[int], None]] = None

Batch = Dict[str, torch.Tensor]

def resolve_microbatches(tc: TrainConfig, global_batch: int, mesh=None) -> int:
    """Number of grad-accumulation steps (one data shard without a mesh)."""
    nd = n_data_shards(mesh) if mesh is not None else 1
    per_shard = max(global_batch // max(nd, 1), 1)
    mb = min(tc.microbatch or 1, per_shard)
    return max(per_shard // mb, 1)


def make_train_state(cfg: ModelConfig, tc: TrainConfig, device="cuda"
                     ) -> Dict[str, Any]:
    """bf16 params drawn from ``tc.seed``, fp32 optimizer state, step 0."""
    params = init_params(cfg, tc.seed, device=device)
    return {"params": params, "opt": init_opt_state(params), "step": 0}


def state_specs(cfg: ModelConfig, tc: TrainConfig, mesh, state_shape: Any
                ) -> Dict[str, Any]:
    """Spec tree for the train state (``state_shape``: the state, or its
    params, or ``param_shapes(cfg)``)."""
    params = state_shape.get("params", state_shape)
    p_spec = sh.param_specs(cfg, params, mesh, zero_data=tc.zero >= 3)
    o_spec = sh.param_specs(cfg, params, mesh, zero_data=tc.zero >= 1)
    return {"params": p_spec,
            "opt": {"master": o_spec, "m": o_spec, "v": o_spec},
            "step": ()}


def make_local_state(cfg: ModelConfig, tc: TrainConfig, mesh, device="cuda",
                     whole_leaves: bool = True) -> Dict[str, Any]:
    """This rank's shards of ``make_train_state(cfg, tc)``, built one leaf
    at a time: each leaf is drawn whole (the same draws), cut to its
    param and optimizer specs and dropped, so the whole state is never
    held.  ``whole_leaves=False`` draws each params shard at its own shape
    instead (``init_params(local=)``: no whole leaf is ever held, the
    values are not the one-device state's) and cuts the optimizer shard
    from it -- for a rank whose whole leaves would not fit its card."""
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    coords = col.mesh_coords(mesh)
    master: Dict[str, Any] = {}

    def spec_at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def take(path, leaf):
        p_spec = spec_at(specs["params"], path)
        o_spec = spec_at(specs["opt"]["master"], path)
        node = master
        for k in path[:-1]:
            node = node.setdefault(k, {})
        name = path[-1]
        if whole_leaves:
            node[name] = col.shard_leaf(leaf, o_spec, mesh, coords,
                                        dtype=torch.float32, name=name,
                                        ssm_heads=cfg.n_ssm_heads)
            return col.shard_leaf(leaf, p_spec, mesh, coords, name=name,
                                  ssm_heads=cfg.n_ssm_heads)
        # the optimizer shard of the params shard: its data split only
        rel = tuple(o if o != p else None for p, o in zip(p_spec, o_spec))
        node[name] = col.shard_leaf(leaf, rel, mesh, coords,
                                    dtype=torch.float32)
        return leaf

    local = None if whole_leaves else (lambda path, shape: col.local_shape(
        shape, spec_at(specs["params"], path), mesh))
    params = init_params(cfg, tc.seed, device=device, take=take, local=local)
    return {"params": params,
            "opt": {"master": master, "m": tree_map(torch.zeros_like, master),
                    "v": tree_map(torch.zeros_like, master)},
            "step": 0}


def accumulate_grads(cfg: ModelConfig, tc: TrainConfig, params: Dict[str, Any],
                     batch: Batch, n_micro: int
                     ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Mean fp32 gradients over ``n_micro`` microbatches and the mean
    cross-entropy.  Each microbatch differentiates ce + AUX_WEIGHT * aux,
    aux being the MoE load-balance loss summed over the layers (0 without
    MoE), as the JAX step does.  Marks the params as requiring grad.  Each
    microbatch's grads (in the params' dtype) are added into the fp32 sum,
    as the JAX step casts each microbatch's grads to fp32 before summing:
    a stacked block leaf's by its layers' views in the backward
    (``transformer.grad_sinks``), every other leaf's after it, its
    gradient then cleared."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    mb = batch["tokens"].shape[0] // n_micro
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    with grad_sinks(zip(leaves, acc)) as sunk:
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
                if id(p) not in sunk:
                    a.add_(p.grad)
                    p.grad = None
            loss_sum = loss_sum + ce.detach()
            if MICRO_DONE is not None:
                MICRO_DONE(i)
    for a in acc:
        a.div_(n_micro)
    return tree_unflatten(params, acc), loss_sum / n_micro


def build_train_step(cfg: ModelConfig, tc: TrainConfig, global_batch: int,
                     seq_len: int, mesh=None) -> Tuple[Callable, int]:
    """Returns (step, n_micro); step(state, batch) -> (state, metrics) with
    metrics {"loss", "grad_norm"} as 0-d tensors.  The state is updated in
    place and returned.  batch: tokens and labels, (global_batch, seq_len)
    integer tensors on the state's device; for a VLM config tokens hold
    seq_len - num_modal_tokens text positions, and modal_embeds
    (global_batch, num_modal_tokens, d) come before them.

    With a mesh of more than one device, every rank passes its own rows of
    the global batch (``step.rows``, the global row indices, in microbatch
    order) and its own shards of the state (``make_local_state``); see
    ``build_sharded_step``.  On one device ``step.rows`` is every row."""
    if mesh is not None and math.prod(sh.axis_sizes(mesh).values()) > 1:
        return build_sharded_step(cfg, tc, global_batch, seq_len, mesh)
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

    step.rows = list(range(global_batch))
    return step, n_micro


# ------------------------------------------------------- the sharded step --

def build_sharded_step(cfg: ModelConfig, tc: TrainConfig, global_batch: int,
                       seq_len: int, mesh) -> Tuple[Callable, int]:
    """One rank's step of the (d, t) plan ``mesh`` (a DeviceMesh with axes
    ("data", "model") or ("pod", "data", "model") over the process group
    that is up; d counts the pod and data axes together).

    Each rank is fed only its rows of the global batch, ``step.rows``
    (``sharding.data_rows``): its microbatch i holds global rows
    i * mb * d + r * mb + [0, mb) for its index r along the data axes,
    pod-major (the JAX package's reshape of the batch into microbatches
    sharded over ("pod", "data")), and is rows i * mb + [0, mb) of what
    it is fed.  A batch of any other row count raises ValueError.
    Each rank differentiates the mean cross-entropy of its rows; the
    gradients are summed over the data axes and divided by n_micro * d,
    the mean over the global batch.
    ``step.accumulate(params, batch)`` returns those fp32 gradients (this
    rank's optimizer shards, in the params' leaf order) and the mean loss
    without updating anything; ``step.global_norm(grads)`` their norm over
    the mesh, the step's ``grad_norm``."""
    check_sharded_supported(cfg, tc, mesh)
    nd = n_data_shards(mesh)
    n_micro = resolve_microbatches(tc, global_batch, mesh)
    if global_batch % (n_micro * nd):
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{n_micro} microbatches on {nd} data shards")
    mb = global_batch // (n_micro * nd)
    data_group, _, r = col.data_group(mesh)
    rows = sh.data_rows(global_batch, n_micro, mesh, r)
    text = seq_len - cfg.num_modal_tokens
    shapes = param_shapes(cfg)
    full_shapes = tree_leaves(shapes)
    specs = state_specs(cfg, tc, mesh, shapes)
    p_specs = tree_leaves(specs["params"])
    o_specs = tree_leaves(specs["opt"]["master"])
    model_specs = sh.param_specs(cfg, shapes, mesh)
    sizes = sh.axis_sizes(mesh)
    model_group = mesh.get_group("model") if sizes.get("model", 1) > 1 \
        else None
    par = col.ModelParallel(
        mesh, model_specs["embed"], model_specs.get("lm_head"),
        gather_dims=(tree_map(col.data_dim, specs["params"])
                     if tc.zero >= 3 and nd > 1 else None),
        attn_head_sharded=sh.attn_head_sharded(cfg, sizes.get("model", 1)))
    # how each leaf's gradient reaches the optimizer's placement: already
    # summed over data by the ZeRO-3 gather's backward, reduce-scattered
    # over data along the optimizer spec's data dim, or all-reduced
    reduce = []
    for ps, os_ in zip(p_specs, o_specs):
        if nd == 1 or col.data_dim(ps) is not None:
            reduce.append(("none", None))
        elif col.data_dim(os_) is not None:
            reduce.append(("scatter", col.data_dim(os_)))
        else:
            reduce.append(("all_reduce", None))
    # each leaf's copies over the mesh (a replicated leaf's gradient is on
    # every rank of the axes it does not use), for the global norm
    copies = [math.prod(n for a, n in sizes.items()
                        if a not in col.spec_axes(os_)) for os_ in o_specs]

    def accumulate(params: Dict[str, Any], batch: Batch):
        if tuple(batch["tokens"].shape) != (len(rows), text):
            raise ValueError(
                f"data rank {r} of {nd} takes its {len(rows)} rows of the "
                f"global batch {global_batch} (step.rows), each of {text} "
                f"text positions; fed {tuple(batch['tokens'].shape)}")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        acc = [torch.zeros(col.local_shape(shape, os_, mesh),
                           dtype=torch.float32, device=p.device)
               for p, shape, os_ in zip(leaves, full_shapes, o_specs)]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(n_micro):
            lo = i * mb
            micro = {k: v[lo:lo + mb] for k, v in batch.items()}
            act.constrain(micro["tokens"], (mb * nd, text), "batch", None)
            inputs = {k: micro[k] for k in ("tokens", "modal_embeds")
                      if k in micro}
            logits, _, aux = forward(cfg, params, inputs,
                                     remat=tc.remat != "none", want_aux=True,
                                     par=par)
            # the JAX package's ("batch", None, "vocab"): V/t columns a
            # model rank when t divides V
            act.constrain(logits, (mb * nd, seq_len, cfg.vocab_size),
                          "batch", None, "vocab")
            ce = par.loss(logits[:, :-1], micro["labels"][:, 1:])
            (ce + AUX_WEIGHT * aux).backward()
            for a, p, (how, dim) in zip(acc, leaves, reduce):
                g, p.grad = p.grad, None
                if how == "scatter":
                    g = col.reduce_scatter(g, dim, data_group, nd)
                elif how == "all_reduce":
                    col.all_reduce(g, data_group)
                a.add_(g)
                del g
            loss_sum = loss_sum + ce.detach()
            if MICRO_DONE is not None:
                MICRO_DONE(i)
        for a in acc:
            a.div_(n_micro * nd)
        loss = loss_sum / n_micro
        if nd > 1:
            col.all_reduce(loss, data_group)
            loss = loss / nd
        return acc, loss

    def global_norm(acc: List[torch.Tensor]) -> torch.Tensor:
        sq = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for g, n in zip(acc, copies):
            sq = sq + torch.sum(torch.square(g)) / n
        for group in (data_group, model_group):
            if group is not None:
                col.all_reduce(sq, group)
        return torch.sqrt(sq)

    @torch.no_grad()
    def update(state: Dict[str, Any], acc: List[torch.Tensor]) -> None:
        step_i = state["step"]
        lr = lr_at(tc, step_i)
        tt = np.float32(step_i) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(tc.beta1) ** tt)
        c2 = float(np.float32(1.0) - np.float32(tc.beta2) ** tt)
        opt = state["opt"]
        for g, m, v, mp, p, ps, os_ in zip(
                acc, tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                tree_leaves(opt["master"]), tree_leaves(state["params"]),
                p_specs, o_specs):
            wd = tc.weight_decay if mp.ndim >= 2 else 0.0
            kw = dict(lr=lr, beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
                      wd=wd, c1=c1, c2=c2)
            if ps == os_:
                dispatch.adam_update_leaf(g, m, v, mp, p, **kw)
                continue
            # ZeRO 1: the new params of this rank's optimizer shard, then
            # gathered back to the params' placement
            shard = torch.empty(mp.shape, dtype=p.dtype, device=p.device)
            dispatch.adam_update_leaf(g, m, v, mp, shard, **kw)
            p.copy_(col.all_gather(shard, col.data_dim(os_), data_group, nd))
            del shard

    def step(state: Dict[str, Any], batch: Batch):
        with act.activation_sharding(mesh, cfg):
            acc, loss = accumulate(state["params"], batch)
        gnorm = global_norm(acc)
        update(state, acc)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    step.accumulate = accumulate
    step.global_norm = global_norm
    step.rows = rows
    return step, n_micro
