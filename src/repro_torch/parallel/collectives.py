"""The sharded step's communication, on plain local tensors.

The hand-written kernels take raw pointers, so every rank computes on
plain tensors holding its own shard, and the step moves data between
ranks with explicit collectives over the mesh's process groups (the JAX
package leaves this to GSPMD):

* the model axis (Megatron's tensor parallelism, dense family):
  ``ModelParallel.to_model`` before a column-sharded product (identity
  forward, gradient all-reduced), ``from_model`` after a row-sharded one
  (all-reduce forward, identity backward), ``gather_model`` for an
  activation sharded along a dim (all-gather forward, the rank's own slice
  backward), and the embedding and the output head under the embed's
  vocab-or-d_model rule;
* the data axis at ZeRO 3: each leaf is all-gathered before use and its
  gradient reduce-scattered back to the shard (``ModelParallel.gather_top``,
  ``gather_block``; the train step calls the latter inside each
  checkpointed block, so the backward gathers again instead of keeping
  the gathered weights).

``shard_leaf`` / ``gather_leaf`` cut a rank's shard out of a full leaf and
rebuild the full leaf from the shards.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as sh


def _gather_single(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # all_gather_into_tensor was renamed all_gather_single (same arguments)
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter_single(out: torch.Tensor, inp: torch.Tensor,
                           group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The n ranks' ``x`` concatenated along ``dim`` in rank order."""
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_single(out, x, group)
    return out if dim == 0 else torch.cat(out.chunk(n, 0), dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum of the n ranks' ``x``, chunk ``rank`` of it along ``dim``."""
    if n == 1:
        return x
    inp = x.contiguous() if dim == 0 else torch.cat(x.chunk(n, dim), 0)
    shape = list(x.shape)
    shape[dim] //= n
    out = x.new_empty(shape)
    _reduce_scatter_single(out, inp, group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.dim, ctx.n, ctx.idx = dim, n, idx
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.idx].contiguous(), None, None, \
            None, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis: this rank's index along it} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _axis_index(axis, sizes: Mapping[str, int], coords: Mapping[str, int]
                ) -> Tuple[int, int]:
    """(index, count) of a rank along a spec entry (an axis or a tuple)."""
    idx, n = 0, 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """A leaf's shard shape under ``spec``."""
    return tuple(d // sh._axis_size(mesh, ax) for d, ax in zip(shape, spec))


def shard_leaf(t: torch.Tensor, spec, mesh, coords: Mapping[str, int],
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's shard of the full leaf ``t`` (in ``dtype``, default its
    own) in fresh storage of its own, never a view that would keep the
    full leaf alive."""
    sizes = sh.axis_sizes(mesh)
    index = []
    for dim, ax in zip(t.shape, spec):
        if ax is None:
            index.append(slice(None))
            continue
        i, n = _axis_index(ax, sizes, coords)
        index.append(slice(i * dim // n, (i + 1) * dim // n))
    return t[tuple(index)].to(dtype or t.dtype, copy=True,
                              memory_format=torch.contiguous_format)


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's shard ``t`` (a collective over the
    mesh: every rank calls it)."""
    sizes = sh.axis_sizes(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):
            raise NotImplementedError(
                "leaves sharded over several data axes (the pod axis): "
                "ROADMAP.md queue 1 item 10")
        t = all_gather(t, dim, mesh.get_group(ax), sizes[ax])
    return t


def map_specs(fn, tree: Mapping[str, Any], specs: Mapping[str, Any]
              ) -> Dict[str, Any]:
    """{key: fn(leaf, spec)} over a tree and its spec tree."""
    return {k: map_specs(fn, v, specs[k]) if isinstance(v, Mapping)
            else fn(v, specs[k]) for k, v in tree.items()}


def shard_state(state: Mapping[str, Any], specs: Mapping[str, Any], mesh
                ) -> Dict[str, Any]:
    """This rank's train state from the full one: each leaf of "params"
    and "opt" cut to its spec (``train_loop.state_specs``)."""
    coords = mesh_coords(mesh)
    out = {k: map_specs(lambda t, s: shard_leaf(t, s, mesh, coords),
                        state[k], specs[k]) for k in ("params", "opt")}
    out["step"] = state["step"]
    return out


def gather_state(state: Mapping[str, Any], specs: Mapping[str, Any], mesh
                 ) -> Dict[str, Any]:
    """The full train state from every rank's shards (a collective: every
    rank calls it)."""
    out = {k: map_specs(lambda t, s: gather_leaf(t, s, mesh), state[k],
                        specs[k]) for k in ("params", "opt")}
    out["step"] = state["step"]
    return out


def data_dim(spec) -> Optional[int]:
    """The dim a spec shards over the data axis, or None."""
    for i, ax in enumerate(spec):
        if ax == "data":
            return i
    return None


class ModelParallel:
    """What the model needs to run one rank of a (d, t) plan: the model
    axis's group for the dense family's tensor parallelism, and at ZeRO 3
    the data axis's group and each parameter leaf's data-sharded dim
    (``gather_dims``: the params' spec tree mapped through ``data_dim``).

    The model calls it only when the train step passes one
    (``forward(..., par=...)``): the one-device path never does.
    """

    def __init__(self, mesh, embed_spec, head_spec=None,
                 gather_dims: Optional[Dict[str, Any]] = None):
        sizes = sh.axis_sizes(mesh)
        coords = mesh_coords(mesh)
        self.t = sizes.get("model", 1)
        self.model_idx = coords.get("model", 0)
        self.model_group = mesh.get_group("model") if self.t > 1 else None
        self.nd = sizes.get("data", 1)
        self.data_group = mesh.get_group("data") if self.nd > 1 else None
        self.embed_spec, self.head_spec = embed_spec, head_spec
        self.gather_dims = gather_dims or {}

    # ---- the model axis ------------------------------------------------
    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else _CopyToModel.apply(x, self.model_group)

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else _ReduceFromModel.apply(x,
                                                            self.model_group)

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.t == 1:
            return x
        return _GatherFromModel.apply(x, dim, self.model_group, self.t,
                                      self.model_idx)

    def _my_slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk of a replicated activation along ``dim``, its
        gradient summed over the model axis."""
        return self.to_model(x).chunk(self.t, dim)[self.model_idx]

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings (b, s, d), replicated over the model axis,
        from this rank's shard of the (V, d) table: rows of the vocabulary
        (looked up where the token falls in them, zero elsewhere, summed
        over the model axis) or columns of d_model (gathered)."""
        if self.t == 1 or self.embed_spec[0] is None and \
                self.embed_spec[1] is None:
            return table[tokens]
        if self.embed_spec[0] == "model":             # (V/t, d)
            rows = table.shape[0]
            local = tokens - self.model_idx * rows
            inside = (local >= 0) & (local < rows)
            x = table[torch.where(inside, local, 0)]
            x = x * inside[..., None].to(x.dtype)
            return self.from_model(x)
        return self.gather_model(table[tokens], -1)    # (V, d/t)

    def head(self, x: torch.Tensor, params: Mapping[str, Any]) -> torch.Tensor:
        """Full-vocabulary logits, replicated over the model axis, from
        this rank's shard of the head: the embedding table when tied
        (logits = x E^T), else ``lm_head`` (d, V)."""
        head = params.get("lm_head")
        if self.t == 1:
            return x @ head if head is not None else x @ params["embed"].T
        if head is None:                               # tied: E (V?, d?)
            w, spec = params["embed"].T, self.embed_spec[::-1]
        else:
            w, spec = head, self.head_spec
        if spec[1] == "model":                          # (d, V/t)
            return self.gather_model(self.to_model(x) @ w, -1)
        if spec[0] == "model":                          # (d/t, V)
            return self.from_model(self._my_slice(x, -1) @ w)
        return x @ w

    # ---- the data axis at ZeRO 3 ---------------------------------------
    def _gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None or self.nd == 1:
            return t
        return _GatherFromData.apply(t, dim, self.data_group, self.nd)

    def gather_top(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with the leaves outside the blocks gathered."""
        return {k: v if k == "blocks" else self._gather(v,
                                                        self.gather_dims.get(k))
                for k, v in params.items()}

    def gather_block(self, bp: Dict[str, Any]) -> Dict[str, Any]:
        """One block's layer views ({"sub{j}": ...}) gathered: a stacked
        leaf's data-sharded dim i is dim i - 1 of a layer's view."""
        def walk(tree, dims):
            return {k: walk(v, dims[k]) if isinstance(v, dict)
                    else self._gather(v, None if dims[k] is None
                                      else dims[k] - 1)
                    for k, v in tree.items()}
        if not self.gather_dims:
            return bp
        return walk(bp, self.gather_dims["blocks"])
