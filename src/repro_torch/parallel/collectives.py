"""The sharded step's communication, on plain local tensors.

The hand-written kernels take raw pointers, so every rank computes on
plain tensors holding its own shard, and the step moves data between
ranks with explicit collectives over the mesh's process groups (the JAX
package leaves this to GSPMD):

* the model axis (Megatron's tensor parallelism): the dense family's
  attention by head and FFN by column, MLA by head, the MoE's experts
  (expert-parallel, or ffn-sharded inside every expert) and Mamba2 by
  head.  ``ModelParallel.to_model`` goes before a column-sharded product
  (identity forward, gradient all-reduced), ``from_model`` after a
  row-sharded one (all-reduce forward, identity backward),
  ``gather_model`` gathers an activation sharded along a dim (all-gather
  forward, the rank's own slice backward) and ``sum_model`` sums a
  quantity that the rank's own part reads back (all-reduce both ways:
  Mamba2's gated norm over a sharded ``d_inner``); the embedding and the
  output head follow the embed's vocab-or-d_model rule.  A head sharded
  over the vocabulary leaves each rank its own V/t columns of the logits,
  never gathered: ``vocab_parallel_cross_entropy`` reduces them over the
  model axis to the loss (the JAX package constrains its logits to
  ("batch", None, "vocab")).

  The gradient rule: these pairs are right when every path from a
  sub-layer's (replicated) input to its output meets exactly one gradient
  all-reduce.  A computation that every model rank repeats inside a
  sharded sub-layer breaks that unless it reads the input *before*
  ``to_model`` and a ``to_model`` goes on its output where that output
  feeds a sharded part: its gradient then arrives complete, and its
  weights' gradients are complete and the same on every rank.  The three
  instances: the MoE router (its probabilities go through ``to_model``
  before they weight the rank's experts; the aux loss reads them before,
  since a loss term every model rank computes must enter no all-reduce
  or its gradient comes out t times too large), MLA's ``wkv_a``/``kv_ln``
  latent and shared RoPE key (``c_kv`` and ``k_rope`` through
  ``to_model`` before the rank's heads) and Mamba2's ``in_bc``/``conv_bc``
  (B and C through ``to_model`` after the conv).  ``gather_model``'s
  own-slice backward is right only for a complete upstream gradient:
  MLA's q latent is gathered, normed by ``q_ln`` on every rank, and only
  then goes through ``to_model`` to the rank's heads.

  When a head count does not divide t (``sharding.attn_head_sharded``
  false), GQA's weights shard their head_dim and its attention the
  sequence (the JAX package's head_dim / ``seq`` fallback, which GSPMD
  lowers there): the rank projects q, k and v onto its head_dim columns;
  ``gather_model_sum`` gathers k and v whole (all-gather forward,
  reduce-scatter backward: every rank's queries add to dK and dV);
  ``head_dim_to_seq`` moves q to the rank's sequence rows with every
  column (an all-to-all whose backward is ``seq_to_head_dim``'s) and
  ``seq_to_head_dim`` moves the attention output back, for the rank's
  rows of ``wo``, whose partial output ``from_model`` sums.
* the data axes: "data", or ("pod", "data") flattened pod-major into one
  group (``data_group``), as JAX's ``PartitionSpec(("pod", "data"))``
  orders them.  ``mean_data`` averages a quantity over the data ranks
  with a backward that averages the upstream gradients (the MoE's
  load-balance statistics, global over the microbatch as in JAX); at
  ZeRO 3 each leaf is all-gathered before use and its gradient
  reduce-scattered back to the shard (``ModelParallel.gather_top``,
  ``gather_block``; the train step calls the latter inside each
  checkpointed block, so the backward gathers again instead of keeping
  the gathered weights).  A block leaf whose only data-sharded dim is the
  stacked layer axis (Mamba2's per-head and per-channel vectors) is
  gathered whole once, before the blocks, by ``gather_top``.

* serving (``serve.engine`` with ``par``): a decode whose cache the ranks
  split (slots over the data axes, or S/t slots after the fallback's
  ``head_dim_to_seq``) merges the ranks' partial results by their
  log-sum-exp (``merge_decode_partials``), and greedy tokens come from
  logits sharded over the vocabulary without gathering them
  (``vocab_parallel_argmax``).

``shard_leaf`` / ``gather_leaf`` cut a rank's shard out of a full leaf and
rebuild the full leaf from the shards.  A leaf that packs parts along its
model-sharded dim (``PACKED``: Mamba2's ``in_zx`` = [z | x]) keeps its
spec's shard shape, but rank r's shard holds its own heads' chunk of each
part side by side ([z_r | x_r]), not the r-th contiguous columns of the
packed leaf (at t=2 those would be all of z on rank 0): the model reads
it as it reads the whole leaf.  Only the model axis regroups; a data
split (another dim under the model axis, or this one at t=1) is plain.
Under the fake process group (``launch.memcheck``), which writes nothing,
what a rank receives is zeroed, so nothing derived from it (the MoE's
routing) reads uninitialised memory; that writes into buffers already
allocated and moves no peak.

Every collective the port makes goes through this module's four calls
(``all_reduce``, ``_gather_single``, ``_reduce_scatter_single``,
``_all_to_all``).  With a tally open (``TALLY``, set by
``launch.op_analysis``) each reports its kind under the JAX opcode name
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``) and
its bytes by the JAX package's ``hlo_analysis`` rule: the operand's, the
output's for an all-gather.  Closed, that costs one attribute read a call.
On meta tensors (the dry run) there is nothing to move: each reports and
skips the process group's call, as the kernels' stand-ins skip their
launch.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as sh


#: the open tally, called (kind, bytes) at each collective; None: closed
TALLY: Optional[Callable[[str, int], None]] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """``dist.all_reduce`` of t in place over ``group``."""
    if TALLY is not None:
        TALLY("all-reduce", _nbytes(t))
    if not t.is_meta:
        dist.all_reduce(t, op=op, group=group)


def _gather_single(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    if TALLY is not None:
        TALLY("all-gather", max(_nbytes(inp), _nbytes(out)))
    # all_gather_into_tensor was renamed all_gather_single (same arguments)
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    if not inp.is_meta:
        fn(out, inp, group=group)


def _reduce_scatter_single(out: torch.Tensor, inp: torch.Tensor,
                           group) -> None:
    if TALLY is not None:
        TALLY("reduce-scatter", _nbytes(inp))
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    if not inp.is_meta:
        fn(out, inp, group=group)


def _received(out: torch.Tensor, group) -> None:
    """Zero what a collective of the fake backend left unwritten."""
    if dist.get_backend(group) == "fake":
        out.zero_()


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The n ranks' ``x`` concatenated along ``dim`` in rank order."""
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_single(out, x, group)
    _received(out, group)
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
    _received(out, group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x (along dim 0, one a rank) to rank j; chunk j of the
    result came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    if TALLY is not None:
        TALLY("all-to-all", _nbytes(x))
    if not x.is_meta:
        dist.all_to_all_single(out, x, group=group)
    _received(out, group)
    return out


def head_dim_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, s, h, w) holding this rank's w columns of every row -> (b, s/n,
    h, n w) holding every column of this rank's rows, over the n ranks."""
    b, s, h, w = x.shape
    got = _all_to_all(x.reshape(b, n, s // n, h, w).transpose(0, 1), group)
    return got.permute(1, 2, 3, 0, 4).reshape(b, s // n, h, n * w)


def seq_to_head_dim(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of ``head_dim_to_seq``: (b, s, h, w) of this rank's
    rows -> (b, n s, h, w/n) of every row, this rank's columns."""
    b, s, h, w = x.shape
    got = _all_to_all(x.reshape(b, s, h, n, w // n).permute(3, 0, 1, 2, 4),
                      group)
    return got.transpose(0, 1).reshape(b, n * s, h, w // n)


class _HeadDimToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return head_dim_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return seq_to_head_dim(g, ctx.group, ctx.n), None, None


class _SeqToHeadDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return seq_to_head_dim(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return head_dim_to_seq(g, ctx.group, ctx.n), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        all_reduce(out, group)
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


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        out = x.clone()
        all_reduce(out, group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, ctx.group)
        return g / ctx.n, None, None


class _GatherSumBack(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward: the gathered tensor's
    gradient is partial on every rank of the group."""
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _VocabParallelCE(torch.autograd.Function):
    """The mean cross-entropy of logits whose last dim each model rank
    holds V/t columns of (rank ``idx`` columns [idx V/t, (idx+1) V/t))."""
    @staticmethod
    def forward(ctx, logits, labels, group, idx):
        vl = logits.shape[-1]
        lf = logits.to(torch.float32, copy=True)
        m = lf.amax(-1)
        all_reduce(m, group, op=dist.ReduceOp.MAX)
        se = lf.sub_(m[..., None]).exp_().sum(-1)
        del lf
        all_reduce(se, group)
        local = labels.long() - idx * vl
        inside = (local >= 0) & (local < vl)
        local = torch.where(inside, local, 0)
        gold = torch.gather(logits, -1, local[..., None])[..., 0].float()
        gold = torch.where(inside, gold, 0.0)
        all_reduce(gold, group)
        nll = torch.log(se) + m - gold
        # the bf16 logits and two floats a row; the float32 softmax is
        # built in the backward
        ctx.save_for_backward(logits, m, se, local, inside)
        ctx.n = nll.numel()
        return torch.mean(nll)

    @staticmethod
    def backward(ctx, g):
        logits, m, se, local, inside = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True)
        p.sub_(m[..., None]).exp_().div_(se[..., None])
        p.scatter_add_(-1, local[..., None], -inside[..., None].float())
        p.mul_(g / ctx.n)
        return p.to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group, idx: int) -> torch.Tensor:
    """The mean token cross-entropy in float32 of logits sharded over the
    vocabulary: ``logits`` (..., V/t) this rank's columns (rank ``idx`` of
    the model axis's ``group``), ``labels`` (...) global vocabulary ids.
    The row max, the sum of exp(l - max) and the gold logit (from the rank
    whose columns hold the label) are reduced over the model axis; the
    loss, the same on every rank, is ``models.cross_entropy`` of the
    gathered logits.  Its backward, (softmax - one_hot) g / n on the local
    columns, communicates nothing."""
    return _VocabParallelCE.apply(logits, labels, group, idx)


def merge_decode_partials(o: torch.Tensor, lse: torch.Tensor, group
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge one-token attention results that the ranks of ``group``
    computed over disjoint parts of a cache: o (b, 1, H, D) float32 and
    its log-sum-exp lse (b, H) float32 on each rank (``flash_decode(...,
    return_lse=True)``) -> (sum_r exp(lse_r - m) o_r / sum_r exp(lse_r -
    m), m + log sum_r exp(lse_r - m)), m the max over the ranks, in
    float32 on every rank.  A rank with no valid slot (lse -inf) adds
    nothing; a row no rank holds a valid slot of gives 0 and -inf.  One
    MAX all-reduce and one sum all-reduce of o and the weights together.
    ``group`` None: one rank, returned as it is."""
    if group is None:
        return o, lse
    m = lse.clone()
    all_reduce(m, group, op=dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, 0.0)   # no rank has a slot: w = 0
    w = torch.exp(lse - m)                           # (b, H)
    b, _, H, D = o.shape
    buf = torch.cat([(o * w.view(b, 1, H, 1)).flatten(), w.flatten()])
    all_reduce(buf, group)
    num, den = buf[:o.numel()].view(o.shape), buf[o.numel():].view(b, H)
    out = num / torch.clamp(den, min=1e-30).view(b, 1, H, 1)
    return out, torch.where(den > 0, m + torch.log(den), -math.inf)


def vocab_parallel_argmax(logits: torch.Tensor, group, idx: int
                          ) -> torch.Tensor:
    """Greedy tokens from logits sharded over the vocabulary: ``logits``
    (..., V/t) this rank's columns (rank ``idx`` of the model axis's
    ``group``) -> (...) global vocabulary ids, the same on every rank:
    the index of the row's maximum, the lowest global index among equal
    maxima, as ``torch.argmax`` of the whole row gives.  One MAX and one
    MIN all-reduce."""
    vl = logits.shape[-1]
    arg = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, arg[..., None])[..., 0].float()
    top = best.clone()
    all_reduce(top, group, op=dist.ReduceOp.MAX)
    cand = torch.where(best == top, arg + idx * vl,
                       torch.iinfo(torch.long).max)
    all_reduce(cand, group, op=dist.ReduceOp.MIN)
    return cand


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis: this rank's index along it} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


# {(mesh, the default process group): this rank's group over the flattened
# data axes}, filled by ``data_group``
_DATA_GROUPS: Dict[Tuple[Any, Any], Any] = {}


def data_group(mesh) -> Tuple[Any, int, int]:
    """(group, size, this rank's index) of the mesh's data axes: "data", or
    ("pod", "data") flattened pod-major -- rank pod * d + data, the order
    of ``_axis_index`` and of JAX's ``PartitionSpec(("pod", "data"))``.
    The group is None at size 1, the axis's own where one axis has more
    than one rank, else one group over both, built once for the mesh
    (every rank builds every model index's group, in the same order).  A
    group orders its ranks by global rank, so each group's ranks must
    ascend in pod-major order, as ``init_device_mesh``'s layout has
    them."""
    sizes = sh.axis_sizes(mesh)
    axes = sh.data_axes(mesh)
    idx, n = _axis_index(axes, sizes, mesh_coords(mesh))
    if n == 1:
        return None, 1, 0
    wide = [a for a in axes if sizes[a] > 1]
    if len(wide) == 1:
        return mesh.get_group(wide[0]), n, idx
    key = (mesh, dist.group.WORLD)
    if key not in _DATA_GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        me = dist.get_rank()
        for ranks in mesh.mesh.permute(*rest, *dims).reshape(-1, n).tolist():
            if ranks != sorted(ranks):
                raise ValueError(f"the data axes' ranks {ranks} do not "
                                 f"ascend pod-major")
            group = dist.new_group(ranks)
            if me in ranks:
                _DATA_GROUPS[key] = group
    return _DATA_GROUPS[key], n, idx


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


# leaves whose model-sharded dim packs parts that the model axis splits
# each on its own (see the module docstring): {leaf name: parts}
PACKED = {"in_zx": 2}


def _packed_index(size: int, parts: int, i: int, n: int, device
                  ) -> torch.Tensor:
    """Positions along a packed dim of ``size`` held by shard i of n: its
    chunk of each of the ``parts`` equal parts, side by side."""
    part = size // parts
    w = part // n
    return torch.cat([torch.arange(p * part + i * w, p * part + (i + 1) * w,
                                   device=device) for p in range(parts)])


def _unpack(t: torch.Tensor, dim: int, parts: int, n: int) -> torch.Tensor:
    """The packed leaf's own order from the n shards gathered along
    ``dim`` (each [part 0 chunk | part 1 chunk | ...])."""
    blocks = t.chunk(n * parts, dim)
    return torch.cat([blocks[r * parts + p] for p in range(parts)
                      for r in range(n)], dim=dim)


def shard_leaf(t: torch.Tensor, spec, mesh, coords: Mapping[str, int],
               dtype: Optional[torch.dtype] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """This rank's shard of the full leaf ``t`` (in ``dtype``, default its
    own) in fresh storage of its own, never a view that would keep the
    full leaf alive.  ``name``: the leaf's name, which says whether it is
    ``PACKED``."""
    sizes = sh.axis_sizes(mesh)
    index, packed = [], None
    for dim, (size, ax) in enumerate(zip(t.shape, spec)):
        if ax is None:
            index.append(slice(None))
            continue
        i, n = _axis_index(ax, sizes, coords)
        if ax == "model" and name in PACKED:
            index.append(slice(None))
            packed = (dim, _packed_index(size, PACKED[name], i, n, t.device))
            continue
        index.append(slice(i * size // n, (i + 1) * size // n))
    out = t[tuple(index)]
    if packed is not None:
        out = out.index_select(*packed)
    return out.to(dtype or t.dtype, copy=True,
                  memory_format=torch.contiguous_format)


def gather_leaf(t: torch.Tensor, spec, mesh, name: Optional[str] = None
                ) -> torch.Tensor:
    """The full leaf from every rank's shard ``t`` (a collective over the
    mesh: every rank calls it); ``name`` as for ``shard_leaf``."""
    sizes = sh.axis_sizes(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):             # ("pod", "data"), pod-major
            if ax != sh.data_axes(mesh):
                raise ValueError(f"a leaf sharded over {ax}, not the data "
                                 f"axes {sh.data_axes(mesh)}")
            group, n, _ = data_group(mesh)
            t = all_gather(t, dim, group, n)
            continue
        t = all_gather(t, dim, mesh.get_group(ax), sizes[ax])
        if ax == "model" and name in PACKED and sizes[ax] > 1:
            t = _unpack(t, dim, PACKED[name], sizes[ax])
    return t


def map_specs(fn, tree: Mapping[str, Any], specs: Mapping[str, Any]
              ) -> Dict[str, Any]:
    """{key: fn(leaf, spec, key)} over a tree and its spec tree."""
    return {k: map_specs(fn, v, specs[k]) if isinstance(v, Mapping)
            else fn(v, specs[k], k) for k, v in tree.items()}


def shard_state(state: Mapping[str, Any], specs: Mapping[str, Any], mesh
                ) -> Dict[str, Any]:
    """This rank's train state from the full one: each leaf of "params"
    and "opt" cut to its spec (``train_loop.state_specs``)."""
    coords = mesh_coords(mesh)
    out = {k: map_specs(lambda t, s, name: shard_leaf(t, s, mesh, coords,
                                                      name=name),
                        state[k], specs[k]) for k in ("params", "opt")}
    out["step"] = state["step"]
    return out


def gather_state(state: Mapping[str, Any], specs: Mapping[str, Any], mesh,
                 parts: Sequence[str] = ("params", "opt")) -> Dict[str, Any]:
    """The full train state from every rank's shards (a collective: every
    rank calls it); ``parts``: which of "params" and "opt" to gather."""
    out = {k: map_specs(lambda t, s, name: gather_leaf(t, s, mesh, name),
                        state[k], specs[k]) for k in parts}
    out["step"] = state["step"]
    return out


def data_dim(spec) -> Optional[int]:
    """The dim a spec shards over the data axes ("data" or ("pod",
    "data")), or None."""
    for i, ax in enumerate(spec):
        if ax == "data" or isinstance(ax, tuple) and "data" in ax:
            return i
    return None


def spec_axes(spec) -> set:
    """The mesh axes a spec uses (a tuple entry's each)."""
    out = set()
    for ax in spec:
        out.update(ax if isinstance(ax, tuple) else (ax,) if ax else ())
    return out


class ModelParallel:
    """What the model needs to run one rank of a (d, t) plan: the model
    axis's group for tensor parallelism, whether GQA attention shards by
    head or falls back to head_dim / sequence (``attn_head_sharded``,
    ``sharding.attn_head_sharded``'s answer), whether the head shards the
    vocabulary (``vocab_sharded``: the logits stay this rank's V/t
    columns), the data axes' group (``data_group``: the MoE's load-balance
    statistics) and at ZeRO 3 each parameter leaf's data-sharded dim
    (``gather_dims``: the params' spec tree mapped through ``data_dim``).
    For serving (``serve.engine.serve_parallel``) it also says whether
    the decode caches split their slots over the data axes
    (``cache_seq_split``: a global batch the data axes do not divide, as
    ``sharding.cache_specs`` rules), this rank's index along them
    (``data_idx``, pod-major) and the axis sizes (``sizes``, for the
    caches' local shapes).

    The model calls it only when the train step or the serving engine
    passes one (``forward(..., par=...)``, ``decode_step(..., par=...)``):
    the one-device path never does.
    """

    def __init__(self, mesh, embed_spec, head_spec=None,
                 gather_dims: Optional[Dict[str, Any]] = None,
                 attn_head_sharded: bool = True,
                 cache_seq_split: bool = False):
        sizes = sh.axis_sizes(mesh)
        coords = mesh_coords(mesh)
        self.sizes = sizes
        self.t = sizes.get("model", 1)
        self.model_idx = coords.get("model", 0)
        self.model_group = mesh.get_group("model") if self.t > 1 else None
        self.data_group, self.nd, self.data_idx = data_group(mesh)
        self.seq_split = cache_seq_split and self.nd > 1
        self.embed_spec, self.head_spec = embed_spec, head_spec
        # the head's (d, V) spec: lm_head's, or the tied embed's transposed
        spec = head_spec if head_spec is not None else embed_spec[::-1]
        self.vocab_sharded = self.t > 1 and spec[1] == "model"
        self.gather_dims = gather_dims or {}
        self.attn_head_sharded = attn_head_sharded or self.t == 1

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

    def gather_model_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` gathered along ``dim`` over the model axis, for every
        rank's own use: its gradient, partial on each rank, is summed and
        scattered back (the head_dim / seq fallback's k and v)."""
        if self.t == 1:
            return x
        return _GatherSumBack.apply(x, dim, self.model_group, self.t)

    def head_dim_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(b, s, h, w/t) of this rank's columns -> (b, s/t, h, w) of its
        rows (``head_dim_to_seq``), with the inverse as its backward."""
        if self.t == 1:
            return x
        return _HeadDimToSeq.apply(x, self.model_group, self.t)

    def seq_to_head_dim(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``head_dim_to_seq``, with it as the backward."""
        if self.t == 1:
            return x
        return _SeqToHeadDim.apply(x, self.model_group, self.t)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens (...) from ``head``'s logits (..., V or V/t):
        ``vocab_parallel_argmax`` over the model axis when they are this
        rank's V/t columns, else ``torch.argmax`` of the row."""
        if self.vocab_sharded:
            return vocab_parallel_argmax(logits, self.model_group,
                                         self.model_idx)
        return torch.argmax(logits, dim=-1)

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model axis, for the rank's own part to
        read: each rank's gradient of it is partial, so the backward
        all-reduces too (``to_model`` after ``from_model``)."""
        return self.to_model(self.from_model(x))

    # ---- the data axis -------------------------------------------------
    def mean_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data ranks, whose backward is the mean
        of the ranks' upstream gradients (each rank differentiates its own
        loss; the step averages the gradients over data)."""
        if self.nd == 1:
            return x
        return _MeanOverData.apply(x, self.data_group, self.nd)

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
        """The logits from this rank's shard of the head: the embedding
        table when tied (logits = x E^T), else ``lm_head`` (d, V).  With
        the head sharded over the vocabulary (``vocab_sharded``) they are
        this rank's V/t columns, for ``loss``; else the whole vocabulary,
        replicated over the model axis."""
        head = params.get("lm_head")
        if self.t == 1:
            return x @ head if head is not None else x @ params["embed"].T
        if head is None:                               # tied: E (V?, d?)
            w, spec = params["embed"].T, self.embed_spec[::-1]
        else:
            w, spec = head, self.head_spec
        if spec[1] == "model":                          # (d, V/t)
            return self.to_model(x) @ w
        if spec[0] == "model":                          # (d/t, V)
            return self.from_model(self._my_slice(x, -1) @ w)
        return x @ w

    def loss(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """The mean cross-entropy of ``head``'s logits: over the model
        axis (``vocab_parallel_cross_entropy``) when they are this rank's
        V/t columns, else ``models.cross_entropy`` of the whole row."""
        if self.vocab_sharded:
            return vocab_parallel_cross_entropy(logits, labels,
                                                self.model_group,
                                                self.model_idx)
        # imported here: the models import this module
        from repro_torch.models.transformer import cross_entropy
        return cross_entropy(logits, labels)

    # ---- the data axes at ZeRO 3 ---------------------------------------
    def _gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None or self.nd == 1:
            return t
        return _GatherSumBack.apply(t, dim, self.data_group, self.nd)

    def _walk(self, tree, dims, dim_of):
        return {k: self._walk(v, dims[k], dim_of) if isinstance(v, dict)
                else self._gather(v, dim_of(dims[k])) for k, v in tree.items()}

    def gather_top(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with the leaves outside the blocks gathered, and the
        stacked block leaves sharded over data along the layer axis (dim
        0) gathered whole, once for every layer."""
        def top(k, v):
            dims = self.gather_dims.get(k)
            if k != "blocks":
                return self._gather(v, dims)
            return v if dims is None else self._walk(
                v, dims, lambda d: 0 if d == 0 else None)
        return {k: top(k, v) for k, v in params.items()}

    def gather_block(self, bp: Dict[str, Any]) -> Dict[str, Any]:
        """One block's layer views ({"sub{j}": ...}) gathered: a stacked
        leaf's data-sharded dim i is dim i - 1 of a layer's view (a leaf
        sharded on the layer axis, i = 0, ``gather_top`` gathered)."""
        if not self.gather_dims:
            return bp
        return self._walk(bp, self.gather_dims["blocks"],
                          lambda d: d - 1 if d else None)
