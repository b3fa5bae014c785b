"""Sharding rules: map every parameter / activation / cache leaf to a spec
over the production mesh axes -- the JAX package's rules
(``repro/parallel/sharding.py``), copied.

Mesh axes: ``('data', 'model')`` single-pod, ``('pod', 'data', 'model')``
multi-pod.  The pod axis composes with data parallelism -- MARP's (d, t)
plan maps d -> ('pod', 'data') and t -> 'model'.

A mesh here is anything that names its axes and their sizes: a
``torch.distributed.DeviceMesh`` with ``mesh_dim_names``, or a mapping
{axis name: size} in the mesh's axis order.  A spec is a tuple with one
entry per dim: None (replicated), an axis name, or a tuple of axis names
(sharded over their product) -- what ``tuple(PartitionSpec(...))`` gives
in the JAX package.

ZeRO levels (TrainConfig.zero):
  0 -- optimizer state replicated over data (paper's 20 B/param verbatim)
  1 -- optimizer state + gradient accumulator sharded over data (default)
  3 -- bf16 params additionally sharded over data (fully sharded)
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mapping stand-in."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in axis_sizes(mesh) else None


# --------------------------------------------------------- param specs ------

def attn_head_sharded(cfg: ModelConfig, tp: int) -> bool:
    """Shard attention by heads when every head count divides tp; otherwise
    fall back to sharding head_dim (always 64/128-aligned)."""
    if cfg.attention == "mla":
        return cfg.num_heads % tp == 0
    return cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0


def ssm_groups(heads: int, head_dim: int, tp: int
               ) -> Tuple[int, int, int, int]:
    """How Mamba2's SSD heads split over a model axis of tp: (g, q, h_l,
    p_l).  With g = gcd(heads, tp) the ranks form g groups of q = tp / g;
    rank grp q + part holds the group's h_l = heads / g whole heads
    (grp h_l ..) and of each the part-th p_l = head_dim / q of its
    channels (SSD is independent along the head dim: a rank computes
    exactly its channels of y and of the state).  When tp divides the
    heads, q = 1: heads / tp whole heads a rank.
    ``check_sharded_supported`` refuses a head_dim that q does not
    divide."""
    g = math.gcd(heads, tp)
    return g, tp // g, heads // g, head_dim * g // tp


def ssm_split(cfg: ModelConfig, tp: int) -> Tuple[int, int, int, int]:
    """``ssm_groups`` of the config's SSD heads on tp model ranks: (g, q,
    the heads a rank holds, the channels of each)."""
    return ssm_groups(cfg.n_ssm_heads, cfg.ssm_head_dim, tp)


def ssm_rank_channels(x: torch.Tensor, heads: int, head_dim: int, tp: int,
                      rank: int) -> torch.Tensor:
    """Model rank ``rank``'s channels of x (..., heads * head_dim) under
    ``ssm_groups``: (..., h_l p_l), head-major -- its group's heads in
    order, of each its p_l channels -- by reshapes, never an index."""
    g, q, hl, pl = ssm_groups(heads, head_dim, tp)
    grp, part = divmod(rank, q)
    lead = x.shape[:-1]
    return x.reshape(*lead, g, hl, q, pl)[..., grp, :, part, :].reshape(
        *lead, hl * pl)


def ssm_natural_order(x: torch.Tensor, heads: int, head_dim: int, tp: int
                      ) -> torch.Tensor:
    """The inverse: the tp ranks' ``ssm_rank_channels`` side by side in
    rank order (..., heads * head_dim), back in d_inner's order."""
    g, q, hl, pl = ssm_groups(heads, head_dim, tp)
    lead = x.shape[:-1]
    return x.reshape(*lead, g, q, hl, pl).transpose(-3, -2).reshape(
        *lead, -1)


@functools.lru_cache(maxsize=None)
def ssm_channels(heads: int, head_dim: int, tp: int, rank: int
                 ) -> Tuple[int, ...]:
    """The d_inner channels (head * head_dim + channel) that model rank
    ``rank`` of ``tp`` holds: ``ssm_rank_channels`` of their numbers."""
    return tuple(ssm_rank_channels(torch.arange(heads * head_dim), heads,
                                   head_dim, tp, rank).tolist())


def expert_sharded(cfg: ModelConfig, tp: int) -> bool:
    return cfg.num_experts > 0 and cfg.num_experts % tp == 0


def _param_rule(cfg: ModelConfig, names: Tuple[str, ...], ndim: int,
                shape: Tuple[int, ...], tp: int) -> Spec:
    """Spec for one parameter leaf (dims exclude the stacked block axis)."""
    leaf = names[-1]
    in_blocks = "blocks" in names
    heads = attn_head_sharded(cfg, tp)

    def blk(*spec):
        return (None, *spec) if in_blocks else tuple(spec)

    if leaf == "embed":
        if cfg.vocab_size % tp == 0:
            return ("model", None)
        return (None, "model")
    if leaf == "lm_head":
        if cfg.vocab_size % tp == 0:
            return (None, "model")
        return ("model", None)
    if leaf in ("final_norm",):
        return (None,)
    if leaf in ("norm1", "norm2", "q_ln", "kv_ln"):
        return blk(None)
    # ---- attention: (d, H|K, hd) and (H, hd, d) ----
    if leaf in ("wq", "wk", "wv"):
        return blk(None, "model", None) if heads else blk(None, None, "model")
    if leaf == "wo":
        return blk("model", None, None) if heads else blk(None, "model", None)
    if leaf in ("wq_b", "wk_b", "wv_b"):      # (r, H, k)
        return blk(None, "model", None) if heads else blk(None, None, "model")
    if leaf == "wq_a":                        # (d, r_q)
        return blk(None, "model")
    if leaf == "wkv_a":                       # (d, r_kv+dr) -- latent is shared
        return blk(None, None)
    # ---- dense mlp / shared experts ----
    if leaf in ("w1", "w3", "shared_w1", "shared_w3") and "ffn" in names \
            and not _is_expert(shape, cfg):
        return blk(None, "model")
    if leaf in ("w2", "shared_w2") and "ffn" in names \
            and not _is_expert(shape, cfg):
        return blk("model", None)
    # ---- moe experts (E, d, f) / (E, f, d) ----
    if leaf in ("w1", "w3") and _is_expert(shape, cfg):
        if expert_sharded(cfg, tp):
            return blk("model", None, None)   # expert parallel
        return blk(None, None, "model")       # tp inside experts
    if leaf == "w2" and _is_expert(shape, cfg):
        if expert_sharded(cfg, tp):
            return blk("model", None, None)
        return blk(None, "model", None)
    if leaf == "router":
        return blk(None, None)
    # ---- mamba2 ----
    if leaf == "in_zx":
        return blk(None, "model")
    if leaf in ("in_bc", "conv_bc_w", "conv_bc_b"):
        return blk(None) if ndim == 1 else blk(None, None)
    if leaf == "in_dt":
        return blk(None, "model")
    if leaf == "conv_x_w":
        return blk(None, "model")
    if leaf in ("conv_x_b", "norm"):
        return blk("model")
    if leaf in ("A_log", "D", "dt_bias"):
        return blk("model")
    if leaf == "out_proj":
        return blk("model", None)
    raise ValueError(f"no sharding rule for {'/'.join(names)} shape={shape}")


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def enforce_divisibility(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes from dims they do not evenly divide (the JAX package's
    jit requires exactly tiled input shardings; here a shard is then a
    plain slice)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    return tuple(out)


def _is_expert(shape, cfg: ModelConfig) -> bool:
    return len(shape) == 3 and cfg.num_experts > 0 and shape[0] == cfg.num_experts


def _with_data(spec: Spec, shape: Tuple[int, ...],
               daxes: Tuple[str, ...]) -> Spec:
    """ZeRO: additionally shard the largest unsharded dim over data axes."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_sz = None, 0
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s > best_sz:
            best, best_sz = i, s
    if best is None or best_sz < 2:
        return spec
    entries[best] = daxes if len(daxes) > 1 else daxes[0]
    return tuple(entries)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map_with_path(fn, tree: Mapping, path: Tuple[str, ...] = ()) -> Dict:
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, Mapping)
            else fn(path + (k,), v) for k, v in tree.items()}


def leaf_spec(cfg: ModelConfig, names: Tuple[str, ...], shape: Tuple[int, ...],
              mesh, *, zero_data: bool = False) -> Spec:
    """The spec of the parameter leaf at path ``names`` of (stacked)
    ``shape``."""
    tp = axis_sizes(mesh).get("model", 1)
    daxes = data_axes(mesh)
    in_blocks = "blocks" in names
    eff_shape = shape[1:] if in_blocks else shape
    spec = _param_rule(cfg, names, len(eff_shape), eff_shape, tp)
    spec = enforce_divisibility(spec, shape, mesh)
    if zero_data and daxes:
        spec = _with_data(spec, shape, daxes)
        spec = enforce_divisibility(spec, shape, mesh)
    return spec


def param_specs(cfg: ModelConfig, params_shape: Mapping, mesh, *,
                zero_data: bool = False) -> Dict:
    """Tree of specs matching the params tree, whose leaves are tensors or
    shape tuples (``models.param_shapes(cfg)``).

    zero_data=True additionally shards over the data axes (ZeRO-3 params,
    or optimizer/master state at ZeRO>=1)."""
    return _map_with_path(
        lambda names, leaf: leaf_spec(cfg, names, _shape_of(leaf), mesh,
                                      zero_data=zero_data),
        params_shape)


# --------------------------------------------------------- batch specs ------

def _data_spec_entry(mesh):
    daxes = data_axes(mesh)
    return daxes if len(daxes) > 1 else (daxes[0] if daxes else None)


def _n_data(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Spec]:
    """Input sharding for a training/prefill/decode batch."""
    dax = _data_spec_entry(mesh)
    bshard = dax if shape.global_batch % max(_n_data(mesh), 1) == 0 else None
    specs = {"tokens": (bshard, None)}
    if cfg.num_modal_tokens and shape.kind != "decode":
        specs["modal_embeds"] = (bshard, None, None)
    if shape.kind == "train":
        specs["labels"] = (bshard, None)
    return specs


def data_rows(global_batch: int, n_micro: int, mesh, r: int) -> List[int]:
    """The global batch rows data rank ``r`` holds, in microbatch order:
    microbatch i's rows i * mb * nd + r * mb + [0, mb), mb = global_batch /
    (n_micro * nd), with r counted pod-major over the data axes -- the
    rows the JAX package's reshape of a batch sharded over ("pod", "data")
    (``batch_specs``) into microbatches leaves on that rank."""
    nd = _n_data(mesh)
    if global_batch % (n_micro * nd):
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{n_micro} microbatches on {nd} data shards")
    if not 0 <= r < nd:
        raise ValueError(f"data rank {r} is not one of {nd}")
    mb = global_batch // (n_micro * nd)
    return [(i * nd + r) * mb + j for i in range(n_micro) for j in range(mb)]


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """Decode-cache sharding.  Batch over data axes when divisible; for
    global_batch=1 (long_500k) the sequence dim is sharded over data
    instead so the 500k-token cache is distributed."""
    dax = _data_spec_entry(mesh)
    batch_ok = shape.global_batch % max(_n_data(mesh), 1) == 0
    b_ax = dax if batch_ok else None
    s_ax = None if batch_ok else dax

    tp = axis_sizes(mesh).get("model", 1)
    heads = attn_head_sharded(cfg, tp)
    out = {}
    for j in range(cfg.block_period):
        kind = cfg.layer_kind(j)
        if kind == "ssm":
            sub = {"conv": (None, b_ax, None, "model"),
                   "ssd": (None, b_ax, "model", None, None)}
        elif cfg.attention == "mla":
            sub = {"c_kv": (None, b_ax, s_ax, None),
                   "k_rope": (None, b_ax, s_ax, None)}
        elif heads:
            sub = {"k": (None, b_ax, s_ax, "model", None),
                   "v": (None, b_ax, s_ax, "model", None)}
        else:
            sub = {"k": (None, b_ax, s_ax, None, "model"),
                   "v": (None, b_ax, s_ax, None, "model")}
        out[f"sub{j}"] = sub
    return out


def prefill_cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """Sharding for the cache tree *as returned by prefill* (full-sequence
    k/v of shape (nb, b, s, K, hd), before ring conversion)."""
    return cache_specs(cfg, shape, mesh)


# --------------------------------------------------------- plan support ----
# The port's own: which plans its sharded train and serving steps run.

# where the plans the sharded step does not run are listed
DEFERRED = "ROADMAP.md queue 1 item 14"

# the number of data shards (the pod and data axes together)
n_data_shards = _n_data


def check_sharded_supported(cfg: ModelConfig, tc, mesh) -> None:
    """Raise NotImplementedError for a (cfg, mesh) the sharded train and
    serving steps do not run; never fall back to a replicated run.  ``tc``
    (the train config, None for serving) decides nothing: every ZeRO level
    runs."""
    sizes = axis_sizes(mesh)
    t = sizes.get("model", 1)
    if set(sizes) - {"pod", "data", "model"}:
        raise NotImplementedError(f"the sharded step runs a ([pod,] data, "
                                  f"model) mesh, not {tuple(sizes)}: "
                                  f"{DEFERRED}")
    if t > 1:
        kinds = {cfg.layer_kind(j) for j in range(cfg.block_period)}
        # every width the model axis splits (a width it does not divide
        # would be kept whole by enforce_divisibility)
        widths = {"d_model": cfg.d_model, "d_ff": cfg.d_ff}
        if cfg.attention == "mla":
            widths["q_lora_rank"] = cfg.q_lora_rank
        if cfg.num_experts and not expert_sharded(cfg, t):
            widths["moe_d_ff"] = cfg.moe_d_ff
        if cfg.num_shared_experts:
            widths["shared experts' width"] = (cfg.num_shared_experts
                                               * cfg.moe_d_ff)
        q = ssm_groups(cfg.n_ssm_heads, cfg.ssm_head_dim, t)[1]
        if "ssm" in kinds and cfg.ssm_head_dim % q:
            # the SSD heads split by heads and channels (ssm_split)
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_ssm_heads} SSD heads on a model axis "
                f"of {t} split each head's {cfg.ssm_head_dim} channels over "
                f"{q} ranks, which do not divide them: {DEFERRED}")
        if "attn" in kinds and not attn_head_sharded(cfg, t):
            # the head_dim / seq fallback splits each head's columns
            if cfg.attention == "mla":
                widths["MLA's qk head dim"] = (cfg.qk_nope_head_dim
                                               + cfg.qk_rope_head_dim)
                widths["MLA's nope head dim"] = cfg.qk_nope_head_dim
                widths["MLA's v head dim"] = cfg.v_head_dim
            else:
                widths["head_dim"] = cfg.head_dim
        for what, n in widths.items():
            if n % t:
                raise NotImplementedError(
                    f"{cfg.name}: {what} {n} not divisible by the model "
                    f"axis {t}: {DEFERRED}")
