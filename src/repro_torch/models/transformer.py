"""Model assembly for the attention transformers, Mamba2 and the hybrid
(Jamba): init, full-sequence forward (train / prefill) with optional
per-block rematerialisation, the training loss, decode caches and
single-token decode.

Layers are grouped into repeating blocks of ``cfg.block_period``
sub-layers (1 for a homogeneous stack; 8 for jamba's seven Mamba2 layers
around one attention layer, MoE on every other layer).  The parameter tree
is the JAX package's: ``embed`` (V, d), ``final_norm`` (d,), ``lm_head``
(d, V) unless the embeddings are tied, and ``blocks.sub{j}`` for each
position j of the block, whose leaves are stacked along a leading
``n_blocks`` axis (``norm1``, ``mixer`` -- GQA ``{wq,wk,wv,wo}``, MLA (see
``attention.mla_param_shapes``) or Mamba2 (see
``mamba2.mamba2_param_shapes``) --, ``norm2``, ``ffn`` -- dense
``{w1,w2[,w3]}`` or MoE, see ``moe.moe_param_shapes``; a layer with no
dense width and no MoE, as Mamba2's, has no FFN).  Layer l is block
l // period, sub-layer l % period; the forward walks the blocks, and in
each the sub-layers, in a Python loop.  A VLM config (``num_modal_tokens``
> 0, llava-next) takes a prefix of precomputed embeddings before the text
tokens (``_embed_inputs``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import dense_init, embed_init, mlp, rms_norm
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.collectives import ModelParallel

Params = Dict[str, Any]
Cache = Dict[str, Any]

# leaves kept in float32 whatever the parameters' dtype: the MoE router
# (moe.py:37 of the JAX package: its logits and softmax run in float32) and
# Mamba2's A_log, D and dt_bias (mamba2.py:38-40)
FP32_LEAVES = ("router", "A_log", "D", "dt_bias")
NORM_LEAVES = ("norm1", "norm2", "final_norm", "q_ln", "kv_ln", "norm")
# Mamba2's per-channel and per-head leaves, which init_mamba2 sets by rule
# rather than by the fan-in draw (mamba2.py:24-46 of the JAX package)
SSM_VECTORS = ("conv_x_b", "conv_bc_b", "A_log", "D", "dt_bias")


def _check_supported(cfg: ModelConfig) -> None:
    attn_ok = cfg.attention in ("gqa", "mla")
    if any(cfg.layer_kind(j) == "attn" and not attn_ok
           for j in range(cfg.block_period)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs models of GQA or MLA attention and "
            f"Mamba2 layers")


def _mixer_kind(cfg: ModelConfig, j: int) -> str:
    """Sub-layer j's mixer: "ssm", "mla" or "gqa"."""
    return "ssm" if cfg.layer_kind(j) == "ssm" else cfg.attention


def _layer_has_ffn(cfg: ModelConfig, j: int) -> bool:
    """Whether sub-layer j has an FFN: a MoE layer always, a dense one when
    d_ff > 0 (transformer.py:44-47 of the JAX package)."""
    return cfg.layer_is_moe(j) or cfg.d_ff > 0


def _sub_names(cfg: ModelConfig) -> List[str]:
    return [f"sub{j}" for j in range(cfg.block_period)]


def _map_tree(fn: Callable, tree: dict, path: Tuple[str, ...] = ()) -> dict:
    return {k: _map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _sub_shapes(cfg: ModelConfig, j: int) -> Dict[str, Any]:
    """Sub-layer j's leaves, stacked over the n_blocks blocks."""
    nb, d, f = cfg.num_layers // cfg.block_period, cfg.d_model, cfg.d_ff
    kind = _mixer_kind(cfg, j)
    if kind == "ssm":
        mixer = mamba2.mamba2_param_shapes(cfg)
    elif kind == "mla":
        mixer = attn.mla_param_shapes(cfg)
    else:
        mixer = attn.gqa_param_shapes(cfg)
    sub: Dict[str, Any] = {
        "norm1": (nb, d),
        "mixer": {k: (nb, *s) for k, s in mixer.items()},
    }
    if _layer_has_ffn(cfg, j):
        if cfg.layer_is_moe(j):
            ffn = moe_mod.moe_param_shapes(cfg)
        else:
            ffn = {"w1": (d, f), "w2": (f, d)}
            if cfg.mlp_variant == "swiglu":
                ffn["w3"] = (d, f)
        sub["norm2"] = (nb, d)
        sub["ffn"] = {k: (nb, *s) for k, s in ffn.items()}
    return sub


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with a shape at each leaf."""
    _check_supported(cfg)
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab_size, d),
              "blocks": {name: _sub_shapes(cfg, j)
                         for j, name in enumerate(_sub_names(cfg))},
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                take: Optional[Callable] = None,
                local: Optional[Callable] = None) -> Params:
    """Random parameters drawn on ``device`` from a generator seeded with
    ``seed``, bfloat16 but the float32 ``FP32_LEAVES``: norms at 1,
    embeddings N(0, 0.02) truncated at 3 sigma, every matrix
    truncated-normal with std = scale / sqrt(fan_in), fan_in being the first
    per-layer axis (the second for the experts' stacked ``w1``/``w2``/``w3``
    of a MoE sub-layer; the conv width for Mamba2's conv weights) and scale
    1/sqrt(2L) on the output projections ``wo``, ``w2``, ``shared_w2`` and
    ``out_proj``; Mamba2's
    conv biases at 0, A_log = log(linspace(1, 16, h)), D at 1 and dt_bias
    the inverse softplus of a dt drawn log-uniform in [1e-3, 0.1] -- the
    JAX package's recipe (its random numbers differ).  On the ``meta``
    device (shapes only) a CPU generator stands in.

    ``take(path, leaf)``, when given, receives each leaf as it is drawn and
    returns what the tree keeps in its place (one rank's shard: the whole
    tree is then never held at once); the draws are the same.
    ``local(path, shape)``, when given, is the shape each leaf is drawn at
    in place of its own (one rank's shard shape, for a rank whose whole
    leaves would not fit its card): the fan-in stays the whole leaf's, the
    values are not the whole leaf's."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device).manual_seed(seed)
    where = device if meta else None
    out_scale = 1.0 / math.sqrt(2 * cfg.num_layers)

    def init(path, full):
        shape = full if local is None else local(path, full)
        name = path[-1]
        if name in NORM_LEAVES:
            return torch.ones(shape, dtype=torch.bfloat16, device=device)
        if name == "embed":
            return embed_init(gen, shape, where)
        if name in SSM_VECTORS:
            return _init_ssm_vector(gen, name, shape, where)
        in_axis = 0
        if path[0] == "blocks":                 # (nb, ...) stacked leaves
            # path: ("blocks", "sub{j}", ..., name); a dense FFN's w1/w2/w3
            # take their fan-in per layer, a MoE's per expert
            expert = (cfg.layer_is_moe(int(path[1][3:])) and path[-2] == "ffn"
                      and name in ("w1", "w2", "w3"))
            in_axis = 2 if expert else 1
        scale = (out_scale if name in ("wo", "w2", "shared_w2", "out_proj")
                 else 1.0)
        dtype = torch.float32 if name in FP32_LEAVES else torch.bfloat16
        return dense_init(gen, shape, full[in_axis], scale=scale, dtype=dtype,
                          device=where)

    if take is None:
        return _map_tree(init, param_shapes(cfg))
    return _map_tree(lambda path, shape: take(path, init(path, shape)),
                     param_shapes(cfg))


def _init_ssm_vector(gen: torch.Generator, name: str, shape: Tuple[int, ...],
                     device=None) -> torch.Tensor:
    """One of ``SSM_VECTORS``, stacked (nb, ...): conv biases 0 (bf16),
    A_log = log(linspace(1, 16, h)), D = 1 and dt_bias the inverse softplus
    of a dt drawn log-uniform in [1e-3, 0.1] (float32), on ``device``
    (default the generator's)."""
    device = device or gen.device
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device)
                         ).expand(shape).contiguous()
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name == "dt_bias":
        u = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))       # inverse softplus
    return torch.zeros(shape, dtype=torch.bfloat16, device=device)


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count (no allocation)."""
    return sum(math.prod(shape) for shape in _leaves(param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters active per token: a MoE layer counts its top_k routed
    experts and the shared ones, not the other routed experts (the JAX
    package's ``active_param_count``)."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    n_moe = sum(1 for l in range(cfg.num_layers) if cfg.layer_is_moe(l))
    per_expert = cfg.d_model * cfg.moe_d_ff * (
        3 if cfg.mlp_variant == "swiglu" else 2)
    return total - n_moe * per_expert * (cfg.num_experts - cfg.top_k)


# the fp32 gradient sums the one-device step adds its stacked leaves'
# layer gradients into, by the leaf's id: (sum, the ids of the leaves
# whose gradients went to their sums while it is open)
_SINKS: Dict[int, Tuple[torch.Tensor, set]] = {}


@contextmanager
def grad_sinks(pairs):
    """While open, the backward of each stacked block leaf of ``pairs``
    ((leaf, fp32 sum of its shape) pairs) adds every layer's gradient into
    the sum (``_UnbindInto``) and leaves the leaf without a gradient.
    Yields the ids of the leaves whose gradients went there."""
    sunk = set()
    added = {id(leaf): (acc, sunk) for leaf, acc in pairs}
    _SINKS.update(added)
    try:
        yield sunk
    finally:
        for key in added:
            del _SINKS[key]


class _UnbindInto(torch.autograd.Function):
    """``leaf.unbind(0)`` whose backward adds each layer's gradient into
    the fp32 sum ``sink`` (the step's accumulator of the leaf) and gives
    the leaf none: ``unbind``'s backward would stack every layer's
    gradient into a new tensor while they are all alive, the leaf's
    gradient twice at once, then the step adds that into the sum."""

    @staticmethod
    def forward(ctx, leaf, sink):
        ctx.sink = sink
        return leaf.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        torch._foreach_add_(ctx.sink.unbind(0), grads)
        return None, None


def _unbind(leaf: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each layer's view of a stacked leaf, through ``_UnbindInto`` where a
    ``grad_sinks`` sum is open for it and a gradient will flow."""
    if id(leaf) not in _SINKS or not (torch.is_grad_enabled()
                                      and leaf.requires_grad):
        return leaf.unbind(0)
    sink, sunk = _SINKS[id(leaf)]
    sunk.add(id(leaf))
    return _UnbindInto.apply(leaf, sink)


def layer_params(blocks: Params) -> List[Params]:
    """Each layer's slice of the stacked block parameters (views, no copy),
    from one ``unbind`` per leaf (``_unbind``): its backward is one
    ``stack`` per leaf, or the layers' gradients added into the leaf's
    ``grad_sinks`` sum, where indexing each layer would fill and add a
    zero tensor the size of the whole stacked leaf for every layer."""
    per_leaf = _map_tree(lambda _, leaf: _unbind(leaf), blocks)
    n = len(next(_leaves(per_leaf)))
    return [_map_tree(lambda _, views: views[i], per_leaf) for i in range(n)]


# ------------------------------------------------------------- forward ------

def _ffn_residual(cfg: ModelConfig, j: int, p: Params, x: torch.Tensor,
                  par: Optional[ModelParallel] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + FFN(norm2(x)) of sub-layer j and its MoE aux loss (None for a
    dense FFN or none at all).  With ``par`` the dense FFN's w1/w3 are
    this rank's columns and w2 its rows, and the MoE runs its experts'
    share (see ``forward``)."""
    if not _layer_has_ffn(cfg, j):
        return x, None
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.layer_is_moe(j):
        out, aux = moe_mod.moe_ffn(cfg, p["ffn"], h, par)
        return x + out, aux
    ffn = p["ffn"]
    if par is not None:
        h = par.to_model(h)
    out = mlp(cfg.mlp_variant, h, ffn["w1"], ffn["w2"], ffn.get("w3"))
    if par is not None:
        out = par.from_model(out)
    return x + out, None


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor,
          par: Optional[ModelParallel] = None) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if par is not None:
        return par.head(x, params)
    head = params.get("lm_head")
    if head is not None:
        return x @ head
    # A tied head reads the embedding transposed, its reduction axis
    # contiguous: on the card cuBLAS takes one row (a lone decode) by a GEMV
    # and a batch of rows by a GEMM, which sum in other orders, so a row's
    # logits would depend on the rows beside it.  One position a row (the
    # decode steps, the prefill's last logits) goes a row at a time.
    if x.shape[1] == 1 and x.shape[0] > 1:
        return torch.cat([r @ params["embed"].T for r in x.split(1)])
    return x @ params["embed"].T


def _sublayer(cfg: ModelConfig, j: int, p: Params, x: torch.Tensor,
              positions: torch.Tensor, par: Optional[ModelParallel] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         Optional[torch.Tensor]]:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    kind = _mixer_kind(cfg, j)
    # the MLA and Mamba2 mixers take the replicated input and put
    # ``to_model`` where their sharded parts start (their latent, B and C
    # are computed on every rank)
    if kind == "ssm":
        out, cache = mamba2.mamba2_forward(cfg, p["mixer"], h, par)
    elif kind == "mla":
        out, cache = attn.mla_attend_train(cfg, p["mixer"], h, positions,
                                           par)
    else:
        if par is not None:
            h = par.to_model(h)
        out, cache = attn.gqa_attend_train(cfg, p["mixer"], h, positions,
                                           par)
    if par is not None:
        out = par.from_model(out)
    x, aux = _ffn_residual(cfg, j, p, x + out, par)
    return x, cache, aux


def _block(cfg: ModelConfig, bp: Dict[str, Params], x: torch.Tensor,
           positions: torch.Tensor, par: Optional[ModelParallel] = None
           ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]],
                      List[torch.Tensor]]:
    """One block: its sub-layers in order.  bp: {"sub{j}": sub-layer j's
    parameters}, with ``par`` at ZeRO 3 this rank's data shards, gathered
    here (so a checkpointed block gathers them again in the backward).
    Returns (x, {"sub{j}": cache entries}, the MoE aux losses of its MoE
    sub-layers in order)."""
    if par is not None:
        bp = par.gather_block(bp)
    caches, auxes = {}, []
    for j, name in enumerate(_sub_names(cfg)):
        x, caches[name], a = _sublayer(cfg, j, bp[name], x, positions, par)
        if a is not None:
            auxes.append(a)
    return x, caches, auxes


def _block_params(blocks: Params) -> List[Dict[str, Params]]:
    """Each block's {"sub{j}": parameters} (views, see ``layer_params``)."""
    per_sub = {name: layer_params(sub) for name, sub in blocks.items()}
    n = len(next(iter(per_sub.values())))
    return [{name: layers[i] for name, layers in per_sub.items()}
            for i in range(n)]


def _embed_inputs(cfg: ModelConfig, params: Params,
                  batch: Dict[str, torch.Tensor],
                  par: Optional[ModelParallel] = None) -> torch.Tensor:
    """The token embeddings (b, s_text, d), after the modal prefix
    ``batch["modal_embeds"]`` (b, m, d) cast to their dtype when the config
    has one (transformer.py:140-148 of the JAX package)."""
    tok = (params["embed"][batch["tokens"]] if par is None
           else par.embed(params["embed"], batch["tokens"]))
    if not cfg.num_modal_tokens:
        return tok
    return torch.cat([batch["modal_embeds"].to(tok.dtype), tok], dim=1)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, want_cache: bool = False, last_only: bool = False,
            remat: bool = False, want_aux: bool = False,
            par: Optional[ModelParallel] = None) -> tuple:
    """Full-sequence forward (train / prefill).

    batch: tokens (b, s_text) integer [+ modal_embeds (b, m, d) for a VLM
    config, prepended, so s = m + s_text].  Returns (logits (b, s, V),
    cache or None), and with ``want_aux`` (logits, cache or None, aux):
    aux is the MoE load-balance loss summed over the layers, a float32 0-d
    tensor (0 without MoE), the JAX package's forward's second value.  The
    cache holds each layer's cache entries stacked: k/v (nb, b, s, K, hd) for
    GQA, c_kv (nb, b, s, r) and k_rope (nb, b, s, dr) for MLA, conv
    (nb, b, w - 1, di + 2n) and ssd (nb, b, h, p, n) float32 for Mamba2.
    ``last_only`` computes the logits of the last position only (b, 1, V),
    which is all a prefill needs.  ``remat`` checkpoints each block (the
    JAX package's ``jax.checkpoint(block_body)``): the backward recomputes
    a block's activations from its input instead of keeping them.  Each
    "sub{j}" of the cache holds sub-layer j's entries, stacked over the
    blocks.

    ``par`` (``parallel.collectives.ModelParallel``) runs one rank of the
    sharded train step on its shards: attention on its H/t heads (GQA's
    wq/wk/wv its heads; MLA's wq_b/wk_b/wv_b, from the latent every rank
    computes; wo their rows, one all-reduce after), the dense FFN on d_ff/t
    columns (w1/w3 columns, w2 rows, one all-reduce), the MoE on its E/t
    experts or f/t columns of each, Mamba2 on its SSD heads' channels
    (``sharding.ssm_split``), the
    embedding and head under the embed's vocab-or-d_model sharding, and at
    ZeRO 3 each leaf gathered over the data axis before use.  Without it
    (one device) none of that code runs.  With ``want_cache`` and ``par``
    (one rank of a sharded prefill) each cache entry is the rank's shard
    under ``sharding.prefill_cache_specs``: its rows of the batch (the
    caller passes the rank's rows), and its K/t heads of k and v, or its
    hd/t columns of them on the head_dim / seq fallback; MLA's latent
    replicated over the model axis; Mamba2's SSD state of its heads (the
    whole state when the model axis does not divide them) and its ch/t
    channels of the conv window.
    """
    _check_supported(cfg)
    if par is not None:
        params = par.gather_top(params)
    x = _embed_inputs(cfg, params, batch, par)        # (b, s, d)
    positions = torch.arange(x.shape[1], device=x.device)
    entries: Dict[str, Dict[str, List[torch.Tensor]]] = {}
    auxes: List[torch.Tensor] = []
    for bp in _block_params(params["blocks"]):
        if remat:
            x, caches, a = checkpoint(_block, cfg, bp, x, positions, par,
                                      use_reentrant=False)
        else:
            x, caches, a = _block(cfg, bp, x, positions, par)
        auxes.extend(a)
        if want_cache:
            for sub, cache in caches.items():
                for name, t in cache.items():
                    if name == "conv" and par is not None:
                        t = mamba2.conv_window_shard(cfg, t, par)
                    elif name == "ssd" and par is not None:
                        t = mamba2.ssd_state_shard(cfg, t, par)
                    entries.setdefault(sub, {}).setdefault(name, []).append(t)
    if last_only:
        x = x[:, -1:]
    logits = _head(cfg, params, x, par)
    caches = ({sub: {name: torch.stack(ts) for name, ts in cache.items()}
               for sub, cache in entries.items()} if want_cache else None)
    if not want_aux:
        return logits, caches
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
    return logits, caches, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits: (..., V); labels: (...)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# -------------------------------------------------------------- decode ------

def cache_slots(cfg: ModelConfig, cache_len: int) -> int:
    """Ring size: min(cache_len, sliding_window) slots."""
    return min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len


def cache_shapes(cfg: ModelConfig, batch_size: int, cache_len: int
                 ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{"sub{j}": {name: shape}} of the decode cache (``init_cache``)."""
    _check_supported(cfg)
    nb, b = cfg.num_layers // cfg.block_period, batch_size
    out = {}
    for j, sub in enumerate(_sub_names(cfg)):
        kind = _mixer_kind(cfg, j)
        if kind == "ssm":
            ch = cfg.d_inner + 2 * cfg.ssm_state
            out[sub] = {"conv": (nb, b, cfg.ssm_conv - 1, ch),
                        "ssd": (nb, b, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)}
        elif kind == "mla":
            out[sub] = {"c_kv": (nb, b, cache_len, cfg.kv_lora_rank),
                        "k_rope": (nb, b, cache_len, cfg.qk_rope_head_dim)}
        else:
            shape = (nb, b, cache_slots(cfg, cache_len), cfg.num_kv_heads,
                     cfg.head_dim)
            out[sub] = {"k": shape, "v": shape}
    return out


def local_cache_specs(cfg: ModelConfig, batch_size: int, cache_len: int,
                      mesh) -> Dict[str, Dict[str, tuple]]:
    """{"sub{j}": {name: spec}} of the decode cache of global batch
    ``batch_size`` on ``mesh`` (a DeviceMesh or {axis: size}):
    ``sharding.cache_specs``, with the axes a dim does not divide dropped
    (``enforce_divisibility``)."""
    shape = ShapeConfig("serve", cache_len, batch_size, "decode",
                        cache_len=cache_len)
    specs = sh.cache_specs(cfg, shape, mesh)
    return {sub: {name: sh.enforce_divisibility(specs[sub][name], full,
                                                mesh)
                  for name, full in leaves.items()}
            for sub, leaves in cache_shapes(cfg, batch_size,
                                            cache_len).items()}


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               par: Optional[ModelParallel] = None) -> Cache:
    """Zero-initialised decode cache, one "sub{j}" per sub-layer of the
    block, stacked over the nb blocks: ring buffers k/v (nb, b, S, K, hd)
    for GQA, c_kv (nb, b, S, r) and k_rope (nb, b, S, dr) for MLA; for
    Mamba2 the conv window (nb, b, w - 1, di + 2n) in ``dtype`` and the SSD
    state (nb, b, h, p, n) always in float32, whatever ``cache_len``.
    With ``par`` the rank's shard of the cache of global batch
    ``batch_size`` (``local_cache_specs``)."""
    shapes = cache_shapes(cfg, batch_size, cache_len)
    specs = (local_cache_specs(cfg, batch_size, cache_len, par.sizes)
             if par is not None else None)
    out = {}
    for sub, leaves in shapes.items():
        out[sub] = {}
        for name, shape in leaves.items():
            if specs is not None:
                shape = col.local_shape(shape, specs[sub][name], par.sizes)
            out[sub][name] = torch.zeros(
                shape, dtype=torch.float32 if name == "ssd" else dtype,
                device=device)
    return out


def cache_from_prefill(cfg: ModelConfig, prefill_caches: Cache,
                       cache_len: int,
                       par: Optional[ModelParallel] = None) -> Cache:
    """Ring caches from the stacked prefill entries (nb, b, s, ...), in
    fresh storage that never aliases the prefill output (decode writes it
    in place).  The sliding window bounds the GQA k/v rings only, as in
    the JAX package; MLA's c_kv/k_rope rings hold ``cache_len`` slots.
    Mamba2's conv window and SSD state have no sequence axis and are
    copied as they are.

    Position p goes to slot p % S.  When the prompt is longer than the
    ring (s > S), the last S positions are kept, each at its own slot; the
    JAX package keeps them at slots 0..S-1 instead, which agrees only when
    s % S == 0.

    With ``par`` the entries are one rank's prefill shards
    (``forward(..., par=...)``) and so are the rings, but that when the
    data axes split the slots (``par.seq_split``) each ring keeps the
    rank's S/d slots of the whole ring.
    """
    out = {}
    for j_name, sub in prefill_caches.items():
        if "ssd" in sub:
            out[j_name] = {name: arr.clone() for name, arr in sub.items()}
            continue
        conv = {}
        for name, arr in sub.items():
            s = arr.shape[2]
            S = cache_slots(cfg, cache_len) if name in ("k", "v") else cache_len
            if s >= S:
                conv[name] = torch.roll(arr[:, :, s - S:], (s - S) % S, dims=2)
            else:
                ring = arr.new_zeros(arr.shape[:2] + (S,) + arr.shape[3:])
                ring[:, :, :s] = arr
                conv[name] = ring
            if par is not None and par.seq_split:
                n = S // par.nd
                conv[name] = conv[name][:, :, par.data_idx * n:
                                        (par.data_idx + 1) * n].clone()
        out[j_name] = conv
    return out


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, pos, par: Optional[ModelParallel] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  tokens: (b, 1) integer; pos: int (absolute
    position of the incoming token) or (b,) tensor of per-row positions.
    Returns (logits (b, 1, V), cache); the cache is updated in place and
    the same tensors are returned.  A Mamba2 layer does not read ``pos``:
    its state holds the whole past.

    With ``par`` (one rank of a sharded decode): ``params`` are the rank's
    shards (over the data axes too when the serving weights split there:
    gathered before use, ``par.gather_top`` and ``par.gather_block``),
    ``tokens`` its rows, ``cache`` its shard (``init_cache(..., par=)``,
    ``cache_from_prefill(..., par=)``); the ring is placed on the global
    slot count (the rank's times the data axes' when they split the
    slots), each mixer runs its share and is summed over the model axis,
    and the logits are the rank's rows, its V/t columns when the head
    shards the vocabulary (``ModelParallel.head``)."""
    if par is not None:
        params = par.gather_top(params)
    x = (params["embed"][tokens] if par is None
         else par.embed(params["embed"], tokens))      # (b, 1, d)
    kinds = [_mixer_kind(cfg, j) for j in range(cfg.block_period)]
    ring = None
    for j, kind in enumerate(kinds):                   # every ring has S slots
        if kind != "ssm":
            sub = cache[f"sub{j}"]
            S = sub["c_kv" if kind == "mla" else "k"].shape[2]
            if par is None:
                ring = attn.ring_index(pos, S, x.shape[0], x.device)
                break
            n = par.nd if par.seq_split else 1
            ring = attn.shard_ring(
                attn.ring_index(pos, S * n, x.shape[0], x.device),
                (par.data_idx if n > 1 else 0) * S, S)
            break
    for i, bp in enumerate(_block_params(params["blocks"])):
        if par is not None:
            bp = par.gather_block(bp)
        for j, kind in enumerate(kinds):
            name = f"sub{j}"
            p = bp[name]
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            layer_cache = {k: t[i] for k, t in cache[name].items()}
            if kind == "ssm":
                out, new = mamba2.mamba2_decode(cfg, p["mixer"], h,
                                                layer_cache, par)
                for k, t in new.items():
                    layer_cache[k].copy_(t)
            elif kind == "mla":
                out, _ = attn.mla_attend_decode(cfg, p["mixer"], h,
                                                layer_cache, ring, par)
            else:
                out, _ = attn.gqa_attend_decode(cfg, p["mixer"], h,
                                                layer_cache, ring, par)
            if par is not None:
                out = par.from_model(out)
            x, _ = _ffn_residual(cfg, j, p, x + out, par)
    return _head(cfg, params, x, par), cache
