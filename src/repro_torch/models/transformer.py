"""Model assembly for the dense GQA transformer: init, full-sequence forward
(train / prefill) with optional per-layer rematerialisation, the training
loss, ring caches and single-token decode.

The parameter tree is the JAX package's: ``embed`` (V, d), ``final_norm``
(d,), ``lm_head`` (d, V) unless the embeddings are tied, and
``blocks.sub0`` whose leaves are stacked along a leading ``n_blocks`` axis
(``norm1``, ``mixer.{wq,wk,wv,wo}``, ``norm2``, ``ffn.{w1,w2[,w3]}``).  The
forward walks the stacked layers in a Python loop.  Dense attention only:
no MoE, no SSM, no MLA.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import act, dense_init, embed_init, rms_norm

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.attention != "gqa" or cfg.block_period != 1 or cfg.num_experts
            or cfg.family == "ssm" or cfg.num_modal_tokens):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA text models only")


def _map_tree(fn: Callable, tree: dict, path: Tuple[str, ...] = ()) -> dict:
    return {k: _map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with a shape at each leaf."""
    _check_supported(cfg)
    nb, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    sub: Dict[str, Any] = {
        "norm1": (nb, d),
        "mixer": {k: (nb, *s) for k, s in attn.gqa_param_shapes(cfg).items()},
    }
    if f:
        ffn = {"w1": (nb, d, f), "w2": (nb, f, d)}
        if cfg.mlp_variant == "swiglu":
            ffn["w3"] = (nb, d, f)
        sub["norm2"] = (nb, d)
        sub["ffn"] = ffn
    shapes = {"embed": (cfg.vocab_size, d), "blocks": {"sub0": sub},
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> Params:
    """Random bfloat16 parameters drawn on ``device`` from a generator
    seeded with ``seed``: norms at 1, embeddings N(0, 0.02) truncated at 3
    sigma, every matrix truncated-normal with std = scale / sqrt(fan_in),
    fan_in being the first per-layer axis and scale 1/sqrt(2L) on the output
    projections ``wo`` and ``w2`` -- the JAX package's recipe (its random
    numbers differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out_scale = 1.0 / math.sqrt(2 * cfg.num_layers)

    def init(path, shape):
        name = path[-1]
        if name.startswith("norm") or name == "final_norm":
            return torch.ones(shape, dtype=torch.bfloat16, device=device)
        if name == "embed":
            return embed_init(gen, shape)
        fan_in = shape[1] if path[0] == "blocks" else shape[0]
        scale = out_scale if name in ("wo", "w2") else 1.0
        return dense_init(gen, shape, fan_in, scale=scale)

    return _map_tree(init, param_shapes(cfg))


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count (no allocation)."""
    return sum(math.prod(shape) for shape in _leaves(param_shapes(cfg)))


def layer_params(blocks: Params) -> List[Params]:
    """Each layer's slice of the stacked block parameters (views, no copy),
    from one ``unbind`` per leaf: its backward is one ``stack`` per leaf,
    where indexing each layer would fill and add a zero tensor the size of
    the whole stacked leaf for every layer."""
    per_leaf = _map_tree(lambda _, leaf: leaf.unbind(0), blocks)
    n = len(next(_leaves(per_leaf)))
    return [_map_tree(lambda _, views: views[i], per_leaf) for i in range(n)]


# ------------------------------------------------------------- forward ------

def _mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"]
    if cfg.mlp_variant == "swiglu":
        h = act("swiglu", h) * (x @ p["w3"])
    else:
        h = act("gelu", h)
    return h @ p["w2"]


def _ffn_residual(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if not cfg.d_ff:
        return x
    return x + _mlp_apply(cfg, p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def _block(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, kv = attn.gqa_attend_train(cfg, p["mixer"], h, positions)
    return _ffn_residual(cfg, p, x + out), kv


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, want_cache: bool = False, last_only: bool = False,
            remat: bool = False) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence forward (train / prefill).

    batch: tokens (b, s) integer.  Returns (logits (b, s, V), cache or
    None); the cache holds the stacked k/v (nb, b, s, K, hd).  (The JAX
    package's forward also returns an aux loss, which is 0 without MoE.)
    ``last_only`` computes the logits of the last position only (b, 1, V),
    which is all a prefill needs.  ``remat`` checkpoints each layer (the
    JAX package's ``jax.checkpoint(block_body)``): the backward recomputes
    a layer's activations from its input instead of keeping them.
    """
    _check_supported(cfg)
    x = params["embed"][batch["tokens"]]              # (b, s, d)
    positions = torch.arange(x.shape[1], device=x.device)
    ks, vs = [], []
    for p in layer_params(params["blocks"]["sub0"]):
        if remat:
            x, kv = checkpoint(_block, cfg, p, x, positions,
                               use_reentrant=False)
        else:
            x, kv = _block(cfg, p, x, positions)
        if want_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    if last_only:
        x = x[:, -1:]
    logits = _head(cfg, params, x)
    caches = ({"sub0": {"k": torch.stack(ks), "v": torch.stack(vs)}}
              if want_cache else None)
    return logits, caches


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


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """Zero-initialised decode cache of ring buffers (nb, b, S, K, hd)."""
    _check_supported(cfg)
    shape = (cfg.num_layers, batch_size, cache_slots(cfg, cache_len),
             cfg.num_kv_heads, cfg.head_dim)
    return {"sub0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


def cache_from_prefill(cfg: ModelConfig, prefill_caches: Cache,
                       cache_len: int) -> Cache:
    """Ring caches from the stacked prefill k/v (nb, b, s, ...), in fresh
    storage that never aliases the prefill output (decode writes it in
    place).

    Position p goes to slot p % S.  When the prompt is longer than the
    ring (s > S), the last S positions are kept, each at its own slot; the
    JAX package keeps them at slots 0..S-1 instead, which agrees only when
    s % S == 0.
    """
    out = {}
    for j_name, sub in prefill_caches.items():
        conv = {}
        for name, arr in sub.items():
            s = arr.shape[2]
            S = cache_slots(cfg, cache_len)
            if s >= S:
                conv[name] = torch.roll(arr[:, :, s - S:], (s - S) % S, dims=2)
            else:
                ring = arr.new_zeros(arr.shape[:2] + (S,) + arr.shape[3:])
                ring[:, :, :s] = arr
                conv[name] = ring
        out[j_name] = conv
    return out


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, pos) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  tokens: (b, 1) integer; pos: int (absolute
    position of the incoming token) or (b,) tensor of per-row positions.
    Returns (logits (b, 1, V), cache); the cache is updated in place and
    the same tensors are returned."""
    x = params["embed"][tokens]                        # (b, 1, d)
    sub = cache["sub0"]
    ring = attn.ring_index(pos, sub["k"].shape[2], x.shape[0], x.device)
    for i, p in enumerate(layer_params(params["blocks"]["sub0"])):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, _ = attn.gqa_attend_decode(
            cfg, p["mixer"], h, {"k": sub["k"][i], "v": sub["v"][i]}, ring)
        x = _ffn_residual(cfg, p, x + out)
    return _head(cfg, params, x), cache
