"""Shape stand-ins and specs for every (arch x input-shape) combination:
tensors on the ``meta`` device (shape and dtype, no storage) beside their
specs over a mesh -- the JAX package's ``repro/launch/inputs.py``, whose
``ShapeDtypeStruct``s and shardings these mirror.  Nothing here allocates.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import init_cache, param_shapes
from repro_torch.models.transformer import FP32_LEAVES
from repro_torch.parallel import sharding as sh
from repro_torch.train.train_loop import state_specs


def default_train_config(cfg: ModelConfig, shape: ShapeConfig) -> TrainConfig:
    """Serverless default: MARP-style auto choice of ZeRO level + microbatch."""
    from repro_torch.core.memory_model import analytic_param_count
    big = analytic_param_count(cfg) > 20e9
    return TrainConfig(global_batch=shape.global_batch, seq_len=shape.seq_len,
                       microbatch=1, zero=3 if big else 1)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta_tree(shapes: Dict[str, Any], dtype=None) -> Dict[str, Any]:
    """Meta tensors over ``param_shapes``: bf16 but ``FP32_LEAVES`` (or
    all in ``dtype``)."""
    return {k: _meta_tree(v, dtype) if isinstance(v, dict) else _meta(
        v, dtype or (torch.float32 if k in FP32_LEAVES else torch.bfloat16))
        for k, v in shapes.items()}


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Input batch stand-ins for train/prefill shapes."""
    B, s = shape.global_batch, shape.seq_len
    text = s - cfg.num_modal_tokens
    if text <= 0:
        raise ValueError(f"{cfg.name}: {shape.name} leaves no text positions")
    batch = {"tokens": _meta((B, text), torch.int32)}
    if cfg.num_modal_tokens:
        batch["modal_embeds"] = _meta((B, cfg.num_modal_tokens, cfg.d_model),
                                      torch.bfloat16)
    if shape.kind == "train":
        batch["labels"] = _meta((B, s), torch.int32)
    return batch


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, tc: TrainConfig):
    """(state, batch), (state specs, batch specs)."""
    shapes = param_shapes(cfg)
    state = {"params": _meta_tree(shapes),
             "opt": {k: _meta_tree(shapes, torch.float32)
                     for k in ("master", "m", "v")},
             "step": _meta((), torch.int32)}
    return ((state, batch_struct(cfg, shape)),
            (state_specs(cfg, tc, mesh, shapes), sh.batch_specs(cfg, shape, mesh)))


def params_inputs(cfg: ModelConfig, mesh, *, zero_data: bool = False):
    shapes = param_shapes(cfg)
    return _meta_tree(shapes), sh.param_specs(cfg, shapes, mesh,
                                              zero_data=zero_data)


def serve_weights_over_data(cfg: ModelConfig, mesh) -> bool:
    """2-D weight sharding for decode: when bf16 weights exceed ~60% of a
    16 GiB chip at model-axis-only sharding, serving params also shard
    over the data axes (the JAX package's rule, kept as it is)."""
    from repro_torch.core.memory_model import analytic_param_count
    tp = sh.axis_sizes(mesh).get("model", 1)
    w_bytes = 2.0 * analytic_param_count(cfg) / tp
    return w_bytes > 0.6 * 16 * 1024 ** 3


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(params, tokens, cache, pos) stand-ins + specs for a decode step,
    the params over the data axes too where ``serve_weights_over_data``
    says so."""
    B = shape.global_batch
    zero_data = serve_weights_over_data(cfg, mesh)
    params, p_spec = params_inputs(cfg, mesh, zero_data=zero_data)
    cache = init_cache(cfg, B, shape.cache_len, device="meta")
    c_spec = sh.cache_specs(cfg, shape, mesh)
    c_specs = {j: {k: sh.enforce_divisibility(c_spec[j][k],
                                              tuple(sub[k].shape), mesh)
                   for k in sub}
               for j, sub in cache.items()}
    dax = sh._data_spec_entry(mesh)
    tok_spec = (dax, None) if B % max(sh._n_data(mesh), 1) == 0 \
        else (None, None)
    return ((params, _meta((B, 1), torch.int32), cache,
             _meta((), torch.int32)),
            (p_spec, tok_spec, c_specs, ()))


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh
                   ) -> Tuple[Tuple[Any, Any], Tuple[Any, Any]]:
    params, p_spec = params_inputs(cfg, mesh)
    return ((params, batch_struct(cfg, shape)),
            (p_spec, sh.batch_specs(cfg, shape, mesh)))
