"""Parameters from the JAX package's pytree, handed over as numpy arrays.

The port never imports JAX: a caller that has a JAX parameter tree converts
its leaves to numpy first (bfloat16 through float32, which is exact) and
passes the nested dicts of arrays here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import FP32_LEAVES, param_shapes


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Port parameters from a nested dict of numpy arrays with the tree and
    the (stacked) shapes of the JAX package's ``init_params(cfg, key)``,
    cast to ``dtype`` but the leaves that are float32 in both packages
    (``FP32_LEAVES``, the MoE router).  Raises ValueError on a missing or
    extra leaf or a wrong shape."""
    def convert(shapes: Dict[str, Any], sub: Dict[str, Any], path: str):
        if set(shapes) != set(sub):
            raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                             f"{sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            where = f"{path}.{name}" if path else name
            if isinstance(shape, dict):
                out[name] = convert(shape, sub[name], where)
                continue
            arr = np.asarray(sub[name])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{where}: shape {arr.shape} != {shape}")
            out[name] = torch.from_numpy(np.array(arr)).to(
                device=device,
                dtype=torch.float32 if name in FP32_LEAVES else dtype)
        return out

    return convert(param_shapes(cfg), tree, "")
