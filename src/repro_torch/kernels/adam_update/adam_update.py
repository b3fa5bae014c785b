"""Wrapper of the hand-written fused Adam kernel (``csrc/adam_update.cu``):
checks, launch, launch count.

It takes CUDA tensors only and raises on anything the kernel does not
take; ``repro_torch.kernels.dispatch.adam_update_leaf`` sends CPU tensors
to the plain version in ``ref.py`` instead.  Unlike the plain version it
updates in place: m, v and master are overwritten and the parameter
receives master' rounded to its own dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build

PARAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _kernel():
    fn = _build.load("adam_update").repro_adam_update
    fn.argtypes = [_P, _P, _P, _P, _P, _I, ctypes.c_longlong,
                   _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(g, m, v, master, param) -> None:
    state = (g, m, v, master)
    if not all(t.is_cuda and t.device == g.device for t in state + (param,)):
        raise ValueError("adam_update takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in state) \
            or param.dtype not in PARAM_DTYPES:
        raise TypeError(f"adam_update takes float32 g, m, v, master and a "
                        f"float32 or bfloat16 param, got "
                        f"{[t.dtype for t in state + (param,)]}")
    if any(t.shape != g.shape for t in state + (param,)) or g.numel() == 0:
        raise ValueError(f"adam_update takes g, m, v, master and param of one "
                         f"non-empty shape, got "
                         f"{[tuple(t.shape) for t in state + (param,)]}")
    if not all(t.is_contiguous() for t in state + (param,)):
        raise ValueError("adam_update takes contiguous tensors")
    # the kernel moves four elements per access: 16 bytes of each fp32
    # stream and 4 elements of the parameter
    if any(t.data_ptr() % 16 for t in state) \
            or param.data_ptr() % (4 * param.element_size()):
        raise ValueError("adam_update takes tensors aligned to 4 elements")


def adam_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                master: torch.Tensor, param: torch.Tensor, *, lr: float,
                beta1: float, beta2: float, eps: float, wd: float, c1: float,
                c2: float) -> None:
    """One Adam step on one leaf, in place: m, v, master <- m', v',
    master' and param <- master' in param's dtype."""
    _check_inputs(g, m, v, master, param)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    n_sm = torch.cuda.get_device_properties(g.device).multi_processor_count
    err = _kernel()(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
        param.data_ptr(), PARAM_DTYPES[param.dtype], g.numel(), float(lr),
        float(beta1), 1 - beta1, float(beta2), 1 - beta2, float(eps),
        float(wd), float(c1), float(c2), n_sm, stream)
    if err:
        raise RuntimeError(f"adam_update launch failed: CUDA error {err}")
    LAUNCHES["adam_update"] += 1
