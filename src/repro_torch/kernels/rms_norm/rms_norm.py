"""Wrapper of the hand-written RMSNorm kernel (``csrc/rms_norm.cu``):
checks, allocation, launch, launch count.

It takes CUDA tensors and raises on anything the kernel does not take;
``repro_torch.kernels.dispatch.rms_norm`` sends CPU tensors to the plain
version in ``ref.py`` instead.  On meta tensors it checks and allocates as
on the card and stops before the launch (``kernels.meta``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, meta, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    fn = _build.load("rms_norm").repro_rms_norm
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm of x (..., d) over its last axis with scale (d,): returns y
    in x's dtype and rstd = rsqrt(mean(x^2) + eps) per row (x.shape[:-1],
    float32).  A row's output does not depend on the other rows."""
    refuse_grad("rms_norm", (x, scale), "its backward runs in "
                "kernels/rms_norm/ops.py, not here")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"rms_norm takes float32 or bfloat16 x and scale, got "
                        f"{x.dtype}, {scale.dtype}")
    d = x.shape[-1] if x.ndim else 0
    if x.ndim == 0 or x.numel() == 0 or scale.shape != (d,):
        raise ValueError(f"rms_norm takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"rms_norm: width {d} is not a multiple of {vec}"
                         f" (16-byte chunks)")
    if not ((x.is_cuda or meta.is_meta(x)) and scale.device == x.device):
        raise ValueError("rms_norm takes CUDA tensors on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm takes contiguous x and scale")
    if x.data_ptr() % 16:
        raise ValueError(f"rms_norm takes a 16-byte aligned x, got data_ptr "
                         f"{x.data_ptr():#x}")
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if meta.is_meta(x):
        meta.record("rms_norm", 0, (x, scale), (y, rstd))
        return y, rstd
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                    rstd.data_ptr(), x.numel() // d, d, DTYPE_CODES[x.dtype],
                    DTYPE_CODES[scale.dtype], float(eps), stream)
    if err:
        raise RuntimeError(f"rms_norm launch failed: CUDA error {err}")
    LAUNCHES["rms_norm"] += 1
    return y, rstd
