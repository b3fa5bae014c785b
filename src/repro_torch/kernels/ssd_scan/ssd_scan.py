"""Wrapper of the hand-written SSD chunked-scan kernel
(``csrc/ssd_scan.cu``): checks, allocation of y and of the float32 final
state, the launch, launch count.

It takes CUDA tensors only and raises on anything the kernel does not
take; ``repro_torch.kernels.dispatch.ssd`` sends CPU tensors to the plain
version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

# the (head dim P, state N) pairs ssd_scan.cu instantiates: mamba2-130m's
# (64, 128) and its smoke config's (32, 16)
SHAPES = ((32, 16), (64, 128))

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.repro_ssd_scan.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.repro_ssd_scan.restype = ctypes.c_int
    lib.repro_ssd_scan_chunk.argtypes = []
    lib.repro_ssd_scan_chunk.restype = ctypes.c_int
    return lib


@functools.cache
def chunk() -> int:
    """Rows per chunk of the kernel's walk (its ``L``)."""
    return _lib().repro_ssd_scan_chunk()


def _check_inputs(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  dt_bias: torch.Tensor) -> None:
    tensors = (x, dt_raw, A_log, B, C, D, dt_bias)
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype
                                         for t in (dt_raw, B, C)):
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, dt_raw, B, C "
                        f"of one dtype, got {x.dtype}, {dt_raw.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (A_log, D, dt_bias)):
        raise TypeError("ssd_scan takes float32 A_log, D and dt_bias")
    if x.ndim != 4 or dt_raw.ndim != 3 or B.ndim != 3 or B.shape != C.shape:
        raise ValueError(f"shapes x (b,s,h,p), dt_raw (b,s,h), B and C "
                         f"(b,s,n), got {tuple(x.shape)}, "
                         f"{tuple(dt_raw.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    n = B.shape[2]
    if (tuple(dt_raw.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s)
            or any(tuple(t.shape) != (h,) for t in (A_log, D, dt_bias))
            or 0 in (b, s, h)):
        raise ValueError(f"x {tuple(x.shape)}, dt_raw {tuple(dt_raw.shape)}, "
                         f"B {tuple(B.shape)} and the (h,) vectors "
                         f"{[tuple(t.shape) for t in (A_log, D, dt_bias)]} "
                         f"do not agree")
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan: (head dim, state) {(p, n)} not in "
                         f"{SHAPES}")
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_scan takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan takes contiguous tensors")


def ssd_scan(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt_raw (pre-softplus): (b, s, h); A_log, D,
    dt_bias: (h,) float32; B, C: (b, s, n).  Returns (y (b, s, h, p) in x's
    dtype, final state (b, h, p, n) float32)."""
    _check_inputs(x, dt_raw, A_log, B, C, D, dt_bias)
    b, s, h, p = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_ssd_scan(
        x.data_ptr(), dt_raw.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
        state.data_ptr(), b, s, h, p, n, DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, state
