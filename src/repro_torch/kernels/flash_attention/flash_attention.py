"""Wrapper of the hand-written flash attention kernel
(``csrc/flash_attention.cu``): checks, allocation, launch, launch count.

It takes CUDA tensors only and raises on anything the kernel does not
take; ``repro_torch.kernels.dispatch.attention`` sends CPU tensors to the
plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build

HEAD_DIMS = (32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").repro_flash_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention takes CUDA tensors on one device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q (b,sq,H,D), k = v (b,sk,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    if k.shape[0] != b or k.shape[3] != D or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"agree on batch or head dim, or H is not a "
                         f"multiple of K")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if sq == 0 or sk == 0 or window < 0:
        raise ValueError(f"empty sequence or negative window ({sq}, {sk}, {window})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D); H = K*G; query and key
    positions both start at 0.  Returns (b, sq, H, D) in q's dtype.  A
    query row the mask leaves with no key (a window with sq >= sk + window)
    gives 0, where the plain version gives the mean of V."""
    _check_inputs(q, k, v, window)
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, H,
        K, D, DTYPE_CODES[q.dtype], int(causal), int(window), float(scale),
        stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
