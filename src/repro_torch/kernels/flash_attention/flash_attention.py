"""Wrappers of the hand-written flash attention kernels
(``csrc/flash_attention.cu``, forward, and ``csrc/flash_attention_bwd.cu``,
backward): checks, allocation, launch, launch count.

It takes CUDA tensors and raises on anything the kernel does not take;
``repro_torch.kernels.dispatch.attention`` sends CPU tensors to the plain
version in ``ref.py`` instead.  On meta tensors it checks and allocates
as on the card and stops before the launch (``kernels.meta``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, meta

# head dims each kernel was instantiated for (the switch in its .cu file)
FWD_HEAD_DIMS = (32, 48, 64, 128, 160, 192)
BWD_HEAD_DIMS = (32, 64, 128, 160, 192)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").repro_flash_attention
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 10 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, q_offset: int, head_dims: Tuple[int, ...],
                  name: str, **more: torch.Tensor) -> None:
    """Raises on what the kernel does not take, before any allocation or
    launch; ``more`` names the other tensors whose base pointers it copies
    from (the backward's o, do)."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q, k, v of "
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
    if D not in head_dims:
        raise ValueError(f"{name}: head dim {D} not in {head_dims}")
    if sq == 0 or sk == 0 or window < 0:
        raise ValueError(f"empty sequence or negative window ({sq}, {sk}, {window})")
    # at offset 0, rows past sk are rows the mask leaves with no key (as
    # they always were); a nonzero offset places rows among the keys
    if q_offset < 0 or (q_offset and q_offset + sq > sk):
        raise ValueError(f"{name}: query rows [{q_offset}, {q_offset + sq}) "
                         f"lie outside the {sk} key positions")
    # the kernels copy rows with 16-byte cp.async: a view at a storage
    # offset may start off that grid (a meta tensor's data_ptr is 0)
    for arg, t in dict(q=q, k=k, v=v, **more).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} takes 16-byte aligned tensors, got {arg} "
                             f"at data_ptr {t.data_ptr():#x}")
    if not ((q.is_cuda or meta.is_meta(q)) and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")


def _scale(D: int, softmax_scale: Optional[float]) -> float:
    return float(softmax_scale if softmax_scale is not None else D ** -0.5)


def _forward(q, k, v, causal, window, softmax_scale, want_lse, q_offset):
    _check_inputs(q, k, v, window, q_offset, FWD_HEAD_DIMS, "flash_attention")
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    o = torch.empty_like(q)
    lse = (torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if meta.is_meta(q):
        meta.record("flash_attention", meta.attention_flops(b, sq, sk, H, D),
                    (q, k, v), (o, lse))
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if want_lse else None, b, sq, sk, H, K, D,
        DTYPE_CODES[q.dtype], int(causal), int(window), int(q_offset),
        _scale(D, softmax_scale), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    if q_offset:
        LAUNCHES["flash_attention_offset"] += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softmax_scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D); H = K*G; key positions start
    at 0 and query row i sits at position ``q_offset + i`` (a nonzero
    offset needs q_offset + sq <= sk, and none may be negative, else
    ValueError).  Returns (b, sq, H, D) in q's dtype.  A
    query row the mask leaves with no key (a window with sq >= sk + window)
    gives 0, where the plain version gives the mean of V."""
    return _forward(q, k, v, causal, window, softmax_scale, False,
                    q_offset)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softmax_scale: Optional[float] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` that also returns each row's log-sum-exp of the
    masked scaled scores, float32 (b, H, sq), NEG_INF for a row with no
    live key: what the backward needs.  One launch of the same kernel."""
    return _forward(q, k, v, causal, window, softmax_scale, True, q_offset)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softmax_scale: Optional[float] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of the attention whose forward gave o and lse,
    for the output gradient do (b, sq, H, D).  Deterministic: no atomics.
    Keys that no query row reaches get exact zeros in dk and dv."""
    _check_inputs(q, k, v, window, q_offset, BWD_HEAD_DIMS,
                  "flash_attention_bwd", o=o, do=do)
    b, sq, H, D = q.shape
    _, sk, K, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or o.device != q.device \
            or do.device != q.device:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (b, H, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(b, H, sq)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd takes contiguous o, do, lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    if meta.is_meta(q):
        meta.record("flash_attention_bwd",
                    meta.attention_bwd_flops(b, sq, sk, H, D),
                    (q, k, v, o, lse, do), (dq, dk, dv))
        return dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, H, K, D,
        DTYPE_CODES[q.dtype], int(causal), int(window), int(q_offset),
        _scale(D, softmax_scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    if q_offset:
        LAUNCHES["flash_attention_bwd_offset"] += 1
    return dq, dk, dv
