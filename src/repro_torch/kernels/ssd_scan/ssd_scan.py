"""Wrapper of the hand-written SSD chunked-scan kernel
(``csrc/ssd_scan.cu``): checks, allocation of y, of the float32 final
state and of the bfloat16 path's float32 scratch (each chunk's C.B^T, the
segment states and their log-decays), the launch, launch count -- one per
call, however many CUDA kernels the call runs.

It takes CUDA tensors only and raises on anything the kernel does not
take; ``repro_torch.kernels.dispatch.ssd`` sends CPU tensors to the plain
version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

# the (head dim P, state N) pairs ssd_scan.cu instantiates: mamba2-130m's
# (64, 128) and its smoke config's (32, 16)
SHAPES = ((32, 16), (64, 128))

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.repro_ssd_scan.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    lib.repro_ssd_scan.restype = ctypes.c_int
    lib.repro_ssd_scan_chunk.argtypes = []
    lib.repro_ssd_scan_chunk.restype = ctypes.c_int
    lib.repro_ssd_scan_segment_chunks.argtypes = [_I, _I, _I]
    lib.repro_ssd_scan_segment_chunks.restype = ctypes.c_int
    return lib


@functools.cache
def chunk() -> int:
    """Rows per chunk of the kernel's walk (its ``L``)."""
    return _lib().repro_ssd_scan_chunk()


@functools.cache
def _segment_chunks(b: int, s: int, h: int, device_index: int) -> int:
    with torch.cuda.device(device_index):
        return _lib().repro_ssd_scan_segment_chunks(b, s, h)


def segment_chunks(x: torch.Tensor) -> int:
    """Chunks per segment of the bfloat16 scan for a (b, s, h, p) CUDA x:
    chosen from (b, s, h) and the card's SM count so that the grid of
    (segment, head, batch) blocks fills the card (at mamba2-130m's b=8
    prefill, 4 chunks; at one 32,768-token prompt, 47)."""
    b, s, h, _ = x.shape
    return _segment_chunks(b, s, h, x.device.index or 0)


def _check_inputs(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  dt_bias: torch.Tensor) -> None:
    tensors = (x, dt_raw, A_log, B, C, D, dt_bias)
    refuse_grad("ssd_scan", tensors, "the SSD backward")
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
    dev = x.device
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = [0, 0, 0]
    if x.dtype == torch.bfloat16:
        L = chunk()
        nc = -(-s // L)
        nseg = -(-nc // segment_chunks(x))
        cb = torch.empty((b, nc, L, L), dtype=torch.float32, device=dev)
        states = torch.empty((b, nseg - 1, h, p, n), dtype=torch.float32,
                             device=dev)
        segld = torch.empty((b, nseg - 1, h), dtype=torch.float32, device=dev)
        scratch = [cb.data_ptr(), states.data_ptr(), segld.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_ssd_scan(
        x.data_ptr(), dt_raw.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
        state.data_ptr(), *scratch, b, s, h, p, n, DTYPE_CODES[x.dtype],
        stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, state
