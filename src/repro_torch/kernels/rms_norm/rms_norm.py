"""Wrappers of the hand-written RMSNorm kernels (``csrc/rms_norm.cu``):
checks, allocation, launch, launch count.

``rms_norm`` is the forward (with ``z``, Mamba2's gated norm), counted
under ``LAUNCHES["rms_norm"]``; ``rms_norm_bwd`` its gradient, counted
under ``LAUNCHES["rms_norm_bwd"]``.  They take CUDA tensors and raise on
anything the kernels do not take; ``repro_torch.kernels.dispatch`` sends
CPU tensors to the plain versions in ``ref.py`` instead.  On meta tensors
they check and allocate as on the card and stop before the launch
(``kernels.meta``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, meta, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = _build.load("rms_norm")
    lib.repro_rms_norm.argtypes = [_P, _P, _P, _P, _P, _L, _I, _L, _L, _I,
                                   _I, _I, _I, ctypes.c_float, _P]
    lib.repro_rms_norm_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _L, _I, _L, _L, _I, _I, _I, _I, _I, _P]
    lib.repro_rms_norm.restype = lib.repro_rms_norm_bwd.restype = ctypes.c_int
    return lib


def _row_stride(t: torch.Tensor, name: str, kernel: str) -> int:
    """Elements between two rows of t (..., d): its last axis contiguous,
    its rows a fixed number of elements apart (a slice of a wider last
    axis, such as MLA's kv[..., :r_kv]), 16-byte aligned."""
    d = t.shape[-1]
    if t.stride(-1) != 1:
        raise ValueError(f"{kernel} takes {name} with a contiguous last axis,"
                         f" got strides {t.stride()}")
    stride, span = d, None
    for size, st in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if span is None:
            stride = span = st
        elif st != span:
            raise ValueError(f"{kernel} takes {name} whose rows are evenly "
                             f"spaced, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
        span *= size
    if stride < d or (stride * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{kernel} takes {name} whose rows start on the "
                         f"16-byte grid and do not overlap, got row stride "
                         f"{stride}, data_ptr {t.data_ptr():#x}")
    return stride


def _check(kernel: str, x: torch.Tensor, scale: torch.Tensor,
           z: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """The checks both kernels make of x, scale and z: returns (d, x's row
    stride, z's row stride)."""
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} takes float32 or bfloat16 x and scale, got"
                        f" {x.dtype}, {scale.dtype}")
    d = x.shape[-1] if x.ndim else 0
    if x.ndim == 0 or x.numel() == 0 or scale.shape != (d,):
        raise ValueError(f"{kernel} takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if z is not None and (z.shape != x.shape or z.dtype != x.dtype):
        raise ValueError(f"{kernel} takes a gate z of x's shape and dtype, got"
                         f" {tuple(z.shape)} {z.dtype} beside {tuple(x.shape)}"
                         f" {x.dtype}")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"{kernel}: width {d} is not a multiple of {vec}"
                         f" (16-byte chunks)")
    if d > meta.NORM_MAX_WIDTH:
        raise ValueError(f"{kernel}: width {d} is past the widest row the "
                         f"kernel holds in registers, {meta.NORM_MAX_WIDTH}")
    tensors = (x, scale) if z is None else (x, scale, z)
    if not ((x.is_cuda or meta.is_meta(x))
            and all(t.device == x.device for t in tensors)):
        raise ValueError(f"{kernel} takes CUDA tensors on one device")
    if not scale.is_contiguous() or scale.data_ptr() % min(
            16, vec * scale.element_size()):
        raise ValueError(f"{kernel} takes a contiguous scale aligned to its "
                         f"chunks")
    zs = 0 if z is None else _row_stride(z, "z", kernel)
    return d, _row_stride(x, "x", kernel), zs


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             z: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm of u (..., d) over its last axis with scale (d,), u = x, or
    with z, u = x * silu(z) (the gate in float32 rounded to x's dtype, the
    product too): returns y in x's dtype, contiguous, and rstd =
    rsqrt(mean(u^2) + eps) per row (x.shape[:-1], float32).  x and z may
    be strided rows (``_row_stride``).  A row's output does not depend on
    the other rows."""
    refuse_grad("rms_norm", (x, scale) if z is None else (x, scale, z),
                "its backward runs in kernels/rms_norm/ops.py, not here")
    d, xs, zs = _check("rms_norm", x, scale, z)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if meta.is_meta(x):
        meta.record("rms_norm", 0, (x, z, scale), (y, rstd))
        return y, rstd
    rows = x.numel() // d
    warps, per_block = meta.rms_norm_fwd_plan(rows, d)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_rms_norm(
        x.data_ptr(), None if z is None else z.data_ptr(), scale.data_ptr(),
        y.data_ptr(), rstd.data_ptr(), rows, d, xs, zs, warps,
        per_block, DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype],
        float(eps), stream)
    if err:
        raise RuntimeError(f"rms_norm launch failed: CUDA error {err}")
    LAUNCHES["rms_norm"] += 1
    return y, rstd


def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 rstd: torch.Tensor, z: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``rms_norm`` for the output gradient g (x's shape
    and dtype, contiguous), from its inputs and its row scales rstd:
    (dx, dscale), or with z (dx, dz, dscale), as ``ref.rms_norm_bwd_ref``
    and ``ref.gated_rms_norm_bwd_ref``; dx and dz contiguous in x's
    dtype, dscale in scale's.  Allocates a (blocks, d) float32 scratch of
    dscale's partial sums (``meta.rms_norm_bwd_blocks``)."""
    refuse_grad("rms_norm_bwd", (g, x, scale, rstd) if z is None
                else (g, x, scale, rstd, z), "no second derivative is written")
    d, xs, zs = _check("rms_norm_bwd", x, scale, z)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() \
            or g.device != x.device:
        raise ValueError(f"rms_norm_bwd takes a contiguous g of x's shape, "
                         f"dtype and device, got {tuple(g.shape)} {g.dtype}")
    if rstd.shape != x.shape[:-1] or rstd.dtype != torch.float32 \
            or not rstd.is_contiguous() or rstd.device != x.device:
        raise ValueError(f"rms_norm_bwd takes the forward's float32 rstd of "
                         f"shape {tuple(x.shape[:-1])}, got {tuple(rstd.shape)}"
                         f" {rstd.dtype}")
    rows = x.numel() // d
    blocks = meta.rms_norm_bwd_blocks(rows, d)
    dev = x.device
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dz = None if z is None else torch.empty(x.shape, dtype=x.dtype, device=dev)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=dev)
    dscale = torch.empty_like(scale)
    grads = (dx, dscale) if z is None else (dx, dz, dscale)
    if meta.is_meta(x):
        meta.record("rms_norm_bwd", 0, (g, x, z, scale, rstd), grads)
        return grads
    warps, per_block = meta.rms_norm_plan(d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_rms_norm_bwd(
        g.data_ptr(), x.data_ptr(), None if z is None else z.data_ptr(),
        scale.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        None if dz is None else dz.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), rows, d, xs, zs, warps, per_block, blocks,
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], stream)
    if err:
        raise RuntimeError(f"rms_norm_bwd launch failed: CUDA error {err}")
    LAUNCHES["rms_norm_bwd"] += 1
    return grads
