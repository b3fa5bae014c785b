"""Wrapper of the hand-written split-KV absorbed MLA decode kernel
(``csrc/flash_decode_mla.cu``): checks, allocation of the output and of the
float32 partials, launch of the partial and merge kernels, launch count.

It takes CUDA tensors only and raises on anything the kernel does not
take; ``repro_torch.kernels.dispatch.mla_flash_decode`` sends CPU tensors
to the plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

# the latent and rope widths flash_decode_mla.cu instantiates: deepseek-v2's
# (512, 64) and its smoke config's (32, 16)
LATENT_DIMS = (32, 512)
ROPE_DIMS = (16, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode_mla")
    lib.repro_flash_decode_mla.argtypes = [_P] * 9 + [_I] * 6 + [
        ctypes.c_float, _P]
    lib.repro_flash_decode_mla.restype = ctypes.c_int
    lib.repro_flash_decode_mla_block_s.argtypes = []
    lib.repro_flash_decode_mla_block_s.restype = ctypes.c_int
    return lib


@functools.cache
def _block_s() -> int:
    """Cache rows per block of the partial kernel (its ``BS``)."""
    return _lib().repro_flash_decode_mla_block_s()


def _check_inputs(q_lat: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor,
                  valid: torch.Tensor) -> None:
    tensors = (q_lat, q_rope, c_kv, k_rope, valid)
    refuse_grad("flash_decode_mla", tensors, "a decode backward")
    if q_lat.dtype not in DTYPE_CODES or any(
            t.dtype != q_lat.dtype for t in (q_rope, c_kv, k_rope)):
        raise TypeError(f"flash_decode_mla takes float32 or bfloat16 queries "
                        f"and caches of one dtype, got "
                        f"{[str(t.dtype) for t in tensors[:4]]}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if not all(t.ndim == 3 for t in tensors[:4]) or valid.ndim != 2:
        raise ValueError("shapes q_lat (b,H,r), q_rope (b,H,dr), c_kv (b,S,r),"
                         " k_rope (b,S,dr), valid (b,S)")
    b, H, r = q_lat.shape
    _, S, dr = k_rope.shape
    if (tuple(q_rope.shape) != (b, H, dr) or tuple(c_kv.shape) != (b, S, r)
            or k_rope.shape[0] != b or tuple(valid.shape) != (b, S)
            or H == 0 or S == 0):
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_rope {tuple(k_rope.shape)} and valid "
                         f"{tuple(valid.shape)} do not agree")
    if r not in LATENT_DIMS or dr not in ROPE_DIMS:
        raise ValueError(f"flash_decode_mla: latent dim {r} not in "
                         f"{LATENT_DIMS} or rope dim {dr} not in {ROPE_DIMS}")
    if not (q_lat.is_cuda and all(t.device == q_lat.device for t in tensors)):
        raise ValueError("flash_decode_mla takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_mla takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors[:4]):
        raise ValueError("flash_decode_mla reads 16 bytes at a time: queries "
                         "and caches must start 16-byte aligned")


def flash_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_kv: torch.Tensor, k_rope: torch.Tensor,
                     valid: torch.Tensor, *, denom: float) -> torch.Tensor:
    """q_lat: (b, H, r); q_rope: (b, H, dr); c_kv: (b, S, r); k_rope:
    (b, S, dr); valid: (b, S) bool or uint8; denom = sqrt(dn + dr).
    Returns o_lat (b, H, r) in c_kv's dtype; a row with no valid entry
    gives 0."""
    _check_inputs(q_lat, q_rope, c_kv, k_rope, valid)
    b, H, r = q_lat.shape
    _, S, dr = k_rope.shape
    ns = -(-S // _block_s())
    dev = q_lat.device
    acc = torch.empty((b, ns, H, r), dtype=torch.float32, device=dev)
    m = torch.empty((b, ns, H), dtype=torch.float32, device=dev)
    l = torch.empty((b, ns, H), dtype=torch.float32, device=dev)
    out = torch.empty((b, H, r), dtype=c_kv.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_flash_decode_mla(
        q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), valid.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), out.data_ptr(), b, S, H, r, dr,
        DTYPE_CODES[q_lat.dtype], float(denom), stream)
    if err:
        raise RuntimeError(f"flash_decode_mla launch failed: CUDA error {err}")
    LAUNCHES["flash_decode_mla"] += 1
    return out
