"""Wrapper of the hand-written split-KV absorbed MLA decode kernel
(``csrc/flash_decode_mla.cu``): checks, the kernel's launch plan (split,
grid, where the splits merge), allocation of the output and, where the
splits merge in a second kernel, of the float32 partials, the launch,
launch count.

It takes CUDA tensors and raises on anything the kernel does not take;
``repro_torch.kernels.dispatch.mla_flash_decode`` sends CPU tensors to the
plain version in ``ref.py`` instead.  On meta tensors it checks and
allocates as on the card and stops before the launch.  The plan is
``kernels.meta.mla_plan``'s, on either device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, meta, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

# the latent and rope widths flash_decode_mla.cu instantiates: deepseek-v2's
# (512, 64) and its smoke config's (32, 16)
LATENT_DIMS = (32, 512)
ROPE_DIMS = (16, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode_mla")
    lib.repro_flash_decode_mla.argtypes = [_P] * 9 + [_I] * 8 + [
        ctypes.c_float, _P]
    lib.repro_flash_decode_mla.restype = ctypes.c_int
    lib.repro_flash_decode_mla_clusters.argtypes = [_I, _I, _I]
    lib.repro_flash_decode_mla_clusters.restype = ctypes.c_int
    return lib


def launch_plan(q_lat: torch.Tensor,
                c_kv: torch.Tensor) -> Tuple[int, Tuple[int, int, int], bool]:
    """The kernel's launch for queries (b, H, r) and a cache (b, S, r)
    (``kernels.meta.mla_plan``): (cache rows a split, grid
    (splits, head tiles, b), whether the splits merge inside one
    thread-block cluster rather than through float32 partials and a second
    kernel).  The split depends on S alone: 96 rows at deepseek-v2's
    decode shape (S=544), grid (6, 2, 8) in bf16."""
    b, H, _ = q_lat.shape
    return meta.mla_plan(b, c_kv.shape[1], H, q_lat.dtype == torch.bfloat16)


def block_s(q_lat: torch.Tensor, c_kv: torch.Tensor) -> int:
    """Cache rows per split the kernel uses: the split-KV oracle
    ``mla_decode_splitk(..., block_s=block_s(q_lat, c_kv))`` rounds p where
    the kernel does."""
    return launch_plan(q_lat, c_kv)[0]


def _resident_clusters(r: int, dr: int, ns: int) -> int:
    """Clusters of ns blocks of the bf16 body at widths (r, dr) that the
    current card holds at once (cudaOccupancyMaxActiveClusters)."""
    return _lib().repro_flash_decode_mla_clusters(r, dr, ns)


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
    if not ((q_lat.is_cuda or meta.is_meta(q_lat))
            and all(t.device == q_lat.device for t in tensors)):
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
    return _launch(q_lat, q_rope, c_kv, k_rope, valid, denom,
                   block_s(q_lat, c_kv))


def _launch(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
            k_rope: torch.Tensor, valid: torch.Tensor, denom: float,
            bs: int) -> torch.Tensor:
    """One launch at bs cache rows a split (a multiple of 16) on checked
    inputs; ``chip_smoke.py --mla-splits`` times other splits through it."""
    b, H, r = q_lat.shape
    _, S, dr = k_rope.shape
    (ns, _, _), fused = meta.mla_plan(b, S, H, q_lat.dtype == torch.bfloat16,
                                      bs)[1:]
    dev = q_lat.device
    n_part = 0 if fused else b * ns * H
    acc = torch.empty((n_part * r,), dtype=torch.float32, device=dev)
    m = torch.empty((n_part,), dtype=torch.float32, device=dev)
    l = torch.empty((n_part,), dtype=torch.float32, device=dev)
    out = torch.empty((b, H, r), dtype=c_kv.dtype, device=dev)
    if meta.is_meta(q_lat):
        meta.record("flash_decode_mla", meta.mla_decode_flops(b, S, H, r, dr),
                    (q_lat, q_rope, c_kv, k_rope, valid), (out,))
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_flash_decode_mla(
        q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), valid.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), out.data_ptr(), b, S, H, r, dr, bs, int(fused),
        DTYPE_CODES[q_lat.dtype], float(denom), stream)
    if err:
        raise RuntimeError(f"flash_decode_mla launch failed: CUDA error {err}")
    LAUNCHES["flash_decode_mla"] += 1
    return out
