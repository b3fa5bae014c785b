"""Wrapper of the hand-written split-KV flash decode kernel
(``csrc/flash_decode.cu``): checks, the split size, allocation of the
output and of the float32 partials, launch of the partial and merge
kernels, launch count.

It takes CUDA tensors and raises on anything the kernel does not take;
``repro_torch.kernels.dispatch.flash_decode`` sends CPU tensors to the
plain version in ``ref.py`` instead.  On meta tensors it checks and
allocates as on the card and stops before the launch.  The split is
``kernels.meta.gqa_block_s``'s, on either device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, meta, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

HEAD_DIMS = (32, 64, 128, 160)   # the head dims flash_decode.cu instantiates

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    lib.repro_flash_decode_gqa.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _I, _I, _I, _I, _I, _I, _I,
                                           ctypes.c_float, _P]
    lib.repro_flash_decode_gqa.restype = ctypes.c_int
    return lib


def block_s(k_cache: torch.Tensor) -> int:
    """Cache rows per split the kernel uses for a (b, S, K, D) cache: a
    multiple of 64 chosen from (b, S, K) and the card's SM count (at
    llama3.2-3b's decode shape, 64).  The split-KV oracle
    ``gqa_decode_splitk(..., block_s=block_s(k_cache))`` rounds as the
    kernel does."""
    b, S, K, _ = k_cache.shape
    return meta.gqa_block_s(b, S, K, meta.sm_count(k_cache))


def _check_inputs(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, valid: torch.Tensor) -> None:
    tensors = (q, k_cache, v_cache, valid)
    refuse_grad("flash_decode_gqa", tensors, "a decode backward")
    if (q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"flash_decode_gqa takes float32 or bfloat16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q (b,1,H,D), caches (b,S,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != D or K == 0 or H % K
            or tuple(valid.shape) != (b, S) or S == 0):
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)} "
                         f"and valid {tuple(valid.shape)} do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode_gqa: head dim {D} not in {HEAD_DIMS}")
    if not ((q.is_cuda or meta.is_meta(q))
            and all(t.device == q.device for t in tensors)):
        raise ValueError("flash_decode_gqa takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_gqa takes contiguous tensors")


def flash_decode_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor, *,
                     softmax_scale: Optional[float] = None,
                     return_lse: bool = False):
    """q: (b, 1, H, D); k_cache, v_cache: (b, S, K, D); valid: (b, S) bool
    or uint8.  Returns (b, 1, H, D) in v's dtype; a row with no valid
    entry gives 0.  With ``return_lse``: (out (b, 1, H, D) float32, lse
    (b, H) float32, the log of each row's sum of exp(score)), for a merge
    of partial results across ranks (``parallel.collectives.
    merge_decode_partials``); a row with no valid entry gives out 0 and
    lse -inf."""
    _check_inputs(q, k_cache, v_cache, valid)
    b, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    bs = block_s(k_cache)
    ns = -(-S // bs)
    dev = q.device
    acc = torch.empty((b, ns, K, G, D), dtype=torch.float32, device=dev)
    m = torch.empty((b, ns, K, G), dtype=torch.float32, device=dev)
    l = torch.empty((b, ns, K, G), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, H, D), device=dev, dtype=torch.float32
                      if return_lse else v_cache.dtype)
    lse = (torch.empty((b, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    if meta.is_meta(q):
        meta.record("flash_decode_gqa", meta.gqa_decode_flops(b, S, H, D),
                    (q, k_cache, v_cache, valid), (out, lse))
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_flash_decode_gqa(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, S, H, K, D, bs, DTYPE_CODES[q.dtype], float(scale), stream)
    if err:
        raise RuntimeError(f"flash_decode_gqa launch failed: CUDA error {err}")
    LAUNCHES["flash_decode_gqa"] += 1
    return (out, lse) if return_lse else out
