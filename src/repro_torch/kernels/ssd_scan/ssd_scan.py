"""Wrappers of the hand-written SSD chunked-scan kernel
(``csrc/ssd_scan.cu``) and of its gradient (``csrc/ssd_scan_bwd.cu``):
checks, allocation of the outputs and of the float32 scratch (the scan's
bfloat16 path: each chunk's C.B^T, the segment states and their
log-decays; the gradient: see ``bwd_scratch``), the launch, launch count
-- one per call, however many CUDA kernels the call runs.

They take CUDA tensors and raise on anything the kernels do not take;
``repro_torch.kernels.dispatch.ssd`` sends CPU tensors to the plain
version in ``ref.py`` instead, and CUDA tensors that need a gradient to
the autograd op in ``ops.py``, whose backward is ``ssd_scan_bwd``.  On
meta tensors they check and allocate as on the card and stop before the
launch.  The segments are ``kernels.meta.ssd_segment_chunks``'s, on either
device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, meta, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES

# the (head dim P, state N) pairs ssd_scan.cu and ssd_scan_bwd.cu
# instantiate: mamba2-130m's (64, 128), a model rank's of it at t = 16 (32
# of each head's 64 channels: ``sharding.ssm_split``) and its smoke config's
# (32, 16)
SHAPES = ((32, 16), (32, 128), (64, 128))

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.repro_ssd_scan.argtypes = [_P] * 12 + [_I] * 7 + [_P]
    lib.repro_ssd_scan.restype = ctypes.c_int
    lib.repro_ssd_scan_chunk.argtypes = []
    lib.repro_ssd_scan_chunk.restype = ctypes.c_int
    _same_chunk("ssd_scan", lib.repro_ssd_scan_chunk(), meta.SSD_CHUNK)
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    lib.repro_ssd_scan_bwd.argtypes = [_P] * 23 + [_I] * 6 + [_P]
    lib.repro_ssd_scan_bwd.restype = ctypes.c_int
    lib.repro_ssd_scan_bwd_chunk.argtypes = []
    lib.repro_ssd_scan_bwd_chunk.restype = ctypes.c_int
    lib.repro_ssd_scan_bwd_heads_per_group.argtypes = [_I] * 5
    lib.repro_ssd_scan_bwd_heads_per_group.restype = ctypes.c_int
    _same_chunk("ssd_scan_bwd", lib.repro_ssd_scan_bwd_chunk(),
                meta.SSD_BWD_CHUNK)
    return lib


def _same_chunk(kernel: str, built: int, planned: int) -> None:
    """The wrappers size the scratch by ``kernels.meta``'s chunk: the
    kernel must walk that chunk."""
    if built != planned:
        raise RuntimeError(f"{kernel} walks chunks of {built} rows, its "
                           f"wrapper plans for {planned}")


@functools.cache
def chunk() -> int:
    """Rows per chunk of the kernel's walk (its ``L``)."""
    return _lib().repro_ssd_scan_chunk()


def segment_chunks(x: torch.Tensor) -> int:
    """Chunks per segment of the bfloat16 scan for a (b, s, h, p) x:
    chosen from (b, s, h) and the card's SM count so that the grid of
    (segment, head, batch) blocks fills the card (at mamba2-130m's b=8
    prefill, 4 chunks; at one 32,768-token prompt, 47)."""
    b, s, h, _ = x.shape
    return meta.ssd_segment_chunks(b, s, h, meta.sm_count(x))


def _check_inputs(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  dt_bias: torch.Tensor, *, kernel: str = "ssd_scan",
                  dy: Optional[torch.Tensor] = None,
                  d_state: Optional[torch.Tensor] = None) -> None:
    """Raises on what ``kernel`` does not take; ``dy`` and ``d_state`` are
    the gradient's further inputs."""
    more = tuple(t for t in (dy, d_state) if t is not None)
    tensors = (x, dt_raw, A_log, B, C, D, dt_bias) + more
    refuse_grad(kernel, tensors,
                "the SSD backward" if kernel == "ssd_scan"
                else "a second derivative of the SSD scan")
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype
                                         for t in (dt_raw, B, C)):
        raise TypeError(f"{kernel} takes float32 or bfloat16 x, dt_raw, B, C "
                        f"of one dtype, got {x.dtype}, {dt_raw.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (A_log, D, dt_bias)):
        raise TypeError(f"{kernel} takes float32 A_log, D and dt_bias")
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
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must have x's "
                         f"shape and dtype, {tuple(x.shape)} {x.dtype}")
    if d_state is not None and (tuple(d_state.shape) != (b, h, p, n)
                                or d_state.dtype != torch.float32):
        raise ValueError(f"d_state must be ({b}, {h}, {p}, {n}) float32, got "
                         f"{tuple(d_state.shape)} {d_state.dtype}")
    if (p, n) not in SHAPES:
        raise ValueError(f"{kernel}: (head dim, state) {(p, n)} not in "
                         f"{SHAPES}")
    if not ((x.is_cuda or meta.is_meta(x))
            and all(t.device == x.device for t in tensors)):
        raise ValueError(f"{kernel} takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} takes contiguous tensors")


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
    scratch, cps = [0, 0, 0], 0
    if x.dtype == torch.bfloat16:
        L = meta.SSD_CHUNK
        nc = -(-s // L)
        cps = segment_chunks(x)
        nseg = -(-nc // cps)
        cb = torch.empty((b, nc, L, L), dtype=torch.float32, device=dev)
        states = torch.empty((b, nseg - 1, h, p, n), dtype=torch.float32,
                             device=dev)
        segld = torch.empty((b, nseg - 1, h), dtype=torch.float32, device=dev)
        scratch = [cb.data_ptr(), states.data_ptr(), segld.data_ptr()]
    if meta.is_meta(x):
        meta.record("ssd_scan", meta.ssd_flops(b, s, h, p, n),
                    (x, dt_raw, A_log, B, C, D, dt_bias), (y, state))
        return y, state
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().repro_ssd_scan(
        x.data_ptr(), dt_raw.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
        state.data_ptr(), *scratch, b, s, h, p, n, cps, DTYPE_CODES[x.dtype],
        stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, state


@functools.cache
def bwd_chunk() -> int:
    """Rows per chunk of the gradient's walk."""
    return _bwd_lib().repro_ssd_scan_bwd_chunk()


def bwd_heads_per_group(x: torch.Tensor, n: int) -> int:
    """Heads a block of the bfloat16 gradient's grid for a (b, s, h, p) CUDA
    x and state width n: the card's clusters of ceil(h / it) blocks, one a
    (batch, chunk), take the fewest waves x heads a block (4 of 24 on an
    H100 at mamba2-130m's training microbatch)."""
    b, s, h, p = x.shape
    with torch.cuda.device(x.device):
        return _bwd_lib().repro_ssd_scan_bwd_heads_per_group(b, s, h, p, n)


def bwd_scratch(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype,
                chunk: int) -> dict:
    """The float32 scratch ``ssd_scan_bwd`` allocates, by name and shape,
    for the kernel's chunk of ``chunk`` rows (``bwd_chunk()``) and
    nc = ceil(s / chunk): each chunk's entering state and the gradient of its
    leaving state (``states``, ``grads``: (b, nc, h, p, n); in bfloat16 each
    eight floats end as their bf16 hi and lo halves), the chunks'
    log-decays (``cum_l``) and their shares of the (h,) gradients
    (``vec``); in bfloat16 each chunk's C.B^T (``cb``: (b, nc, chunk, chunk)),
    computed once per (batch, chunk) for all heads -- the heads' dB and dC
    are summed on chip; in float32 (the first version's body) the heads' dB
    and dC shares (``dbp``, ``dcp``: (b, s, h, n))."""
    nc = -(-s // chunk)
    plan = dict(states=(b, nc, h, p, n), grads=(b, nc, h, p, n),
                cum_l=(b, nc, h), vec=(3, b, nc, h))
    if dtype == torch.bfloat16:
        plan["cb"] = (b, nc, chunk, chunk)
    else:
        plan["dbp"] = plan["dcp"] = (b, s, h, n)
    return plan


def ssd_scan_bwd(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor, dy: torch.Tensor,
                 d_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan``: its inputs, dy (b, s, h, p) in x's
    dtype and, optionally, d_state (b, h, p, n) float32 for the final
    state.  Returns (dx, ddt_raw, dA_log, dB, dC, dD, ddt_bias), as
    ``ref.ssd_scan_bwd_ref``: dx, ddt_raw, dB, dC in the inputs' dtype, the
    (h,) vectors float32.  Allocates the scratch of ``bwd_scratch``."""
    _check_inputs(x, dt_raw, A_log, B, C, D, dt_bias, kernel="ssd_scan_bwd",
                  dy=dy, d_state=d_state)
    b, s, h, p = x.shape
    n = B.shape[2]
    dev = x.device
    dx, ddt_raw, dB, dC = (torch.empty_like(t) for t in (x, dt_raw, B, C))
    dA_log, dD, ddt_bias = (torch.empty((h,), dtype=torch.float32, device=dev)
                            for _ in range(3))
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=dev)
               for name, shape in bwd_scratch(b, s, h, p, n, x.dtype,
                                               meta.SSD_BWD_CHUNK).items()}
    if meta.is_meta(x):
        meta.record("ssd_scan_bwd", meta.ssd_bwd_flops(b, s, h, p, n),
                    (x, dt_raw, A_log, B, C, D, dt_bias, dy, d_state),
                    (dx, ddt_raw, dA_log, dB, dC, dD, ddt_bias))
        return dx, ddt_raw, dA_log, dB, dC, dD, ddt_bias
    ptr = {name: t.data_ptr() for name, t in scratch.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib().repro_ssd_scan_bwd(
        x.data_ptr(), dt_raw.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), dy.data_ptr(),
        None if d_state is None else d_state.data_ptr(), dx.data_ptr(),
        ddt_raw.data_ptr(), dA_log.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), ddt_bias.data_ptr(), ptr["states"], ptr["grads"],
        *(ptr.get(k) for k in ("cum_l", "cb", "dbp", "dcp")),
        ptr["vec"], b, s, h, p, n, DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt_raw, dA_log, dB, dC, dD, ddt_bias
