"""Kernel dispatch: the ops the model calls, chosen by the device of the
input tensors.

* a CUDA tensor goes to the hand-written kernel, which launches or raises
  (attention and the SSD scan that must be differentiated go through the
  autograd ops whose forward and backward are kernels; RMSNorm through
  one whose forward is the kernel and whose backward is PyTorch, as the
  JAX package has no kernel for it);
* a CPU tensor goes to the plain PyTorch version in the kernel's ``ref.py``
  (whose gradient, where one is taken, is PyTorch's autograd);
* a meta tensor goes to the kernel's wrapper and autograd op, as a CUDA
  tensor does: the wrapper allocates what it allocates on the card and
  skips the launch (``kernels.meta``), so the dry run
  (``launch.dryrun``) holds the card's tensors, not the plain versions'.

There is no environment variable, no fallback on error and no capability
check: a card the kernel was not built for fails loudly.  ``force("ref")``
runs the plain version on any device; tests and ``chip_smoke.py`` use it to
hold the kernel path against the plain path on the card.

With the observability plane's metrics enabled (``repro_torch.obs``), each
op counts its calls as ``ops/<op>`` under the JAX package's op names
(``attention``, ``flash_decode``, ``mla_flash_decode``, ``ssd_scan``,
``adam_update``; RMSNorm, which the JAX package does not dispatch, as
``rms_norm``); disabled, that costs two attribute reads a call.  With
``op_timing=True`` too, each call's host time goes to the histogram
``ops_s/<op>``, as the JAX package's dispatch records it: the call is not
synchronized, so on the card it is the time to check, allocate and
launch, not the kernel's run.  A call on meta tensors is not timed, as the
JAX package does not time a call under a trace.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.adam_update import adam_ref, adam_update
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_trainable)
from repro_torch.kernels.flash_decode import (flash_decode_gqa,
                                              flash_decode_mla,
                                              gqa_decode_ref, mla_decode_ref)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_ref,
                                          ssd_scan_trainable)
from repro_torch.kernels.rms_norm import (rms_norm_ref, rms_norm_trainable)
from repro_torch.kernels.rms_norm import rms_norm as rms_norm_kernel
from repro_torch.obs.metrics import METRICS

_forced_ref = False


@contextmanager
def force(impl: Optional[str]) -> Iterator[None]:
    """``force("ref")`` sends every op to its plain version while the
    context is open; ``force(None)`` restores choice by device."""
    global _forced_ref
    if impl not in (None, "ref"):
        raise ValueError(f"force() takes 'ref' or None, got {impl!r}")
    prev, _forced_ref = _forced_ref, impl == "ref"
    try:
        yield
    finally:
        _forced_ref = prev


def _use_kernel(x: torch.Tensor) -> bool:
    if _forced_ref or x.device.type == "cpu":
        return False
    if x.device.type in ("cuda", "meta"):
        return True
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _call(op: str, x: torch.Tensor, fn: Callable, *args, **kw):
    """``fn(*args, **kw)``, its host time recorded as ``ops_s/<op>`` when
    the metrics time ops and ``x`` is not a meta tensor."""
    if METRICS.op_timing and not meta.is_meta(x):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        METRICS.observe("ops_s/" + op, time.perf_counter() - t0)
        return out
    return fn(*args, **kw)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softmax_scale: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, H, D); k, v: (b, sk, K, D), H = K*G.  Returns (b, sq, H, D).
    Key positions start at 0 and query row i sits at ``q_offset + i``."""
    if METRICS.enabled:
        METRICS.inc("ops/attention")
    if not _use_kernel(q):
        fn = attention_ref
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        fn = flash_attention_trainable
    else:
        fn = flash_attention
    return _call("attention", q, fn, q, k, v, causal=causal, window=window,
                 softmax_scale=softmax_scale, q_offset=q_offset)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor, *,
                 softmax_scale: Optional[float] = None,
                 return_lse: bool = False):
    """Single-token GQA attention over a (ring) KV cache.

    q: (b, 1, H, D); k_cache, v_cache: (b, S, K, D); valid: (b, S) bool.
    Returns (b, 1, H, D); with ``return_lse``, (out float32, its
    log-sum-exp (b, H) float32) for a merge across ranks."""
    if METRICS.enabled:
        METRICS.inc("ops/flash_decode")
    fn = flash_decode_gqa if _use_kernel(q) else gqa_decode_ref
    return _call("flash_decode", q, fn, q, k_cache, v_cache, valid,
                 softmax_scale=softmax_scale, return_lse=return_lse)


def mla_flash_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_kv: torch.Tensor, k_rope: torch.Tensor,
                     valid: torch.Tensor, *, denom: float) -> torch.Tensor:
    """Matrix-absorbed MLA decode attention in latent space.

    q_lat: (b, H, r); q_rope: (b, H, dr); c_kv: (b, S, r); k_rope:
    (b, S, dr); valid: (b, S) bool; denom = sqrt(dn + dr).  Returns o_lat
    (b, H, r)."""
    if METRICS.enabled:
        METRICS.inc("ops/mla_flash_decode")
    fn = flash_decode_mla if _use_kernel(q_lat) else mla_decode_ref
    return _call("mla_flash_decode", q_lat, fn, q_lat, q_rope, c_kv, k_rope,
                 valid, denom=denom)


def ssd(x: torch.Tensor, dt_raw: torch.Tensor, A_log: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
        dt_bias: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan, one B/C group.  x: (b, s, h, p); dt_raw
    (pre-softplus): (b, s, h); A_log, D, dt_bias: (h,) float32; B, C:
    (b, s, n).  Returns (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) float32).  ``chunk`` is the plain version's chunk length;
    the kernel walks chunks of its own length (chunking is exact in math)."""
    if METRICS.enabled:
        METRICS.inc("ops/ssd_scan")
    args = (x, dt_raw, A_log, B, C, D, dt_bias)
    if _use_kernel(x):
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return _call("ssd_scan", x, ssd_scan_trainable, *args)
        return _call("ssd_scan", x, ssd_scan, *args)
    return _call("ssd_scan", x, ssd_scan_ref, *args, chunk=chunk)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm over the last axis, float32 inside, output in x's dtype.
    On the card each row's output depends on that row alone (the kernel's
    fixed summation order); a strided x is made contiguous first."""
    if METRICS.enabled:
        METRICS.inc("ops/rms_norm")
    if _use_kernel(x):
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return _call("rms_norm", x, rms_norm_trainable, x, scale, eps)
        return _call("rms_norm", x, rms_norm_kernel, x, scale, eps)[0]
    return _call("rms_norm", x, rms_norm_ref, x, scale, eps)


@torch.no_grad()
def adam_update_leaf(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     master: torch.Tensor, param: torch.Tensor, *, lr: float,
                     beta1: float, beta2: float, eps: float, wd: float,
                     c1: float, c2: float) -> None:
    """One mixed-precision Adam step on one parameter leaf, in place: fp32
    m, v, master <- m', v', master' and param <- master' in param's dtype.
    (The JAX package's ``adam_update_leaf`` returns new arrays instead.)"""
    if METRICS.enabled:
        METRICS.inc("ops/adam_update")
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, wd=wd, c1=c1, c2=c2)
    if _use_kernel(g):
        _call("adam_update", g, adam_update, g, m, v, master, param, **kw)
        return
    _call("adam_update", g, _adam_plain, g, m, v, master, param, **kw)


def _adam_plain(g, m, v, master, param, **kw) -> None:
    m2, v2, master2, _ = adam_ref(g, m, v, master, **kw)
    m.copy_(m2)
    v.copy_(v2)
    master.copy_(master2)
    param.copy_(master2)
