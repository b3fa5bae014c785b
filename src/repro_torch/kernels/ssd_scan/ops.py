"""The SSD scan as a differentiable op on the card: a
``torch.autograd.Function`` whose forward launches the scan kernel and
whose backward launches the gradient kernel.

The JAX package differentiates its chunked scan by autodiff; this computes
the same gradient with a kernel, so that the training path on a CUDA tensor
never falls to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt_raw, A_log, B, C, D, dt_bias):
        ctx.set_materialize_grads(False)
        y, state = ssd_scan(x, dt_raw, A_log, B, C, D, dt_bias)
        ctx.save_for_backward(x, dt_raw, A_log, B, C, D, dt_bias)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        saved = ctx.saved_tensors        # once: checkpoint unpacks only once
        x = saved[0]
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if d_state is not None:
            d_state = d_state.float().contiguous()
        return ssd_scan_bwd(*saved, dy, d_state)


def ssd_scan_trainable(x: torch.Tensor, dt_raw: torch.Tensor,
                       A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor, dt_bias: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan`` with a gradient: CUDA tensors only."""
    return _SsdScan.apply(x, dt_raw, A_log, B, C, D, dt_bias)
