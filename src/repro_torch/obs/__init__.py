"""Observability plane (opt-in, decision-free).

The port's copy of the JAX package's ``repro.obs``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

``obs.enable()`` turns on the structured event tracer (``obs.trace``) and
the metrics registry (``obs.metrics``); the lifecycle engine, cluster
pool, and kernel dispatch then feed them — spans, instants, counters,
downsampled time series — at bounded memory.  ``obs.export`` renders a
Chrome-trace JSON (Perfetto / ``chrome://tracing``) and a metrics dump;
``python -m repro_torch.obs.report`` summarizes the exported files.

Contract (ROADMAP "Observability plane"): telemetry is free — no decision
ever reads obs state, and every placement/timestamp is bit-identical with
obs on or off (golden-tested, including enable → run → disable round
trips).  When disabled, the entire plane costs one boolean check per
hook.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import TRACER


def enable(*, trace_capacity: Optional[int] = None,
           max_points: Optional[int] = None,
           sample_stride: Optional[int] = None,
           op_timing: bool = False) -> None:
    """Enable tracing + metrics (clears any previous run's data)."""
    TRACER.enable(capacity=trace_capacity)
    METRICS.enable(op_timing=op_timing, max_points=max_points,
                   sample_stride=sample_stride)


def disable() -> None:
    """Stop collecting; collected data survives for export until the
    next ``enable()`` or ``clear()``."""
    TRACER.disable()
    METRICS.disable()


def clear() -> None:
    TRACER.clear()
    METRICS.clear()


def is_enabled() -> bool:
    return TRACER.enabled or METRICS.enabled


@contextmanager
def observed(**kwargs):
    """``with obs.observed(): simulate(...)`` — enable for the block,
    disable after (data kept for export)."""
    enable(**kwargs)
    try:
        yield
    finally:
        disable()
