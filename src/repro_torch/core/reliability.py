"""Reliability-aware planning — the opt-in failure-cost model MARP consults.

The port's copy of the JAX package's ``repro.core.reliability``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).

The failure plane makes crashes real: a ``node_fail`` rolls every
victim back to its last durable checkpoint.  Under periodic checkpointing
at the Young–Daly interval ``tau = sqrt(2*C*M)`` (C = one save,
M = aggregate MTBF of the placement), the expected fraction of wall-clock
a job spends making *durable* progress is approximately

    goodput(n) ~= 1 - sqrt(2*C/M) - C/M,    M = mtbf_s / n

so doubling the device count halves M and grows the waste term by
``sqrt(2)`` — which is exactly why a 64-device spot plan can lose to a
32-device on-demand plan once reliability is priced.  ``expected_goodput``
computes that fraction from the per-``DeviceType`` MTBF catalog, and MARP
multiplies each candidate plan's throughput score by it when the plane is
enabled.

Cache-token contract (the memoization discipline): this module is OFF by
default and ``cache_token()`` returns the constant ``("off",)`` so every
memoized MARP sweep stays bit-identical to the seed.  ``enable()`` bumps a
version that joins MARP's lru key, so flipping the plane (or rescaling the
assumed MTBF) can never serve a stale cached sweep.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

from repro_torch.ckpt.checkpoint import checkpoint_seconds
from repro_torch.core.devices import DEVICE_TYPES

#: floor on the goodput fraction — a plan on absurdly flaky hardware is
#: heavily discounted, never zeroed (score ordering must stay total).
MIN_GOODPUT = 0.05

_enabled: bool = False
_version: int = 0
_mtbf_scale: float = 1.0


# ----------------------------------------------------------------- state ---

def cache_token() -> Tuple:
    """Hashable component of MARP's memoization key: constant while
    disabled; a fresh value after every ``enable`` (which is also where
    the MTBF rescale lands) — any behaviour-affecting reliability state
    must reach the token."""
    return ("on", _version) if _enabled else ("off",)


def is_enabled() -> bool:
    return _enabled


def mtbf_scale() -> float:
    return _mtbf_scale


def enable(mtbf_scale: float = 1.0) -> None:
    """Turn reliability-aware planning on: MARP discounts every candidate
    plan's score by its expected goodput fraction.  ``mtbf_scale`` rescales
    the device catalog's MTBF (``< 1`` models a flakier fleet, e.g. spot)."""
    global _enabled, _version, _mtbf_scale
    _enabled = True
    _mtbf_scale = float(mtbf_scale)
    _version += 1


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def reliability_aware(mtbf_scale: float = 1.0):
    """Scoped ``enable``; restores the previous state on exit."""
    global _enabled, _mtbf_scale
    prev_enabled, prev_scale = _enabled, _mtbf_scale
    enable(mtbf_scale)
    try:
        yield
    finally:
        _enabled, _mtbf_scale = prev_enabled, prev_scale


def reset() -> None:
    """Back to the seed-identical default — test isolation."""
    global _enabled, _version, _mtbf_scale
    _enabled = False
    _mtbf_scale = 1.0
    _version += 1


# ------------------------------------------------------------------ model ---

def aggregate_mtbf_s(device_type: str, n_devices: int,
                     scale: float = None) -> float:
    """MTBF of an n-device placement under independent exponential faults:
    the per-device catalog MTBF divided by the device count."""
    dev = DEVICE_TYPES[device_type]
    s = _mtbf_scale if scale is None else scale
    return dev.mtbf_s * s / max(int(n_devices), 1)


def expected_goodput(cfg, device_type: str, n_devices: int, *,
                     lora_rank: int = 0,
                     bandwidth: float = 16 * 2 ** 30) -> float:
    """Expected durable-progress fraction of an n-device plan under
    Young–Daly checkpointing: ``1 - sqrt(2C/M) - C/M`` clamped to
    ``[MIN_GOODPUT, 1]``.  The ``sqrt`` term is the first-order
    checkpoint+rework waste of the optimal interval; ``C/M`` charges the
    save that is in flight when the fault lands."""
    M = aggregate_mtbf_s(device_type, n_devices)
    if M <= 0.0:
        return MIN_GOODPUT
    C = checkpoint_seconds(cfg, bandwidth=bandwidth, lora_rank=lora_rank)
    if C <= 0.0:
        return 1.0
    waste = math.sqrt(2.0 * C / M) + C / M
    return min(1.0, max(1.0 - waste, MIN_GOODPUT))
