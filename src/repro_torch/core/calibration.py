"""Per-(device_type, model-family) MFU calibration feeding MARP.

The JAX package's ``repro.core.calibration``, over the port's catalog
(``repro_torch.core.devices``, with the H100-80G entry); the active
parameter count it prices with is ``memory_model.active_param_count``
(the reference's ``marp._active_analytic``).

The paper ranks plans by training efficiency ("plans at the forefront
indicate higher training efficiency", §IV-A); the seed hardcoded a 45%
MFU guess into ``plan_throughput_score``.  This module closes the loop:

* **measured** — a timed train step (the JAX package's
  ``benchmarks/train_step.py``; the port's ``chip_smoke.py``) converts with
  ``measured_mfu``;
* **roofline** — when the hardware is absent, ``roofline_mfu`` derives an
  analytic attainable-MFU per ``DeviceType`` from the family's arithmetic
  intensity (model FLOPs vs. HBM traffic of one optimizer-inclusive step);
* the resulting table is installed with ``enable`` / ``calibrated`` and
  consumed by ``marp.plan_throughput_score`` instead of the constant.

Calibration state is part of MARP's memoization key via ``cache_token()``:
the token is ``("off",)`` whenever calibration is disabled — so the
calibration-off ranking is bit-identical to the seed, including after an
enable/disable round trip — and ``("on", version)`` when enabled, where
``version`` bumps on every ``enable`` so stale cached rankings are never
served.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.devices import DEVICE_TYPES, DeviceType

#: The seed's hardcoded guess — what every lookup returns when calibration
#: is off, and the fallback for uncalibrated (device, family) pairs.
DEFAULT_MFU = 0.45

#: Fraction of peak dense FLOPs a well-tuned kernel stack attains when
#: fully compute-bound (roofline ceiling; real kernels never hit 1.0).
ROOFLINE_ATTAINABLE = 0.60

MIN_MFU, MAX_MFU = 0.02, 0.95

#: (device_type, family) -> MFU in (0, 1).  Family "*" is a per-device
#: wildcard consulted when the exact family is missing.
MFUTable = Dict[Tuple[str, str], float]

#: Fraction of peak HBM bandwidth a decode step attains when the decode
#: table has no better number (streaming weights + ring-cache reads never
#: reach the STREAM peak; ~70% is typical of tuned decode loops).
DECODE_ATTAINABLE = 0.70

_enabled: bool = False
_table: MFUTable = {}
_default: float = DEFAULT_MFU
_version: int = 0

# decode-bandwidth table — (device_type, family) -> fraction of peak HBM
# bandwidth the single-token decode loop attains (the serving analog of the
# MFU table; consumed by marp's serve rate model and the SLO autoscaler)
_decode_enabled: bool = False
_decode_table: MFUTable = {}
_decode_default: float = DECODE_ATTAINABLE


def cache_token() -> Tuple:
    """Hashable component of MARP's memoization key (its invariants).
    Covers both the MFU table and the decode-bandwidth table: ``("off",)``
    whenever neither is enabled — the fully-off ranking (train *and* serve
    sweeps) is bit-identical to the seed — and ``("on", version)``
    otherwise, the shared ``version`` bumping on every enable."""
    return ("on", _version) if (_enabled or _decode_enabled) else ("off",)


def is_enabled() -> bool:
    return _enabled


def mfu_for(family: str, device_type: str) -> float:
    """MFU for ranking a (family, device) pair; DEFAULT_MFU when off."""
    if not _enabled:
        return DEFAULT_MFU
    for key in ((device_type, family), (device_type, "*")):
        if key in _table:
            return _table[key]
    return _default


def enable(table: Mapping[Tuple[str, str], float], *,
           default: float = DEFAULT_MFU) -> None:
    global _enabled, _table, _default, _version
    _table = {tuple(k): float(v) for k, v in table.items()}
    _default = float(default)
    _enabled = True
    _version += 1


def disable() -> None:
    global _enabled, _version
    _enabled = False
    # the decode table may still be on: bump the shared version so plans
    # memoized while the MFU table was enabled are never served stale
    _version += 1


@contextmanager
def calibrated(table: Mapping[Tuple[str, str], float], *,
               default: float = DEFAULT_MFU):
    """Scoped ``enable``; restores the previous state on exit."""
    prev = (_enabled, _table, _default)
    enable(table, default=default)
    try:
        yield
    finally:
        if prev[0]:
            enable(prev[1], default=prev[2])
        else:
            disable()


def decode_bw_for(family: str, device_type: str) -> float:
    """Effective decode HBM bandwidth (bytes/s) for one device of
    ``device_type`` serving ``family`` models — peak bandwidth scaled by
    the calibrated decode efficiency.  With the decode table off this is
    the raw ``DeviceType.hbm_bw`` (the seed's serve-plan rate model,
    bit-identical)."""
    bw = DEVICE_TYPES[device_type].hbm_bw
    if not _decode_enabled:
        return bw
    for key in ((device_type, family), (device_type, "*")):
        if key in _decode_table:
            return bw * _decode_table[key]
    return bw * _decode_default


def is_decode_enabled() -> bool:
    return _decode_enabled


def enable_decode(table: Mapping[Tuple[str, str], float], *,
                  default: float = DECODE_ATTAINABLE) -> None:
    """Install a measured decode-bandwidth-efficiency table (fractions of
    peak HBM bandwidth per (device_type, family); ``launch/serve`` measures
    them with ``measured_decode_eff``)."""
    global _decode_enabled, _decode_table, _decode_default, _version
    _decode_table = {tuple(k): float(v) for k, v in table.items()}
    _decode_default = float(default)
    _decode_enabled = True
    _version += 1


def disable_decode() -> None:
    global _decode_enabled, _version
    _decode_enabled = False
    # the MFU table may still be on: bump the shared version so plans
    # memoized while the decode table was enabled are never served stale
    _version += 1


def measured_decode_eff(tok_per_s: float, cfg: ModelConfig, batch: int,
                        cache_len: int, d: int, t: int,
                        dev: DeviceType) -> float:
    """Achieved fraction of peak HBM bandwidth from a measured decode
    throughput: each step streams the weight slice plus the cache slice
    once per device to emit ``batch`` tokens."""
    wbytes, cache, _ = mm.serve_bytes_split(cfg, batch, cache_len, d, t)
    achieved_bw = tok_per_s * (wbytes + cache) / max(batch, 1)
    return min(max(achieved_bw / dev.hbm_bw, 0.01), 1.0)


def measured_prefill_eff(tok_per_s: float, cfg: ModelConfig,
                         n_devices: int, dev: DeviceType) -> float:
    """Achieved fraction of peak FLOPs from a measured prefill throughput
    — the compute-bound MFU the prefill-pool rate model assumes
    (the JAX package's ``marp._prefill_rate``: 2 flops per active param
    per prompt token).
    Clamped like ``measured_mfu`` so one noisy run cannot poison a
    calibration table."""
    achieved = tok_per_s * 2.0 * mm.active_param_count(cfg)
    return _clamp(achieved / (n_devices * dev.flops))


def _clamp(x: float) -> float:
    return min(max(x, MIN_MFU), MAX_MFU)


# ------------------------------------------------------------- measured ---

def measured_mfu(step_time_s: float, cfg: ModelConfig, global_batch: int,
                 seq: int, n_devices: int, dev: DeviceType) -> float:
    """Achieved fraction of peak: 6·N_active·tokens / (wall · Σ peak)."""
    flops = 6.0 * mm.active_param_count(cfg) * global_batch * seq
    achieved = flops / max(step_time_s, 1e-12)
    return _clamp(achieved / (n_devices * dev.flops))


def table_from_measurements(
        rows: Iterable[Mapping[str, object]]) -> MFUTable:
    """Average measured rows (dicts with device_type / family / mfu keys)
    into an MFU table — repeated measurements of a pair are averaged."""
    acc: Dict[Tuple[str, str], Tuple[float, int]] = {}
    for r in rows:
        key = (str(r["device_type"]), str(r["family"]))
        s, n = acc.get(key, (0.0, 0))
        acc[key] = (s + float(r["mfu"]), n + 1)
    return {k: _clamp(s / n) for k, (s, n) in acc.items()}


# ------------------------------------------------------------- roofline ---

def roofline_mfu(cfg: ModelConfig, dev: DeviceType, *, seq: int = 2048,
                 microbatch: int = 1) -> float:
    """Analytic fallback when the device is not physically present.

    One optimizer-inclusive train step moves ~36 bytes/param of HBM
    traffic (bf16 weights fwd+bwd reads 4, fp32 grad write/read 8,
    m/v/master read+write 24) plus roughly twice the peak activation
    footprint; the attainable MFU is the compute fraction of the
    roofline-dominant term, capped at ROOFLINE_ATTAINABLE.
    """
    tokens = microbatch * seq
    flops = 6.0 * mm.active_param_count(cfg) * tokens
    w = mm.analytic_param_count(cfg)
    traffic = 36.0 * w + 2.0 * mm.activation_bytes(cfg, seq, microbatch, 1,
                                                   remat="block")
    t_compute = flops / dev.flops
    t_memory = traffic / dev.hbm_bw
    return _clamp(ROOFLINE_ATTAINABLE * t_compute / max(t_compute, t_memory))


def family_representatives() -> Dict[str, ModelConfig]:
    """Smallest registry arch per family — the representative both the
    roofline fallback and the measured path (benchmarks/train_step.py)
    use, so a measured entry overwrites a roofline entry for the *same*
    model."""
    from repro_torch.configs.registry import ARCHS
    reps: Dict[str, ModelConfig] = {}
    for cfg in ARCHS.values():
        cur = reps.get(cfg.family)
        if cur is None or (mm.analytic_param_count(cfg)
                           < mm.analytic_param_count(cur)):
            reps[cfg.family] = cfg
    return reps


def roofline_table(device_types: Optional[Sequence[str]] = None,
                   families: Optional[Sequence[str]] = None, *,
                   seq: int = 2048) -> MFUTable:
    """Roofline MFU for every (device_type, family) pair — the
    hardware-absent calibration source."""
    reps = family_representatives()
    if families is not None:
        reps = {f: reps[f] for f in families}
    dts = list(device_types) if device_types else list(DEVICE_TYPES)
    return {(dt, fam): roofline_mfu(cfg, DEVICE_TYPES[dt], seq=seq)
            for dt in dts for fam, cfg in reps.items()}


# ----------------------------------------------------------- round trip ---

def save(path: str, table: MFUTable) -> None:
    with open(path, "w") as f:
        json.dump({f"{dt}|{fam}": v for (dt, fam), v in sorted(table.items())},
                  f, indent=1, sort_keys=True)


def load(path: str) -> MFUTable:
    with open(path) as f:
        raw = json.load(f)
    out: MFUTable = {}
    for key, v in raw.items():
        dt, fam = key.split("|", 1)
        out[(dt, fam)] = float(v)
    return out
