"""Memory feedback plane — online peak-memory telemetry feeding MARP.

The JAX package's ``repro.core.memtrace``, with the port's device catalog
(``repro_torch.core.devices``, which has the H100-80G entry) and registry.
``device_type_for`` takes a torch device name
(``torch.cuda.get_device_name()``) as well as a JAX ``device_kind``.
Samples on the card come from ``torch.cuda.max_memory_allocated()`` over
a training step (``launch/train``, ``chip_smoke.py``), source ``"cuda"``.

The paper's headline mechanism is memory-aware scheduling ("memory usage
prediction accuracy exceeds 92%", §V-B), yet a prediction is still a
prediction: the seed control plane trusted ``exact_peak_bytes`` through a
hardcoded ``MEM_SAFETY = 0.92`` margin and had no path from *observed*
peaks back into planning.  The calibration plane closed this loop for
throughput (measured MFU -> calibration table -> ranking); this module
closes it for memory, the paper's core quantity:

* **telemetry** — ``record`` ingests observed peak-memory samples per
  ``(model family, zero, device_type, shape-bucket)`` class from three
  sources: XLA ``compiled.memory_analysis()`` at live compile time
  (``launch/train``, ``launch/dryrun``), offline ``launch/memcheck`` runs
  (the committed ``experiments/memcheck/*.json`` seed the store at import
  so CPU-only CI exercises the measured path), and OOM post-mortems from
  the lifecycle engine (``core/lifecycle``).
* **residual corrector** — per class we keep the worst observed
  observed/predicted ratio and the largest observed peak;
  ``corrected_bytes`` returns ``max(pred * max_ratio, max_observed)``, so
  after ingesting an observation the corrected prediction for that class
  can never fall below it again (the **no-repeat-OOM invariant**, property
  tested in ``tests/test_memtrace.py``).
* **adaptive safety margin** — ``margin_for`` replaces the global
  ``MEM_SAFETY`` constant per class: tight residuals relax the margin
  toward ``MARGIN_MAX`` (more of the device is plannable), noisy residuals
  tighten it toward ``MARGIN_MIN``.  With no data (or below
  ``MARGIN_MIN_SAMPLES`` observations) it returns ``BASE_MARGIN`` — the
  seed's 0.92.

Feedback state is part of MARP's memoization key via ``cache_token()``,
exactly like ``core.calibration``: the token is ``("off",)`` whenever the
plane is disabled — so the feedback-off ranking is bit-identical to the
seed, including after enable/disable round trips — and ``("on", version)``
when enabled, where ``version`` bumps on every ``enable``/``record`` so a
freshly ingested OOM immediately invalidates cached rankings.
"""
from __future__ import annotations

import glob
import json
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.devices import DEVICE_TYPES

#: The seed's global headroom constant (allocator fragmentation): what
#: ``margin_for`` returns whenever the feedback plane is off or a class has
#: too few observations to say anything better.
BASE_MARGIN = 0.92

#: Adaptive-margin bounds: even perfectly consistent residuals keep 3% of
#: the device for fragmentation; wildly noisy ones never eat more than 15%.
MARGIN_MIN, MARGIN_MAX = 0.85, 0.97

#: Observations of a (family, zero, device_type) before the margin adapts.
MARGIN_MIN_SAMPLES = 3

#: Fragmentation slack folded into the adaptive margin (the irreducible
#: part of the seed's 8% headroom).
MARGIN_SLACK = 0.03

#: Floor for the multiplicative corrector — a class whose observations all
#: say "the model over-predicts 3x" still only shrinks predictions 2x
#: (``max_observed`` keeps the invariant regardless of the floor).
CORRECTION_FLOOR = 0.5

#: Retained raw samples (stats are cumulative and unaffected by eviction).
MAX_SAMPLES = 4096

#: Device-type wildcard: samples measured off-catalog (e.g. XLA host
#: devices as the Megatron-measurement stand-in) land here, and lookups
#: fall back to it when the exact device class has no data.
ANY_DEVICE = "*"


@dataclass(frozen=True)
class MemSample:
    """One observed-vs-predicted peak-memory measurement."""
    family: str
    zero: int
    device_type: str
    pred_bytes: float
    observed_bytes: float
    source: str                   # "xla" | "memcheck" | "sim" | "oom"

    @property
    def ratio(self) -> float:
        return self.observed_bytes / self.pred_bytes


class _Stats:
    """Streaming residual statistics for one class (Welford for the std)."""
    __slots__ = ("count", "max_ratio", "max_observed", "mean", "_m2")

    def __init__(self):
        self.count = 0
        self.max_ratio = 0.0
        self.max_observed = 0.0
        self.mean = 0.0
        self._m2 = 0.0

    def add(self, ratio: float, observed: float) -> None:
        self.count += 1
        self.max_ratio = max(self.max_ratio, ratio)
        self.max_observed = max(self.max_observed, observed)
        delta = ratio - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (ratio - self.mean)

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.count - 1))


ClassKey = Tuple[str, int, str, int]          # (family, zero, device, bucket)
MarginKey = Tuple[str, int, str]              # (family, zero, device)

_enabled: bool = False
_version: int = 0
_samples: List[MemSample] = []
_stats: Dict[ClassKey, _Stats] = {}
_margin_stats: Dict[MarginKey, _Stats] = {}
_seeded: bool = False
_seeded_paths: set = set()                    # files already ingested


def shape_bucket(pred_bytes: float) -> int:
    """Power-of-two shape bucket: predictions within 2x of each other share
    residual statistics (trace workloads draw from a handful of model/batch
    combinations, so buckets are dense where it matters)."""
    return int(max(pred_bytes, 1.0)).bit_length()


# ----------------------------------------------------------------- state ---

def cache_token() -> Tuple:
    """Hashable component of MARP's memoization key (the calibration
    plane's contract): constant while disabled; a fresh value after every ``enable`` *and*
    every ``record`` — any behaviour-affecting feedback state must reach
    the token."""
    return ("on", _version) if _enabled else ("off",)


def is_enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the feedback plane on: MARP's sweeps start consulting the
    corrector and the adaptive margins."""
    global _enabled, _version
    _enabled = True
    _version += 1


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def feedback():
    """Scoped ``enable``; restores the previous on/off state on exit."""
    global _enabled
    prev = _enabled
    enable()
    try:
        yield
    finally:
        _enabled = prev


def reset() -> None:
    """Drop every sample and disable — test isolation.  Call
    ``seed_from_experiments`` afterwards to restore the committed corpus."""
    global _enabled, _version, _seeded
    _samples.clear()
    _stats.clear()
    _margin_stats.clear()
    _enabled = False
    _seeded = False
    _seeded_paths.clear()
    _version += 1


# ------------------------------------------------------------- telemetry ---

def record(family: str, zero: int, device_type: str, pred_bytes: float,
           observed_bytes: float, source: str = "live") -> Optional[MemSample]:
    """Ingest one observed peak.  Safe to call with the plane disabled —
    samples accumulate as telemetry and only influence decisions once
    ``enable`` is called (the token hides the version until then)."""
    global _version
    if not (pred_bytes > 0.0 and observed_bytes > 0.0):
        return None
    sample = MemSample(family=family, zero=int(zero),
                       device_type=device_type or ANY_DEVICE,
                       pred_bytes=float(pred_bytes),
                       observed_bytes=float(observed_bytes), source=source)
    _samples.append(sample)
    if len(_samples) > MAX_SAMPLES:
        del _samples[:len(_samples) - MAX_SAMPLES]
    bucket = shape_bucket(sample.pred_bytes)
    keys = {(sample.family, sample.zero, sample.device_type, bucket),
            (sample.family, sample.zero, ANY_DEVICE, bucket)}
    for key in keys:
        _stats.setdefault(key, _Stats()).add(sample.ratio,
                                             sample.observed_bytes)
    for mkey in {(sample.family, sample.zero, sample.device_type),
                 (sample.family, sample.zero, ANY_DEVICE)}:
        _margin_stats.setdefault(mkey, _Stats()).add(sample.ratio,
                                                     sample.observed_bytes)
    _version += 1
    return sample


def samples() -> Tuple[MemSample, ...]:
    return tuple(_samples)


# ------------------------------------------------------------- corrector ---

def _class_stats(family: str, zero: int, device_type: str,
                 bucket: int) -> Optional[_Stats]:
    s = _stats.get((family, int(zero), device_type, bucket))
    if s is None and device_type != ANY_DEVICE:
        s = _stats.get((family, int(zero), ANY_DEVICE, bucket))
    return s


def correction_for(family: str, zero: int, device_type: str,
                   pred_bytes: float) -> float:
    """Multiplicative residual corrector for a class; 1.0 with no data or
    the plane off."""
    if not _enabled:
        return 1.0
    s = _class_stats(family, zero, device_type, shape_bucket(pred_bytes))
    if s is None or s.count == 0:
        return 1.0
    return max(s.max_ratio, CORRECTION_FLOOR)


def corrected_bytes(family: str, zero: int, device_type: str,
                    pred_bytes: float) -> float:
    """Feedback-corrected peak prediction.

    ``max(pred * worst-ratio, largest observed peak)`` over the class —
    the no-repeat-OOM invariant: once a peak has been observed for a
    class, the corrected prediction can never again fall below it, so the
    exact placement that OOMed is never again deemed feasible.  Identity
    when disabled (bit-identical seed behaviour).
    """
    if not _enabled:
        return pred_bytes
    s = _class_stats(family, zero, device_type, shape_bucket(pred_bytes))
    if s is None or s.count == 0:
        return pred_bytes
    return max(pred_bytes * max(s.max_ratio, CORRECTION_FLOOR),
               s.max_observed)


def margin_for(family: str, zero: int, device_type: str) -> float:
    """Adaptive safety margin replacing the global ``MEM_SAFETY``.

    ``1 - (2*std(ratio) + MARGIN_SLACK)`` clamped to
    ``[MARGIN_MIN, MARGIN_MAX]``: consistent residuals let plans use up to
    97% of the device, noisy ones keep up to 15% headroom.  Returns
    ``BASE_MARGIN`` (the seed's 0.92, bit-identical) when the plane is off
    or the class has fewer than ``MARGIN_MIN_SAMPLES`` observations.
    """
    if not _enabled:
        return BASE_MARGIN
    s = _margin_stats.get((family, int(zero), device_type))
    if (s is None or s.count < MARGIN_MIN_SAMPLES) \
            and device_type != ANY_DEVICE:
        s = _margin_stats.get((family, int(zero), ANY_DEVICE))
    if s is None or s.count < MARGIN_MIN_SAMPLES:
        return BASE_MARGIN
    return min(max(1.0 - (2.0 * s.std + MARGIN_SLACK), MARGIN_MIN),
               MARGIN_MAX)


# ------------------------------------------------------------ inspection ---

def stats_summary() -> Dict[str, object]:
    """Small diagnostic snapshot (benchmarks / README examples)."""
    by_source: Dict[str, int] = {}
    for s in _samples:
        by_source[s.source] = by_source.get(s.source, 0) + 1
    return {"enabled": _enabled, "version": _version,
            "samples": len(_samples), "classes": len(_stats),
            "by_source": by_source}


def device_type_for(device_kind: str) -> str:
    """Map a device name (``torch.cuda.get_device_name()``, or a JAX
    ``device_kind``) onto the planning catalog, or the wildcard when the
    local accelerator is off-catalog (CPU CI).

    Real kinds decorate the model name — e.g. ``"NVIDIA A100-SXM4-40GB"``,
    ``"TPU v5 lite"`` — so both sides are normalised to alphanumerics and
    every dash-separated token of a catalog name must appear (``"40g"``
    matches inside ``"40gb"``); the most specific full match wins, keeping
    A100-40G and A100-80G samples in their own classes.  ``"NVIDIA H100
    80GB HBM3"`` is ``"H100-80G"`` here (the JAX catalog has no H100)."""
    kind = "".join(c for c in (device_kind or "").lower() if c.isalnum())
    if "v5lite" in kind and "v5e" in DEVICE_TYPES:
        return "v5e"
    best = ANY_DEVICE
    for name in DEVICE_TYPES:
        tokens = ["".join(c for c in part if c.isalnum())
                  for part in name.lower().split("-")]
        if all(tok and tok in kind for tok in tokens):
            if best == ANY_DEVICE or len(name) > len(best):
                best = name
    return best


# ------------------------------------------------------------ round trip ---

def save(path: str) -> None:
    with open(path, "w") as f:
        json.dump([s.__dict__ for s in _samples], f, indent=1, sort_keys=True)


def load(path: str, *, source: Optional[str] = None) -> int:
    """Replay a saved sample file into the store; returns rows ingested."""
    with open(path) as f:
        raw = json.load(f)
    n = 0
    for r in raw:
        if record(str(r["family"]), int(r["zero"]),
                  str(r.get("device_type", ANY_DEVICE)),
                  float(r["pred_bytes"]), float(r["observed_bytes"]),
                  source or str(r.get("source", "load"))) is not None:
            n += 1
    return n


# --------------------------------------------------------------- seeding ---

_EXPERIMENTS_DIR = os.path.join(os.path.dirname(__file__),
                                "../../../experiments/memcheck")


def seed_from_experiments(out_dir: Optional[str] = None) -> int:
    """Ingest the committed ``launch/memcheck`` ground-truth JSONs
    (mirrors calibration's roofline fallback: CPU-only CI exercises the
    measured path without hardware).  Leaves the enabled flag untouched —
    seeding is telemetry, not a behaviour change.  Returns rows ingested.

    Idempotent at file granularity: every ingested file is remembered (by
    absolute path, until ``reset``), so repeated calls — module re-import,
    an explicit call after the import-time seeding, or overlapping
    ``out_dir`` arguments — never double-ingest a corpus and double-count
    its residuals.  A missing or empty experiments directory (fresh
    clones, sdist installs without the committed JSONs) is a clean no-op,
    not an error."""
    global _seeded
    if _seeded and out_dir is None:
        return 0
    base = out_dir or _EXPERIMENTS_DIR
    if not os.path.isdir(base):
        if out_dir is None:
            _seeded = True                  # nothing to (re)scan later
        return 0
    from repro_torch.configs.registry import get_arch
    n = 0
    for path in sorted(glob.glob(os.path.join(base,
                                              "memcheck_zero*.json"))):
        key = os.path.abspath(path)
        if key in _seeded_paths:
            continue
        try:
            with open(path) as f:
                rows = json.load(f)
        except (OSError, ValueError):
            continue
        _seeded_paths.add(key)
        if not isinstance(rows, list):
            continue
        for r in rows:
            try:
                fam = get_arch(str(r["arch"])).family
                if record(fam, int(r.get("zero", 0)), ANY_DEVICE,
                          float(r["pred_exact"]), float(r["actual_bytes"]),
                          source="memcheck") is not None:
                    n += 1
            except (KeyError, ValueError, TypeError):
                continue
    if out_dir is None:
        _seeded = True
    return n


seed_from_experiments()
