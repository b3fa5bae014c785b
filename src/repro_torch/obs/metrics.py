"""Metrics registry — counters, gauges, histograms, and fixed-budget
downsampled time series for the observability plane.

The port's copy of the JAX package's ``repro.obs.metrics``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

Fed (only when enabled) by

* ``ClusterPool`` state — cluster utilization % and idle-by-type, sampled
  at event boundaries (the pool only mutates inside events, so the event
  grid *is* the mutation grid) under a configurable event stride;
* the admission path — queue depth series, admission-latency histogram
  (first-start wait), admitted-job counter;
* the serve plane — rolling SLO attainment (good/total accounted seconds)
  and the live replica count;
* ``kernels.dispatch`` — per-op call counters and, opt-in
  (``op_timing=True``), eager per-op wall-time histograms.

Everything is pure accumulation (telemetry-is-free invariant): no decision
reads the registry, and memory is bounded — a ``TimeSeries`` holds at most
``2 * max_points`` aggregated buckets no matter how many samples flow in
(adjacent-pair merge halves resolution each time the budget fills), and
histograms are fixed power-of-two buckets.  That is what lets the streamed
1M-job cell run with metrics on without per-job retention.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

#: aggregated points a TimeSeries may hold before pair-merging (the series
#: never exceeds twice this many buckets)
DEFAULT_MAX_POINTS = 512

#: engine events between pool/queue samples (amortizes the sampling cost
#: to ~zero on the hot path; the series is downsampled anyway)
DEFAULT_SAMPLE_STRIDE = 128


class TimeSeries:
    """Fixed-budget downsampled series over (virtual) time.

    Samples append as raw single-sample buckets; when the bucket count
    reaches ``2 * max_points`` adjacent pairs merge (count/sum/min/max
    aggregate, ``last`` keeps the later value) — resolution halves, memory
    stays O(max_points) forever.  Buckets are ``[t_first, count, sum,
    min, max, last]``.
    """

    __slots__ = ("max_points", "points")

    def __init__(self, max_points: int = DEFAULT_MAX_POINTS):
        self.max_points = int(max_points)
        self.points: List[list] = []

    def add(self, t: float, v: float) -> None:
        pts = self.points
        pts.append([t, 1, v, v, v, v])
        if len(pts) >= 2 * self.max_points:
            self._compact()

    def _compact(self) -> None:
        pts = self.points
        merged = []
        for i in range(0, len(pts) - 1, 2):
            a, b = pts[i], pts[i + 1]
            merged.append([a[0], a[1] + b[1], a[2] + b[2],
                           a[3] if a[3] <= b[3] else b[3],
                           a[4] if a[4] >= b[4] else b[4], b[5]])
        if len(pts) % 2:
            merged.append(pts[-1])
        self.points = merged

    def __len__(self) -> int:
        return len(self.points)

    @property
    def n_samples(self) -> int:
        return sum(p[1] for p in self.points)

    def mean(self) -> float:
        n = self.n_samples
        if n == 0:
            return float("nan")
        return sum(p[2] for p in self.points) / n

    def percentile(self, q: float) -> float:
        """Approximate percentile over bucket means, weighted by bucket
        sample count (exact while buckets are raw samples)."""
        if not self.points:
            return float("nan")
        vals = sorted((p[2] / p[1], p[1]) for p in self.points)
        target = q * self.n_samples
        acc = 0
        for v, n in vals:
            acc += n
            if acc >= target:
                return v
        return vals[-1][0]

    def to_json(self) -> dict:
        return {"n_samples": self.n_samples,
                "points": [{"t": p[0], "count": p[1], "mean": p[2] / p[1],
                            "min": p[3], "max": p[4], "last": p[5]}
                           for p in self.points]}


class Histogram:
    """Fixed power-of-two-bucket histogram (seconds-scale by default:
    2^-20 s ≈ 1 µs up to 2^20 s; values outside clamp to the edge
    buckets).  O(1) memory, O(1) observe."""

    __slots__ = ("lo_exp", "hi_exp", "counts", "total", "sum")

    def __init__(self, lo_exp: int = -20, hi_exp: int = 20):
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.counts = [0] * (hi_exp - lo_exp + 2)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        if v <= 0.0:
            idx = 0
        else:
            e = int(math.ceil(math.log2(v)))
            idx = min(max(e - self.lo_exp + 1, 0), len(self.counts) - 1)
        self.counts[idx] += 1
        self.total += 1
        self.sum += v

    def observe_many(self, values) -> None:
        """Batch ingest — one Python frame for the whole batch (the engine
        buffers admission waits between samples and flushes them here)."""
        counts, lo, top = self.counts, self.lo_exp, len(self.counts) - 1
        log2, ceil = math.log2, math.ceil
        s = 0.0
        for v in values:
            if v <= 0.0:
                idx = 0
            else:
                idx = min(max(int(ceil(log2(v))) - lo + 1, 0), top)
            counts[idx] += 1
            s += v
        self.total += len(values)
        self.sum += s

    def _edge(self, idx: int) -> float:
        """Upper bound of bucket ``idx`` (0 == "<= 2^lo_exp")."""
        return 2.0 ** (self.lo_exp + idx)

    def percentile(self, q: float) -> float:
        """Upper bucket edge covering quantile ``q`` (conservative)."""
        if self.total == 0:
            return float("nan")
        target = q * self.total
        acc = 0
        for idx, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self._edge(idx)
        return self._edge(len(self.counts) - 1)

    def mean(self) -> float:
        return self.sum / self.total if self.total else float("nan")

    def to_json(self) -> dict:
        return {"total": self.total, "mean": self.mean(),
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99),
                "buckets": {f"le_2^{self.lo_exp + i}": c
                            for i, c in enumerate(self.counts) if c}}


class MetricsRegistry:
    """Process-wide registry (module singleton ``METRICS``).  Disabled by
    default; hot-path callers check ``METRICS.enabled`` before calling
    (one attribute read when off — the free-telemetry contract)."""

    def __init__(self):
        self.enabled = False
        self.version = 0                    # bumps per enable (token)
        self.op_timing = False              # opt-in eager op timing
        self.max_points = DEFAULT_MAX_POINTS
        self.sample_stride = DEFAULT_SAMPLE_STRIDE
        self.counters: Dict[str, float] = {}
        self.series: Dict[str, TimeSeries] = {}
        self.hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------ control
    def enable(self, *, op_timing: bool = False,
               max_points: Optional[int] = None,
               sample_stride: Optional[int] = None) -> None:
        """Start collecting (clears any previous run's data)."""
        if max_points is not None:
            self.max_points = int(max_points)
        if sample_stride is not None:
            self.sample_stride = max(int(sample_stride), 1)
        self.op_timing = bool(op_timing)
        self.counters = {}
        self.series = {}
        self.hists = {}
        self.enabled = True
        self.version += 1

    def disable(self) -> None:
        """Stop collecting; data is kept for export until ``clear()`` or
        the next ``enable()``."""
        self.enabled = False
        self.op_timing = False

    def clear(self) -> None:
        self.counters = {}
        self.series = {}
        self.hists = {}

    def cache_token(self) -> tuple:
        return ("on", self.version) if self.enabled else ("off",)

    # ----------------------------------------------------------- emitters
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + v

    def sample(self, name: str, t: float, v: float) -> None:
        ts = self.series.get(name)
        if ts is None:
            ts = self.series[name] = TimeSeries(self.max_points)
        ts.add(t, v)

    def observe(self, name: str, v: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(v)

    def observe_many(self, name: str, values) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe_many(values)

    # ------------------------------------------------------------ queries
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def snapshot(self) -> dict:
        """JSON-able dump of everything collected (the metrics export)."""
        return {
            "version": self.version,
            "counters": dict(self.counters),
            "series": {k: v.to_json() for k, v in self.series.items()},
            "histograms": {k: v.to_json() for k, v in self.hists.items()},
        }


#: the process-wide registry (import-site singleton)
METRICS = MetricsRegistry()
