"""CLI run summary over the observability plane's exports.

    PYTHONPATH=src python -m repro_torch.obs.report --trace trace.json \
        --metrics metrics.json [--top 10]

reads a Chrome-trace export (``obs.export.export_chrome_trace``) plus a
metrics dump (``export_metrics``) and prints

* the cluster-utilization timeline (coarse text sparkline over the
  downsampled counter track),
* queue-depth percentiles,
* scheduler wall time split by triggering event kind,
* the top-k longest-queued jobs.

``--demo`` runs the whole round trip in-process: a small churn + OOM sim
with obs enabled (``obs.churn``), export to a temp dir, re-read, report,
failing loudly if the trace does not parse or any section comes back
empty.

The port's copy of the JAX package's ``repro.obs.report``: the same
exports give the same text (``tests/test_torch_obs_report.py``).  With
``op_timing`` on, the histograms include the kernel ops' host times
(``ops_s/<op>``, see ``kernels.dispatch``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[float], width: int = 60) -> str:
    if not values:
        return "(no samples)"
    if len(values) > width:                 # coarsen to the display width
        step = len(values) / width
        values = [values[int(i * step)] for i in range(width)]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)),
                              len(_SPARK) - 1)] for v in values)


def _percentile(sorted_pairs: List[Tuple[float, int]], q: float) -> float:
    """Weighted percentile over (value, weight) pairs sorted by value."""
    total = sum(w for _, w in sorted_pairs)
    if total == 0:
        return float("nan")
    target = q * total
    acc = 0
    for v, w in sorted_pairs:
        acc += w
        if acc >= target:
            return v
    return sorted_pairs[-1][0]


def report(trace: dict, metrics: dict, top: int = 10,
           out=sys.stdout) -> None:
    events = trace.get("traceEvents", [])
    print("== observability report ==", file=out)
    dropped = trace.get("otherData", {}).get("dropped_events", 0)
    print(f"trace events: {len(events)} (ring dropped {dropped})",
          file=out)

    # --- utilization timeline (metrics series preferred, counter track
    # fallback so a trace-only invocation still renders it)
    util = metrics.get("series", {}).get("cluster/util_pct")
    if util and util.get("points"):
        pts = util["points"]
        vals = [p["mean"] for p in pts]
        print(f"utilization % over [{pts[0]['t']:.1f}s,"
              f" {pts[-1]['t']:.1f}s] (mean {sum(vals)/len(vals):.1f},"
              f" max {max(p['max'] for p in pts):.1f}):", file=out)
        print(f"  {_sparkline(vals)}", file=out)
    else:
        cvals = [ev["args"]["cluster.util_pct"] for ev in events
                 if ev.get("ph") == "C"
                 and ev.get("name") == "cluster.util_pct"]
        print(f"utilization: {_sparkline(cvals)}" if cvals
              else "utilization: (no samples)", file=out)

    # --- queue-depth percentiles
    depth = metrics.get("series", {}).get("queue/depth")
    if depth and depth.get("points"):
        pairs = sorted((p["mean"], p["count"]) for p in depth["points"])
        qs = {q: _percentile(pairs, q) for q in (0.50, 0.90, 0.99)}
        peak = max(p["max"] for p in depth["points"])
        print(f"queue depth: p50 {qs[0.50]:.0f}  p90 {qs[0.90]:.0f}"
              f"  p99 {qs[0.99]:.0f}  peak {peak:.0f}", file=out)
    else:
        print("queue depth: (no samples)", file=out)

    # --- scheduler wall time by triggering event kind
    by_kind: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("cat") == "sched" and ev.get("ph") == "X":
            kind = ev["name"].split(":", 1)[-1]
            by_kind[kind] += ev.get("dur", 0.0) / 1e6
            calls[kind] += 1
    if by_kind:
        print("scheduler wall time by kind:", file=out)
        for kind, s in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {kind:<12} {s * 1e3:9.3f} ms  ({calls[kind]} passes)",
                  file=out)
    else:
        print("scheduler passes: (none traced)", file=out)

    # --- top-k longest-queued jobs
    waits = [(ev.get("dur", 0.0) / 1e6, ev.get("tid"), ev.get("ts", 0.0))
             for ev in events
             if ev.get("ph") == "X" and ev.get("cat") == "job"
             and ev.get("name") == "queued"]
    waits.sort(reverse=True)
    if waits:
        print(f"top {min(top, len(waits))} longest-queued jobs:", file=out)
        for dur, jid, ts in waits[:top]:
            print(f"  job {jid:<8} waited {dur:10.2f}s"
                  f" (queued at t={ts / 1e6:.1f}s)", file=out)
    else:
        print("queued spans: (none traced)", file=out)

    # --- histogram summaries (admission latency etc.)
    for name, h in sorted(metrics.get("histograms", {}).items()):
        if not h.get("total"):
            continue
        print(f"{name}: n={h['total']} mean={h['mean']:.3g}s"
              f" p50<={h['p50']:.3g}s p95<={h['p95']:.3g}s", file=out)
    ops = {k: v for k, v in metrics.get("counters", {}).items()
           if k.startswith("ops/")}
    if ops:
        print("kernel op calls: "
              + "  ".join(f"{k[4:]}={int(v)}" for k, v in sorted(
                  ops.items())), file=out)


def _demo(out=sys.stdout) -> int:
    """Round trip: churn + OOM sim with obs on → export → re-read →
    report.  Exits non-zero when the trace fails to parse or comes back
    without the expected span/counter structure."""
    import os
    import tempfile

    from repro_torch import obs
    from repro_torch.obs.churn import churn_oom_sim
    from repro_torch.obs.export import export_chrome_trace, export_metrics

    obs.enable()
    try:
        churn_oom_sim(n_nodes=60, n_jobs=120)
    finally:
        obs.disable()
    with tempfile.TemporaryDirectory() as td:
        tpath = os.path.join(td, "trace.json")
        mpath = os.path.join(td, "metrics.json")
        export_chrome_trace(tpath)
        export_metrics(mpath)
        with open(tpath) as fh:
            trace = json.load(fh)           # must parse back
        with open(mpath) as fh:
            metrics = json.load(fh)
    obs.clear()
    evs = trace["traceEvents"]
    checks = {
        "job spans": any(e.get("ph") == "X" and e.get("cat") == "job"
                         for e in evs),
        "sched spans": any(e.get("ph") == "X" and e.get("cat") == "sched"
                           for e in evs),
        "oom instants": any(e.get("ph") == "i" and e.get("name") == "oom"
                            for e in evs),
        "utilization counters": any(e.get("ph") == "C" and
                                    e.get("name") == "cluster.util_pct"
                                    for e in evs),
    }
    report(trace, metrics, out=out)
    missing = [k for k, ok in checks.items() if not ok]
    if missing:
        print(f"DEMO FAILED: trace missing {missing}", file=out)
        return 1
    print("demo round trip ok "
          f"({len(evs)} events exported, parsed, reported)", file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize an observability-plane export")
    ap.add_argument("--trace", default="", help="chrome trace JSON path")
    ap.add_argument("--metrics", default="", help="metrics dump JSON path")
    ap.add_argument("--top", type=int, default=10,
                    help="longest-queued jobs to list")
    ap.add_argument("--demo", action="store_true",
                    help="run a churn+OOM sim with obs on, export,"
                         " re-read, report (the obs-smoke round trip)")
    args = ap.parse_args(argv)
    if args.demo:
        return _demo()
    if not args.trace and not args.metrics:
        ap.error("need --trace and/or --metrics (or --demo)")
    trace = {}
    metrics = {}
    if args.trace:
        with open(args.trace) as fh:
            trace = json.load(fh)
    if args.metrics:
        with open(args.metrics) as fh:
            metrics = json.load(fh)
    report(trace, metrics, top=args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
