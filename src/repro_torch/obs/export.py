"""Exporters: Chrome trace-event JSON (Perfetto / ``chrome://tracing``)
and a JSON metrics dump.

The port's copy of the JAX package's ``repro.obs.export``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

``chrome_trace()`` converts the tracer's ring buffer plus the registry's
downsampled series into the Chrome trace-event format —
``{"traceEvents": [...]}`` with

* ``"X"`` complete events for job-state segments (process "jobs", one
  thread per job) and scheduler passes (process "scheduler", one thread
  per triggering event kind; the span's ``dur`` is the pass's measured
  *wall* time rendered on the virtual timeline — the only wall-clock
  quantity in the trace, flagged in ``args.clock``);
* ``"i"`` instant events for OOMs, node faults, scale/migrate events and
  job failures (a normal finish is just its span closing);
* ``"C"`` counter events for every metrics time series (utilization %,
  queue depth, idle-by-type, replicas, SLO attainment) — one counter
  track per series, built from the bounded buckets, never raw samples;
* ``"M"`` metadata naming the processes/threads.

Timestamps: trace events carry virtual seconds; Chrome wants integer-ish
microseconds, so everything is scaled by 1e6.  The export is a pure read
of obs state — it can run after ``obs.disable()`` (data survives until
``clear()``/re-enable) and touches no engine state.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import METRICS, MetricsRegistry
from repro_torch.obs.trace import TRACER, Tracer

#: synthetic pids for the Perfetto process rows
PID_JOBS = 1
PID_SCHED = 2
PID_CLUSTER = 3

_S_TO_US = 1e6


def chrome_trace(tracer: Tracer = None,
                 metrics: MetricsRegistry = None) -> dict:
    """Build the Chrome trace-event payload (a JSON-able dict)."""
    tracer = tracer if tracer is not None else TRACER
    metrics = metrics if metrics is not None else METRICS
    events = [
        {"ph": "M", "pid": PID_JOBS, "name": "process_name",
         "args": {"name": "jobs"}},
        {"ph": "M", "pid": PID_SCHED, "name": "process_name",
         "args": {"name": "scheduler"}},
        {"ph": "M", "pid": PID_CLUSTER, "name": "process_name",
         "args": {"name": "cluster"}},
    ]
    sched_tids = {}
    for ev in tracer.events:
        tag = ev[0]
        if tag == "span":                   # ("span", jid, state, t0, t1)
            _, jid, state, t0, t1 = ev
            events.append({"ph": "X", "pid": PID_JOBS, "tid": jid,
                           "name": state, "cat": "job",
                           "ts": t0 * _S_TO_US,
                           "dur": max(t1 - t0, 0.0) * _S_TO_US})
        elif tag == "sched":           # ("sched", kind, t, wall_s, n_dec)
            _, kind, t, wall_s, n_dec = ev
            tid = sched_tids.setdefault(kind, len(sched_tids))
            events.append({"ph": "X", "pid": PID_SCHED, "tid": tid,
                           "name": f"sched:{kind}", "cat": "sched",
                           "ts": t * _S_TO_US,
                           "dur": max(wall_s, 0.0) * _S_TO_US,
                           "args": {"decisions": n_dec,
                                    "clock": "dur=wall, ts=virtual"}})
        else:                               # ("inst", name, t, arg)
            _, name, t, arg = ev
            events.append({"ph": "i", "pid": PID_CLUSTER, "tid": 0,
                           "name": name, "cat": "event", "s": "g",
                           "ts": t * _S_TO_US, "args": {"arg": arg}})
    for kind, tid in sched_tids.items():
        events.append({"ph": "M", "pid": PID_SCHED, "tid": tid,
                       "name": "thread_name", "args": {"name": kind}})
    for sname, series in metrics.series.items():
        track = sname.replace("/", ".")
        for p in series.points:             # [t, count, sum, min, max, last]
            events.append({"ph": "C", "pid": PID_CLUSTER, "name": track,
                           "ts": p[0] * _S_TO_US,
                           "args": {track: p[5]}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped,
                          "open_segments": tracer.open_segments}}


def export_chrome_trace(path: str, tracer: Tracer = None,
                        metrics: MetricsRegistry = None) -> dict:
    payload = chrome_trace(tracer, metrics)
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return payload


def metrics_dump(metrics: MetricsRegistry = None) -> dict:
    metrics = metrics if metrics is not None else METRICS
    return metrics.snapshot()


def export_metrics(path: str, metrics: MetricsRegistry = None) -> dict:
    payload = metrics_dump(metrics)
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return payload
