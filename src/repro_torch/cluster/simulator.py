"""Event-driven heterogeneous-cluster simulator (paper §V).

The port's copy of the JAX package's ``repro.cluster.simulator``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

Jobs arrive over time, a pluggable scheduler decides placement, and the
simulator advances a virtual clock computing queue time / JCT / aggregate
samples-per-second.  The throughput model is synchronous data parallel:
a job's rate is ``n_devices x min(per-device rate) x efficiency terms``
(tensor-parallel link penalty, data-parallel scaling penalty, cross-node
penalty) — the same structure MARP's ranking uses, so Frenzy's plan priority
is *consistent* with the simulated world (as in the paper, where MARP's
estimates come from the same profiles the testbed exhibits).

The event loop itself lives in ``repro_torch.core.lifecycle.LifecycleEngine`` —
one lifecycle implementation shared with the live orchestrator.  This
module contributes the sim-only pieces: the rate model (``job_rate``), the
result aggregation (``SimResult``), and the ``simulate()`` entry point,
which also accepts **cluster dynamics** (``cluster_events`` from
``repro_torch.cluster.traces.churn_schedule`` / ``spot_schedule``) and **elastic
reallocation** (``elastic=True``: running jobs migrate to better-ranked
MARP plans when capacity frees, charged a checkpoint-restore cost).

Scaling: cluster state lives in a single ``ClusterPool`` shared with the
scheduler (no per-event snapshot copies), and the event loop is
incremental — a capacity-growing event only re-runs the scheduler when the
freed capacity could actually admit a queued job (total idle >= the
smallest device count any queued job can run at).  Skipped runs cannot
change outcomes: admission always needs at least one job's cheapest plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.core import calibration
from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.core.has import Grant, Node
from repro_torch.core.lifecycle import (  # noqa: F401  (re-exported compat names)
    ClusterEvent, Job, LifecycleEngine, OomCheckFn, RateEvent, ReplanFn,
    Scheduler, DEFAULT_MIGRATION_BANDWIDTH, DEFAULT_SCALE_UP_DELAY,
)
from repro_torch.core.marp import ResourcePlan, _tp_efficiency, _dp_efficiency, \
    _active_analytic

#: Back-compat alias — the sim job *is* the unified lifecycle ``Job``.
SimJob = Job


@dataclass
class SimResult:
    jobs: List[Job]
    sched_time_s: float                     # wall time inside the scheduler
    sched_calls: int
    makespan: float
    preemptions: int = 0                    # node-departure requeues
    migrations: int = 0                     # elastic plan upgrades
    unfinished: int = 0                     # jobs never (re)completed
    ooms: int = 0                           # out-of-memory kills
    oom_failures: int = 0                   # jobs abandoned after retries
    #: per-OOM telemetry from the engine: (time, job_id, device_type,
    #: predicted bytes, observed bytes) — lets benchmarks count repeats
    oom_log: Sequence[Tuple[float, int, str, float, float]] = ()
    scale_ups: int = 0                      # serve replicas provisioned
    scale_downs: int = 0                    # serve replicas released
    #: scheduler wall time split by triggering event kind
    #: (arrive/finish/churn/oom/scale/...) — where the control plane
    #: actually spent its time (benchmarks/sched_scale telemetry)
    sched_time_by_kind: Dict[str, float] = field(default_factory=dict)
    peak_live_jobs: int = 0                 # max concurrently-live jobs
    # failure plane (all zero on fault-free runs)
    node_fails: int = 0                     # abrupt node crash-faults
    crashes: int = 0                        # job crashes (fault victims)
    crash_failures: int = 0                 # jobs abandoned over the budget
    replica_fails: int = 0                  # serve replicas lost to faults
    lost_work_s: float = 0.0                # compute rolled back by crashes
    ckpt_overhead_s: float = 0.0            # run time spent saving state
    useful_work_s: float = 0.0              # durable non-serve compute
    #: per-victim crash log: (time, node_id, job_id, lost_work_s)
    failure_log: Sequence[Tuple[float, str, int, float]] = ()
    #: entries evicted from the engine's ring-bounded raw logs —
    #: 0 in every committed benchmark; nonzero means the returned log is
    #: the newest ``DEFAULT_LOG_CAPACITY`` entries, reported not silent
    oom_log_dropped: int = 0
    failure_log_dropped: int = 0

    @property
    def goodput(self) -> float:
        """Durable-progress fraction of all non-serve compute: useful over
        useful + rolled-back + checkpoint-stall seconds (NaN with no
        accounted work)."""
        total = self.useful_work_s + self.lost_work_s + self.ckpt_overhead_s
        if total <= 0.0:
            return float("nan")
        return self.useful_work_s / total

    @property
    def finished(self) -> List[Job]:
        return [j for j in self.jobs if j.finish_time >= 0]

    @property
    def serve_jobs(self) -> List[Job]:
        return [j for j in self.jobs if j.kind == "serve"]

    @property
    def slo_attainment(self) -> float:
        """Aggregate fraction of accounted serve time the p95 target was
        met (NaN with no serve jobs)."""
        total = sum(j.slo_total_s for j in self.serve_jobs)
        if total <= 0.0:
            return float("nan")
        return sum(j.slo_good_s for j in self.serve_jobs) / total

    @property
    def serve_gpu_seconds(self) -> float:
        """Device-seconds the serve replica groups consumed — the quantity
        SLO-aware autoscaling saves against a static-replica baseline."""
        return sum(j.gpu_seconds for j in self.serve_jobs)

    @property
    def serve_p95_latency(self) -> float:
        """Time-weighted mean of the modeled p95 token latency over served
        segments (NaN with none) — the latency cell of
        ``benchmarks/serve_autoscale.py``."""
        obs = sum(j.p95_obs_s for j in self.serve_jobs)
        if obs <= 0.0:
            return float("nan")
        return sum(j.p95_weight_s for j in self.serve_jobs) / obs

    @property
    def serve_tokens(self) -> float:
        """Decode tokens actually served (demand capped by capacity)."""
        return sum(j.tokens_served for j in self.serve_jobs)

    @property
    def serve_tok_per_device_s(self) -> float:
        """Serving throughput per device-second — tokens served over the
        GPU-seconds both pools consumed (NaN with no serve time)."""
        gpu_s = self.serve_gpu_seconds
        if gpu_s <= 0.0:
            return float("nan")
        return self.serve_tokens / gpu_s

    @property
    def avg_jct(self) -> float:
        done = self.finished
        if not done:                        # churn can starve every job
            return float("nan")
        return sum(j.jct for j in done) / len(done)

    @property
    def avg_queue_time(self) -> float:
        done = self.finished
        if not done:
            return float("nan")
        return sum(j.queue_time for j in done) / len(done)

    @property
    def avg_samples_per_s(self) -> float:
        done = self.finished
        if not done:
            return float("nan")
        return sum(j.total_samples / max(j.finish_time - j.start_time, 1e-9)
                   for j in done) / len(done)


def job_rate(job: Job, placements: Sequence[Tuple[str, int]],
             nodes: Dict[str, Node], d: int, t: int) -> float:
    """Samples/s of a placed job (synchronous DP: slowest device gates).

    Serve jobs progress in wall-clock seconds (``total_samples`` is the
    serving horizon): rate 1.0, with throughput/SLO handled by the
    engine's replica accounting, not the finish clock."""
    if job.kind == "serve":
        return 1.0
    n_devices = 0
    shared = False
    slowest = None
    p0 = placements[0]
    first_type = nodes[p0.node_id if isinstance(p0, Grant)
                       else p0[0]].device_type
    for p in placements:
        node_id, k = p
        dt = nodes[node_id].device_type
        flops = DEVICE_TYPES[dt].flops
        if slowest is None or flops < slowest:
            slowest = flops
        if k == 0 and isinstance(p, Grant):
            # memory slice (colocation): one device's compute, shared
            # with the exclusive tenant it harvests slack from
            n_devices += p.k
            shared = True
        else:
            n_devices += k
    dev = DEVICE_TYPES[first_type]
    n_active = _active_analytic(job.cfg)
    flops_per_sample = 6.0 * n_active * job.seq_len
    # same MFU source as MARP's ranking (calibration table when enabled,
    # the seed's 0.45 otherwise) so plan priority stays consistent with
    # the simulated world
    eff = calibration.mfu_for(job.cfg.family, dev.name) \
        * _tp_efficiency(t, dev) * _dp_efficiency(d)
    if len({nid for nid, _ in placements}) > 1:
        eff *= 0.75                          # cross-node penalty
    if shared:
        eff *= 0.5                           # compute-sharing discount
    return n_devices * slowest * eff / flops_per_sample


def simulate(jobs: Sequence[Job], nodes: Sequence[Node],
             scheduler: Scheduler, charge_overhead: bool = True, *,
             cluster_events: Sequence[ClusterEvent] = (),
             rate_events: Sequence[RateEvent] = (),
             elastic: bool = False,
             migration_bandwidth: float = DEFAULT_MIGRATION_BANDWIDTH,
             oom_check_fn: OomCheckFn = None,
             replan_fn: ReplanFn = None,
             max_oom_retries: int = 8,
             scale_up_delay: float = DEFAULT_SCALE_UP_DELAY,
             ckpt_policy: str = None,
             ckpt_fixed_interval_s: float = 0.0,
             restart_backoff_s: float = 0.0,
             max_restarts: int = None,
             colocate: bool = False
             ) -> SimResult:
    """Drive the shared lifecycle engine over a trace.

    charge_overhead: add measured scheduler wall time to the virtual
    clock (the paper's Fig 5a overhead feeds its JCT comparison).
    cluster_events: node_join/node_leave/node_fail/reschedule dynamics
    (churn/spot/failure traces).
    rate_events: request_rate_change traces for serve jobs
    (``traces.serve_workload``) — the SLO autoscaler reacts to them.
    elastic: allow running jobs to migrate to better-ranked plans.
    oom_check_fn: misprediction model (``traces.misprediction_oracle``) —
    placements whose true peak exceeds device memory die in an ``oom``
    event, feed the memory feedback plane, and requeue.
    replan_fn: post-OOM plan re-ranking (against the updated corrector).
    scale_up_delay: seconds from a serve scale-up decision to the replicas
    serving (0 = warm-pool provisioning).
    ckpt_policy / ckpt_fixed_interval_s / restart_backoff_s /
    max_restarts: failure plane — periodic-checkpoint policy
    (None | "young_daly" | "fixed") and the crashed-job restart budget;
    all dormant at the defaults.
    colocate: fractional-GPU packing — serve replicas and LoRA
    finetune jobs harvest slack bytes of running train jobs (memory-slice
    ``Grant`` placements; requires ``HASAdmission``-family schedulers).
    """
    engine = LifecycleEngine(nodes, scheduler,
                             charge_overhead=charge_overhead,
                             elastic=elastic,
                             migration_bandwidth=migration_bandwidth,
                             oom_check_fn=oom_check_fn,
                             replan_fn=replan_fn,
                             max_oom_retries=max_oom_retries,
                             scale_up_delay=scale_up_delay,
                             ckpt_policy=ckpt_policy,
                             ckpt_fixed_interval_s=ckpt_fixed_interval_s,
                             restart_backoff_s=restart_backoff_s,
                             max_restarts=max_restarts,
                             reset=True,
                             colocate=colocate)
    pool_nodes = engine.pool.nodes
    engine.rate_fn = lambda job, placements, d, t: \
        job_rate(job, placements, pool_nodes, d, t)
    engine.run(jobs, cluster_events, rate_events)
    unfinished = [j for j in jobs if j.finish_time < 0]
    if not cluster_events and engine.oom_count == 0:
        # static cluster, no OOMs: capacity never shrinks and nothing
        # crash-loops, so every job must complete
        assert not unfinished, f"{len(unfinished)} jobs never scheduled"
    return SimResult(jobs=list(jobs), sched_time_s=engine.sched_time_s,
                     sched_calls=engine.sched_calls,
                     makespan=engine.makespan,
                     preemptions=engine.preemption_count,
                     migrations=engine.migration_count,
                     unfinished=len(unfinished),
                     ooms=engine.oom_count,
                     oom_failures=engine.oom_failures,
                     oom_log=tuple(engine.oom_log),
                     scale_ups=engine.scale_up_count,
                     scale_downs=engine.scale_down_count,
                     sched_time_by_kind=dict(engine.sched_time_by_kind),
                     peak_live_jobs=engine.peak_live_jobs,
                     node_fails=engine.node_fail_count,
                     crashes=engine.crash_count,
                     crash_failures=engine.crash_failures,
                     replica_fails=engine.replica_fail_count,
                     lost_work_s=engine.lost_work_s,
                     ckpt_overhead_s=engine.ckpt_overhead_s,
                     useful_work_s=engine.useful_work_s,
                     failure_log=tuple(engine.failure_log),
                     oom_log_dropped=engine.oom_log.dropped,
                     failure_log_dropped=engine.failure_log.dropped)


@dataclass
class StreamResult:
    """Aggregate accounting of a streamed simulation (``simulate_stream``).

    Job objects are dropped as they finish, so per-job lists are replaced
    by running sums — everything else mirrors ``SimResult``."""
    n_jobs: int                             # jobs pulled from the stream
    n_finished: int
    n_failed: int
    sum_jct: float
    sum_queue_time: float
    max_jct: float
    sched_time_s: float
    sched_calls: int
    makespan: float
    peak_live_jobs: int
    sched_time_by_kind: Dict[str, float] = field(default_factory=dict)
    preemptions: int = 0
    migrations: int = 0
    ooms: int = 0
    oom_failures: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    # failure plane (all zero on fault-free runs)
    node_fails: int = 0
    crashes: int = 0
    crash_failures: int = 0
    lost_work_s: float = 0.0
    ckpt_overhead_s: float = 0.0
    useful_work_s: float = 0.0
    #: ring-bounded raw-log evictions (see ``SimResult``) — the streamed
    #: path is exactly where the unbounded logs used to bite
    oom_log_dropped: int = 0
    failure_log_dropped: int = 0

    @property
    def goodput(self) -> float:
        """Durable-progress fraction (see ``SimResult.goodput``)."""
        total = self.useful_work_s + self.lost_work_s + self.ckpt_overhead_s
        if total <= 0.0:
            return float("nan")
        return self.useful_work_s / total

    @property
    def avg_jct(self) -> float:
        return self.sum_jct / self.n_finished if self.n_finished \
            else float("nan")

    @property
    def avg_queue_time(self) -> float:
        return self.sum_queue_time / self.n_finished if self.n_finished \
            else float("nan")

    @property
    def unfinished(self) -> int:
        return self.n_jobs - self.n_finished - self.n_failed


def simulate_stream(jobs: Iterable[Job], nodes: Sequence[Node],
                    scheduler: Scheduler, charge_overhead: bool = True, *,
                    cluster_events: Iterable[ClusterEvent] = (),
                    rate_events: Iterable[RateEvent] = (),
                    elastic: bool = False,
                    migration_bandwidth: float =
                    DEFAULT_MIGRATION_BANDWIDTH,
                    oom_check_fn: OomCheckFn = None,
                    replan_fn: ReplanFn = None,
                    max_oom_retries: int = 8,
                    scale_up_delay: float = DEFAULT_SCALE_UP_DELAY,
                    ckpt_policy: str = None,
                    ckpt_fixed_interval_s: float = 0.0,
                    restart_backoff_s: float = 0.0,
                    max_restarts: int = None,
                    colocate: bool = False
                    ) -> StreamResult:
    """Drive the lifecycle engine over *streamed* traces: ``jobs`` (and
    the event traces) may be generators (``traces.scale_workload_iter``
    etc.), and finished jobs are dropped from the engine's live map
    (``retain_jobs=False``) — a 1M-job sim holds only live jobs plus the
    queue, never the full trace.  Statistics accumulate in a
    ``StreamResult`` as jobs complete."""
    acc = {"n": 0, "fin": 0, "fail": 0, "jct": 0.0, "queue": 0.0,
           "max_jct": 0.0}

    def on_complete(job: Job) -> None:
        if job.state == "done":
            acc["fin"] += 1
            acc["jct"] += job.jct
            acc["queue"] += job.queue_time
            acc["max_jct"] = max(acc["max_jct"], job.jct)
        else:
            acc["fail"] += 1

    def counted(src: Iterable[Job]):
        for job in src:
            acc["n"] += 1
            yield job

    engine = LifecycleEngine(nodes, scheduler,
                             charge_overhead=charge_overhead,
                             elastic=elastic,
                             migration_bandwidth=migration_bandwidth,
                             oom_check_fn=oom_check_fn,
                             replan_fn=replan_fn,
                             max_oom_retries=max_oom_retries,
                             scale_up_delay=scale_up_delay,
                             ckpt_policy=ckpt_policy,
                             ckpt_fixed_interval_s=ckpt_fixed_interval_s,
                             restart_backoff_s=restart_backoff_s,
                             max_restarts=max_restarts,
                             retain_jobs=False,
                             on_complete=on_complete,
                             reset=True,
                             colocate=colocate)
    pool_nodes = engine.pool.nodes
    engine.rate_fn = lambda job, placements, d, t: \
        job_rate(job, placements, pool_nodes, d, t)
    # the generator wrapper also forces the engine's streaming run path
    # (an all-list input would take the materialized fast path); list
    # cluster/rate traces are still accepted — the engine sorts those
    engine.run(counted(iter(jobs)), cluster_events, rate_events)
    return StreamResult(n_jobs=acc["n"], n_finished=acc["fin"],
                        n_failed=acc["fail"], sum_jct=acc["jct"],
                        sum_queue_time=acc["queue"],
                        max_jct=acc["max_jct"],
                        sched_time_s=engine.sched_time_s,
                        sched_calls=engine.sched_calls,
                        makespan=engine.makespan,
                        peak_live_jobs=engine.peak_live_jobs,
                        sched_time_by_kind=dict(engine.sched_time_by_kind),
                        preemptions=engine.preemption_count,
                        migrations=engine.migration_count,
                        ooms=engine.oom_count,
                        oom_failures=engine.oom_failures,
                        scale_ups=engine.scale_up_count,
                        scale_downs=engine.scale_down_count,
                        node_fails=engine.node_fail_count,
                        crashes=engine.crash_count,
                        crash_failures=engine.crash_failures,
                        lost_work_s=engine.lost_work_s,
                        ckpt_overhead_s=engine.ckpt_overhead_s,
                        useful_work_s=engine.useful_work_s,
                        oom_log_dropped=engine.oom_log.dropped,
                        failure_log_dropped=engine.failure_log.dropped)
