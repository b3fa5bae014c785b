"""Resource Orchestrator (paper §IV): tracks heterogeneous cluster state,
executes allocation/release, and drives the serverless job lifecycle.

The port's copy of the JAX package's ``repro.core.orchestrator``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).

The lifecycle itself (admission, FIFO restart on release, node churn
handling) lives in ``repro_torch.core.lifecycle.LifecycleEngine`` — the same
implementation the cluster simulator drives — so the live path and the sim
path cannot drift.  The orchestrator is the live-cluster face of it: no
virtual clock, jobs finish when ``release`` is called, and ``node_join`` /
``node_leave`` mirror real capacity coming and going (departing nodes'
jobs are checkpoint-preempted and requeued with their progress).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.core.has import Allocation, ClusterPool, Node
from repro_torch.core.lifecycle import HASAdmission, Job, LifecycleEngine
from repro_torch.core.marp import ResourcePlan

#: Back-compat alias — the live job record *is* the unified lifecycle Job.
JobRecord = Job


class Orchestrator:
    """Owns cluster state; allocate/release are the only mutation points.

    State lives in a long-lived ``ClusterPool`` inside the shared
    ``LifecycleEngine``, so every HAS pass is an indexed lookup rather than
    a cluster scan — allocation/release keep the per-class idle counters in
    sync incrementally.  The engine's queue is the sharded
    ``AdmissionQueue``: live arrivals take the O(plans) single-job fast
    path, and release-triggered passes walk only shards whose cheapest
    plan could fit the idle counters — decisions stay bit-identical to a
    full FIFO scan (the control-plane-at-scale invariant, ROADMAP)."""

    def __init__(self, nodes: Sequence[Node]):
        self.engine = LifecycleEngine(nodes, HASAdmission())
        # after an OOM the job's ranking is stale by construction: the
        # feedback plane just learned the prediction was wrong, so requeue
        # against a fresh MARP sweep (identical plans while the plane is
        # off — predict_plans is memoized on the same token)
        self.engine.replan_fn = self._replan
        self.pool: ClusterPool = self.engine.pool
        self.nodes: Dict[str, Node] = self.pool.nodes
        self.jobs: Dict[int, Job] = self.engine.jobs
        self._ids = itertools.count()
        # the live path has no wall clock: submit/release/churn calls tick
        # an event counter, so Job.queue_time/jct read as "events waited"
        self._clock = itertools.count()

    # ------------------------------------------------------------ state --
    def idle_devices(self) -> int:
        return self.pool.total_idle

    def snapshot(self) -> List[Node]:
        return list(self.nodes.values())

    # ------------------------------------------------------- lifecycle ---
    def submit(self, plans: Sequence[ResourcePlan], *, cfg=None,
               global_batch: int = 0, seq_len: int = 0,
               mode: str = "exact") -> Job:
        """Serverless arrival: one admission policy (FIFO + ranked HAS).
        ``cfg``/``global_batch``/``seq_len``/``mode`` let the lifecycle
        replan the job after an OOM with the same memory model it was
        admitted under (``serverless.submit`` passes them)."""
        job = Job(job_id=next(self._ids), plans=plans, cfg=cfg,
                  global_batch=global_batch, seq_len=seq_len,
                  plan_mode=mode)
        job.arrival = float(next(self._clock))
        self.engine.submit_job(job, now=job.arrival)
        return job

    def _replan(self, job: Job) -> Sequence[ResourcePlan]:
        """Post-OOM ranking refresh against the live catalog + feedback,
        under the job's original memory model (serve jobs re-rank through
        the serve sweep — same corrector, zero=0)."""
        if job.cfg is None or not job.global_batch:
            return job.plans
        device_types = sorted({n.device_type for n in self.nodes.values()})
        if job.kind == "serve":
            from repro_torch.core.marp import predict_serve_plans
            return predict_serve_plans(job.cfg, job.global_batch,
                                       job.seq_len,
                                       device_types=device_types)
        from repro_torch.core.marp import predict_plans
        zero = job.plans[0].zero if job.plans else 1
        return predict_plans(job.cfg, job.global_batch, job.seq_len,
                             device_types=device_types, zero=zero,
                             mode=job.plan_mode)

    # -------------------------------------------------------- serving ---
    def submit_serve(self, plans: Sequence[ResourcePlan], *, cfg=None,
                     batch: int = 0, cache_len: int = 0,
                     request_rate: float = 0.0, slo_p95_s: float = 0.0,
                     autoscale: bool = True,
                     static_replicas: int = 0) -> Job:
        """Serve arrival: same admission policy, ``kind="serve"`` — the
        lifecycle starts one replica and scales the group to the SLO
        target (or pins ``static_replicas``)."""
        job = Job(job_id=next(self._ids), plans=plans, cfg=cfg,
                  global_batch=batch, seq_len=cache_len, kind="serve",
                  request_rate=float(request_rate),
                  slo_p95_s=float(slo_p95_s), autoscale=autoscale,
                  static_replicas=static_replicas)
        job.arrival = float(next(self._clock))
        self.engine.submit_job(job, now=job.arrival)
        return job

    def set_request_rate(self, job_id: int, rate: float) -> Optional[Job]:
        """Live ``request_rate_change``: the SLO autoscaler immediately
        rescales the replica group (scale-up may be short if the pool is
        tight; it is retried whenever capacity frees)."""
        return self.engine.set_request_rate(job_id, rate,
                                            now=float(next(self._clock)))

    def try_start(self, rec: Job) -> bool:
        """Single-job admission attempt (bypasses queue order)."""
        return self.engine.try_admit(rec, now=float(next(self._clock)))

    def release(self, job_id: int) -> None:
        """Job completed: free its devices and restart queued jobs through
        the shared admission policy (FIFO with backfill)."""
        self.engine.complete_job(job_id, now=float(next(self._clock)))

    def oom(self, job_id: int, observed_bytes: float) -> Optional[Job]:
        """A runner reported the job died out-of-memory at ``observed_bytes``
        peak.  The shared lifecycle feeds the observation into the memory
        feedback plane (``core.memtrace``) and requeues the job with its
        accrued progress; with the plane enabled, the corrected prediction
        keeps it off the placement that just killed it."""
        return self.engine.oom_job(job_id, observed_bytes,
                                   now=float(next(self._clock)))

    # --------------------------------------------------- cluster churn ---
    def node_join(self, node: Optional[Node] = None,
                  node_id: str = "") -> Optional[Node]:
        """Capacity arrives (new node, or a departed node returning);
        queued jobs are re-admitted immediately."""
        return self.engine.node_join(node, node_id,
                                     now=float(next(self._clock)))

    def node_leave(self, node_id: str) -> List[Job]:
        """Capacity departs: jobs touching the node are checkpoint-preempted
        and requeued (they restart, possibly smaller, as space allows).
        Returns the preempted jobs."""
        return self.engine.node_leave(node_id, now=float(next(self._clock)))

    def node_fail(self, node_id: str) -> List[Job]:
        """A node crash-faulted (abrupt — no checkpoint on the way out):
        victims roll back to their last durable checkpoint and restart
        under the engine's combined restart budget; serve jobs losing only
        part of their replica group stay up degraded.  Returns the
        fully-crashed jobs."""
        return self.engine.node_fail(node_id, now=float(next(self._clock)))


def make_cluster(spec: Sequence[tuple]) -> List[Node]:
    """spec: [(count, devices_per_node, device_type), ...] -> Node list."""
    nodes = []
    i = 0
    for count, per_node, dt in spec:
        mem = DEVICE_TYPES[dt].mem
        for _ in range(count):
            nodes.append(Node(node_id=f"n{i}-{dt}", device_type=dt,
                              mem=mem, total=per_node, idle=per_node))
            i += 1
    return nodes


# The paper's two experimental clusters (§V-A).
PAPER_REAL_CLUSTER = [
    (1, 2, "A100-40G"), (1, 1, "A100-40G"), (1, 4, "A800-80G"),
    (2, 2, "A100-80G"),
]
PAPER_SIM_CLUSTER = [
    (3, 8, "RTX2080Ti"), (2, 8, "A100-40G"), (1, 4, "RTX6000"),
]
# TPU adaptation: a heterogeneous TPU fleet (DESIGN.md §3).
TPU_FLEET = [
    (4, 8, "v5e"), (2, 4, "v4"), (1, 4, "v5p"),
]
