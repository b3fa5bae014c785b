"""Unified serverless job lifecycle engine (paper §I, §IV).

The port's copy of the JAX package's ``repro.core.lifecycle``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).

Frenzy's pitch is a serverless front door: users submit a model and the
system owns the whole lifecycle.  This module is that lifecycle, once —
previously it was implemented twice, as ``JobRecord`` + ad-hoc restart in
``core/orchestrator.py`` (live path) and as ``SimJob`` + a private event
loop in ``cluster/simulator.py`` (sim path).  Both paths now drive one
``LifecycleEngine`` around one ``Job`` abstraction.

Typed event set
---------------
``arrive``      a job enters the queue; the admission policy runs.
``finish``      a running job completes (sim: self-scheduled from the rate
                model; live: an external ``complete_job`` call); capacity is
                released and queued jobs are re-admitted FIFO.
``node_join``   a node (re)joins: capacity grows, admission re-runs when the
                exact ``min_devices`` gate passes, demoted jobs may migrate.
``node_leave``  a node departs *gracefully*: jobs touching it are
                checkpointed (progress accrued) and requeued with their
                remaining work; the node leaves the indexed pool.
``node_fail``   a node crash-faults: victims are rolled back to
                their last *durable* periodic checkpoint — progress since
                it is lost (``lost_work_s``) — and restart under an
                exponential-backoff budget (``max_restarts`` across every
                cause).  Serve jobs that only lose part of their replica
                group stay up degraded and refill through the serve
                backlog.  The node leaves the pool abruptly.
``restart``     a crashed job's backoff expired: it re-enters the queue
                with preemption priority and admission re-runs.
``reschedule``  explicit trigger: re-run admission + the elastic scan.
``request_rate_change``  (serve jobs) the offered request rate moved; the
                SLO autoscaler recomputes the replica target from the p95
                token-latency model (``marp.replicas_for_slo``) and emits
                ``scale_up`` / ``scale_down`` events.
``scale_up``    (serve jobs) admit additional replicas of the running plan
                from the shared pool (after ``scale_up_delay`` — 0 by
                default: serverless warm-pool provisioning).
``scale_down``  (serve jobs) release surplus replicas back to the pool
                (freed capacity immediately re-admits queued work).
``oom``         a running job exceeded device memory: the job is killed,
                the observed peak is fed back into the memory feedback
                plane (``core.memtrace`` — so the corrected prediction can
                never repeat the same OOM), and the job is requeued with
                its accrued progress onto the next satisfiable plan with
                headroom (``replan_fn`` re-ranks against the updated
                corrector).  After ``max_oom_retries`` the job is marked
                ``failed`` instead of looping.

Elasticity contract
-------------------
With ``elastic=True`` (sim path) a *running* job may migrate to a
better-ranked MARP plan when capacity frees.  A migration is committed only
when the new placement exists alongside the old one (checkpoint-restore:
the job keeps computing until the restore target is secured), the new rate
is higher, and the predicted finish — charged a migration cost of
save+restore of the training state (``ckpt.checkpoint.migration_seconds``)
— strictly improves.  Preempted jobs resume from their accrued progress and
pay the same restore cost; schedulers see them first, ordered by remaining
work (``fifo_order``).

Serving contract
----------------
A ``kind="serve"`` job is a long-lived replica group: admission starts one
replica under the best satisfiable serve plan (``marp.predict_serve_plans``
ranking, ``zero=0``), and the SLO autoscaler keeps
``replicas_for_slo(replica_rate, step_s, request_rate, slo_p95_s)``
replicas of that plan alive as the offered rate moves — replicas are plain
pool placements, so serve groups co-schedule, preempt, and OOM-requeue
through exactly the machinery train jobs use.  SLO attainment is accrued
segment-by-segment (every rate/scale/lifecycle transition closes a
segment): a segment is *good* when the p95 token latency of the current
replica group meets the job's target; ``gpu_seconds`` accrues
``replicas x plan.n_devices`` over the same segments.  Jobs with
``autoscale=False`` pin ``static_replicas`` (the benchmark baseline).

Failure contract
-----------------------
``node_leave`` stays the *graceful* departure: zero lost work.  A
``node_fail`` is abrupt: each victim keeps only the progress its periodic
checkpoints made durable.  With ``ckpt_policy`` enabled every non-serve
job checkpoints every ``tau`` seconds (per-job ``ckpt_interval_s``
override, else Young–Daly ``sqrt(2*C*MTBF_agg)`` from the per-DeviceType
MTBF catalog, else the fixed interval), stalling ``C =
ckpt.checkpoint_seconds(cfg)`` per save — folded into an *effective* rate
``rate * tau/(tau+C)`` so finish predictions, elastic comparisons, and
accrual all price the overhead consistently.  On a crash the job rolls
back to its last completed cycle boundary; with no policy it rolls back
to its last graceful checkpoint event (possibly the start).  Crashed jobs
restart after a deterministic exponential backoff with per-(job, attempt)
jitter, sharing one ``max_restarts`` budget with the OOM retry loop.
Everything here is opt-in: with no ``node_fail`` events and no checkpoint
policy, every new code path is dormant and the engine is bit-identical to
the list-scan behavior (golden-tested).

Static-cluster guarantee: with ``elastic=False`` and no node events, the
engine's decisions are bit-identical to the seed event loop and the seed
orchestrator (``tests/test_golden_equivalence.py``) — stale-event epochs,
progress accrual, and priority ordering are all dormant on that path, and
every serve mechanism is keyed off ``kind="serve"`` jobs, so serve-free
runs never touch it.
"""
from __future__ import annotations

import heapq
import math
import os
import random
import time
from bisect import bisect_left, insort
from collections import deque
from collections.abc import Sequence as _SequenceABC
from dataclasses import dataclass, field
from itertools import chain
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Set, Tuple, Union)

from repro_torch.core import memtrace
from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.core.has import Allocation, ClusterPool, Grant, Node
from repro_torch.core.marp import (ResourcePlan, default_ttft_slo,
                             p95_token_latency, prefill_service_seconds,
                             replicas_for_slo, serve_plan_capacity)
# observability plane: every hook below is pure accumulation and
# guarded by a single ``.enabled`` read — with obs off the engine is
# bit-identical to before (golden-tested), with obs on decisions still
# never read obs state (telemetry-is-free invariant)
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import DEFAULT_LOG_CAPACITY, RingLog, TRACER

# Event kinds (the typed event set).
ARRIVE = "arrive"
FINISH = "finish"
NODE_JOIN = "node_join"
NODE_LEAVE = "node_leave"
NODE_FAIL = "node_fail"
RESCHEDULE = "reschedule"
OOM = "oom"
RATE_CHANGE = "request_rate_change"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
RESTART = "restart"

#: bytes/s assumed for checkpoint save+restore during migration/preemption
DEFAULT_MIGRATION_BANDWIDTH = 16 * 2 ** 30

#: seconds from a scale-up decision to the replicas serving.  0 models the
#: serverless warm pool (weights resident, replicas spin up within a
#: virtual-clock tick); benchmarks raise it to study cold provisioning.
DEFAULT_SCALE_UP_DELAY = 0.0


@dataclass(eq=False)
class Job:
    """One job, from submission to completion — the single abstraction
    behind the former ``JobRecord`` (live) / ``SimJob`` (sim) split.

    Compared/hashable by identity (``eq=False``): a job is an entity with
    mutable lifecycle state, not a value."""
    job_id: int
    arrival: float = 0.0
    cfg: object = None                      # ModelConfig (None in unit fuzz)
    global_batch: int = 0
    seq_len: int = 0
    total_samples: int = 1                  # work to do
    plans: Sequence[ResourcePlan] = ()      # MARP's ranked plans
    plan_mode: str = "exact"                # memory model the plans used
    requested_n: int = 0                    # user-specified count (baselines)
    # lifecycle state
    state: str = "queued"       # queued | running | backoff | done | failed
    start_time: float = -1.0                # first admission (queue_time base)
    finish_time: float = -1.0
    placements: Tuple[Tuple[str, int], ...] = ()
    rate: float = 0.0                       # samples/s while running (sim)
    allocation: Optional[Allocation] = None
    plan: Optional[ResourcePlan] = None     # plan currently running under
    plan_rank: int = -1                     # index of ``plan`` in ``plans``
    # elasticity / churn state
    samples_done: float = 0.0               # progress accrued at checkpoints
    progress_time: float = 0.0              # virtual time progress resumes
    epoch: int = 0                          # bumps on preempt/migrate;
                                            # stale finish events are dropped
    preemptions: int = 0
    migrations: int = 0
    #: per-cause restart ledger ("oom" kills, "crash" node-faults) — one
    #: combined budget: an OOM-then-crash job cannot exceed ``max_restarts``
    #: across causes.  Read ``ooms`` / ``total_restarts`` for the counts.
    restarts: Dict[str, int] = field(default_factory=dict)
    # failure-plane state (all dormant — zero — unless node_fail
    # events arrive or a checkpoint policy is enabled)
    ckpt_interval_s: float = 0.0            # per-job override; 0 = policy
    ckpt_cost_s: float = 0.0                # seconds one durable save stalls
    lost_work_s: float = 0.0                # progress rolled back by crashes
    ckpt_overhead_s: float = 0.0            # run time spent saving state
    replica_fails: int = 0                  # serve replicas lost to faults
    _ckpt_tau: float = field(default=0.0, repr=False)  # active interval
    # fine-tune state (kind == "finetune"): LoRA adapters train a tiny
    # parameter set, so the serialized training state — and with it every
    # checkpoint, preemption restart, and migration — is near-free
    # (``ckpt.checkpoint.lora_state_bytes``).  Placement/memory still use
    # the base model's plans: the frozen weights and activations dominate.
    lora_rank: int = 0                      # 0: full training state
    # serving state (kind == "serve"; dormant defaults otherwise)
    kind: str = "train"                     # train | finetune | serve
    request_rate: float = 0.0               # offered decode tokens/s
    slo_p95_s: float = 0.0                  # p95 token-latency target
    autoscale: bool = True                  # False: pin static_replicas
    static_replicas: int = 0                # baseline fixed replica count
    max_replicas: int = 64
    serve_replicas: int = 0                 # live replica count
    replica_placements: List[Tuple[Tuple[str, int], ...]] = \
        field(default_factory=list)
    replica_rate: float = 0.0               # tokens/s one replica attains
    replica_step_s: float = 0.0             # seconds per decode step
    scale_ups: int = 0
    scale_downs: int = 0
    slo_good_s: float = 0.0                 # seconds the p95 target was met
    slo_total_s: float = 0.0                # seconds since arrival accounted
    gpu_seconds: float = 0.0                # device-seconds consumed serving
    serve_accounted: float = -1.0           # last SLO-accounting timestamp
    p95_weight_s: float = 0.0               # integral of modeled p95 over
    p95_obs_s: float = 0.0                  #   served segments (+ their dt)
    tokens_served: float = 0.0              # integral of min(rate, capacity)
    # disaggregated serving (opt-in: the prefill pool only exists when
    # ``disaggregated`` is set; everything below stays dormant otherwise
    # and the decode path above is bit-identical to the unified group)
    disaggregated: bool = False
    avg_prompt_len: float = 0.0             # prompt tokens per request
    avg_new_tokens: float = 0.0             # decode tokens per request
    slo_ttft_s: float = 0.0                 # p95 time-to-first-token target
    prefill_plans: Sequence[ResourcePlan] = ()   # role="prefill" ranking
    prefill_plan: Optional[ResourcePlan] = None  # pool's running plan
    prefill_replicas: int = 0               # live prefill replica count
    prefill_placements: List[Tuple[Tuple[str, int], ...]] = \
        field(default_factory=list)
    prefill_service_s: float = 0.0          # prompt forward + KV handoff
    #: cache for ``min_devices`` (0 = unset; recomputed when ``plans`` is
    #: replaced by the OOM replan path) — the admission queue reads it on
    #: every insert/remove, which is hot at 1M-job scale
    _min_dev: int = field(default=0, repr=False)

    @property
    def ooms(self) -> int:
        """OOM kills of this job (the "oom" row of the restart ledger)."""
        return self.restarts.get("oom", 0)

    @property
    def total_restarts(self) -> int:
        """Restarts across every cause — what the combined budget gates."""
        return sum(self.restarts.values())

    def record_restart(self, cause: str) -> None:
        self.restarts[cause] = self.restarts.get(cause, 0) + 1

    @property
    def slo_attainment(self) -> float:
        """Fraction of accounted time the p95 target was met (NaN before
        any accounting — train jobs, or a serve job never observed)."""
        if self.slo_total_s <= 0.0:
            return float("nan")
        return self.slo_good_s / self.slo_total_s

    @property
    def queue_time(self) -> float:
        """Wait from arrival to first start — virtual seconds on the sim
        path, event ordinals on the live path (its clock is the
        orchestrator's submission/release counter).  NaN until started."""
        if self.start_time < 0:
            return float("nan")
        return self.start_time - self.arrival

    @property
    def jct(self) -> float:
        """Completion time since arrival (same clock caveat as
        ``queue_time``).  NaN until finished."""
        if self.finish_time < 0:
            return float("nan")
        return self.finish_time - self.arrival

    @property
    def remaining_samples(self) -> float:
        return max(self.total_samples - self.samples_done, 0.0)

    @property
    def min_devices(self) -> int:
        """Fewest devices any admission of this job could use — the
        engine's re-schedule gate (scheduler-agnostic lower bound).
        Cached: plans only change on the OOM replan path, which resets
        the cache."""
        need = self._min_dev
        if need == 0:
            need = min((p.n_devices for p in self.plans), default=1)
            if self.requested_n:
                need = min(need, self.requested_n)
            self._min_dev = need
        return need


@dataclass(frozen=True)
class ClusterEvent:
    """Externally supplied cluster-dynamics event (churn/spot traces).

    ``node_join`` with ``node=None`` re-adds the previously departed node of
    that id (all devices idle again); with a ``Node`` it grows the fleet.
    """
    time: float
    kind: str                               # node_join | node_leave | reschedule
    node_id: str = ""
    node: Optional[Node] = None


@dataclass(frozen=True)
class RateEvent:
    """Externally supplied ``request_rate_change`` for one serve job — the
    request-rate traces (``cluster.traces.diurnal_rate_trace`` /
    ``bursty_rate_trace``) compile to these."""
    time: float
    job_id: int
    rate: float                             # offered decode tokens/s


# --------------------------------------------------------------------------
# Admission policy plumbing (shared by the live orchestrator, serverless
# submission, the simulator, and the scheduler baselines).

ClusterState = Union[ClusterPool, Dict[str, Node]]


def nodes_map(state: ClusterState) -> Dict[str, Node]:
    return state.nodes if isinstance(state, ClusterPool) else state


def snapshot_nodes(state: ClusterState) -> Dict[str, Node]:
    """Private mutable copies, seed ``_clone_nodes`` semantics."""
    return {k: Node(v.node_id, v.device_type, v.mem, v.total, v.idle)
            for k, v in nodes_map(state).items()}


def fifo_order(queued: Union[Sequence[Job], "AdmissionQueue"]) -> List[Job]:
    """FIFO by (arrival, id) — except preempted jobs, which come first,
    least remaining work ahead (finish nearly-done work before fresh
    admissions).  Without preemptions this is exactly the seed order.

    The engine's ``AdmissionQueue`` maintains this order persistently
    (a k-way merge of sorted shard chains); plain sequences are sorted."""
    if isinstance(queued, AdmissionQueue):
        return list(queued.ordered())
    return sorted(queued, key=_fifo_key)


def _fifo_key(j: Job):
    if j.preemptions:
        return (0, j.total_samples - j.samples_done, j.job_id)
    return (1, j.arrival, j.job_id)


#: Debug flag (env ``REPRO_DEBUG_QUEUE=1``, or flip at runtime): every
#: ``AdmissionQueue.min_need`` query cross-checks the incremental
#: bookkeeping (need multiset, shard membership) against a full scan.
DEBUG_QUEUE = os.environ.get("REPRO_DEBUG_QUEUE", "") not in ("", "0")


class _AdmissionShard:
    """Queued jobs sharing one plan-list object.

    ``predict_plans_shared`` memoizes plan lists, so every job of one
    (cfg, batch, seq[, zero]) class carries the *same* tuple — the seed
    scheduler deduped no-fit checks on ``id(job.plans)``; the shard is
    that key made persistent.  Entries are ``(_fifo_key(job), job)``:
    ``pre`` holds preempted jobs, insort-sorted by least remaining work
    (requeues are rare); ``fifo`` holds fresh arrivals appended in
    arrival order.  Preempted keys lead with 0 and fresh keys with 1, so
    ``pre`` entirely precedes ``fifo`` and the shard chain
    ``chain(pre, fifo)`` is sorted — global FIFO order is a k-way merge.

    ``need_by_type`` maps each device type to the cheapest device count
    any plan of this list could use on it — the exact per-shard admission
    bound checked against ``ClusterPool.idle_by_type``.

    Colocation mode keys shards by ``(id(plans), harvest)``:
    harvest-eligible jobs (serve / LoRA finetune under ``colocate=True``)
    may start on slack bytes where whole-device jobs with the same plan
    list cannot, so the two populations must not share a no-fit verdict.
    Harvest shards add ``slice_need_by_type`` — the cheapest single-device
    slice any plan could ride per type — checked against the pool's
    free-bytes histogram as a second (necessary) eligibility bound.
    """
    __slots__ = ("sid", "pid", "plans", "need_by_type", "pre", "fifo",
                 "harvest", "slice_need_by_type")

    def __init__(self, sid: int, pid, plans: Sequence[ResourcePlan],
                 harvest: bool = False):
        self.sid = sid                      # creation order (heap tie-break)
        self.pid = pid                      # id(plans) [+ harvest] — the key
        self.plans = plans                  # pins the key's referent alive
        self.harvest = harvest
        need: Dict[str, int] = {}
        for p in plans:
            cur = need.get(p.device_type)
            if cur is None or p.n_devices < cur:
                need[p.device_type] = p.n_devices
        self.need_by_type = need
        slice_need: Dict[str, int] = {}
        if harvest:
            for p in plans:
                if p.n_devices == 1 and p.slice_bytes > 0:
                    cur = slice_need.get(p.device_type)
                    if cur is None or p.slice_bytes < cur:
                        slice_need[p.device_type] = p.slice_bytes
        self.slice_need_by_type = slice_need
        self.pre: List[Tuple[tuple, Job]] = []
        self.fifo: deque = deque()

    def __len__(self) -> int:
        return len(self.pre) + len(self.fifo)

    def head(self) -> Tuple[tuple, Job]:
        return self.pre[0] if self.pre else self.fifo[0]

    def eligible(self, idle_by_type: Dict[str, int],
                 pool: Optional[ClusterPool] = None) -> bool:
        """Necessary condition for ``select_plan(self.plans)`` to succeed:
        some device type's idle count covers its cheapest plan.  Exact as
        a skip test — a plan needs ``n_devices`` idle devices of its own
        type (memory classes only partition a type's idle count further),
        so when every type is below its cheapest plan, every plan is
        unsatisfiable and a skipped shard provably admits nothing.

        For a harvest shard (``pool`` passed by the slicing-mode pass),
        slack may also satisfy a single-device plan: the per-type
        power-of-two histogram test is a necessary condition for any slack
        fit, so the skip stays provably safe (shard-exactness
        contract, extended to the byte axis)."""
        for dt, need in self.need_by_type.items():
            if idle_by_type.get(dt, 0) >= need:
                return True
        if self.harvest and pool is not None:
            for dt, nbytes in self.slice_need_by_type.items():
                if pool.slack_may_fit(dt, nbytes):
                    return True
        return False


class AdmissionQueue:
    """Persistent admission priority structure — the engine's queue.

    Jobs bucket into per-plan-list shards (``_AdmissionShard``); within a
    shard, entries stay sorted by the exact ``_fifo_key``, maintained on
    arrive/preempt/requeue by append/insort (the ``ClusterPool`` entries
    pattern).  ``ordered()`` merges the shard chains into the exact
    global ``fifo_order`` for non-sharded schedulers; ``HASAdmission``
    walks shard *heads* through a heap and skips whole ineligible shards.

    ``min_need`` is a counter multiset over ``Job.min_devices``: the
    engine's capacity gate becomes a min over a handful of distinct
    values instead of an O(queue) rescan.  Under ``DEBUG_QUEUE`` every
    query re-derives it from a full scan and asserts equality.
    """

    def __init__(self):
        self._shards: Dict[object, _AdmissionShard] = {}  # shard key -> shard
        #: job_id -> (shard, entry key, need at insert, slice need) — keys
        #: are stable while queued (progress/preemptions only change while
        #: running)
        self._where: Dict[int, Tuple[_AdmissionShard, tuple, int,
                                     Optional[int]]] = {}
        self._need_counts: Dict[int, int] = {}          # min_devices -> n
        #: cheapest single-device slice (bytes) per queued harvest job —
        #: the slice analog of ``_need_counts``; empty unless colocating
        self._slice_need_counts: Dict[int, int] = {}
        self._next_sid = 0
        #: flipped by the engine in colocation mode: shards split on
        #: harvest eligibility and the slice-need multiset goes live
        self.colocate = False

    def __len__(self) -> int:
        return len(self._where)

    def __bool__(self) -> bool:
        return bool(self._where)

    def __contains__(self, job: Job) -> bool:
        return job.job_id in self._where

    def __iter__(self) -> Iterator[Job]:
        return self.ordered()

    def append(self, job: Job) -> None:
        assert job.job_id not in self._where, job.job_id
        key = _fifo_key(job)
        if self.colocate:
            harvest = job.kind in ("serve", "finetune")
            pid = (id(job.plans), harvest)
        else:
            harvest = False
            pid = id(job.plans)
        shard = self._shards.get(pid)
        if shard is None:
            shard = self._shards[pid] = _AdmissionShard(self._next_sid, pid,
                                                        job.plans, harvest)
            self._next_sid += 1
        if job.preemptions:
            insort(shard.pre, (key, job))
        else:
            f = shard.fifo
            if f and key < f[-1][0]:
                # out-of-order fresh arrival (live submits with an older
                # arrival stamp): sorted rebuild.  The sim path processes
                # arrivals in time order and never takes this branch.
                items = sorted(chain(f, [(key, job)]))
                f.clear()
                f.extend(items)
            else:
                f.append((key, job))
        need = job.min_devices
        slice_need = None
        if harvest:
            for p in job.plans:
                if p.n_devices == 1 and p.slice_bytes > 0 and \
                        (slice_need is None or p.slice_bytes < slice_need):
                    slice_need = p.slice_bytes
            if slice_need is not None:
                self._slice_need_counts[slice_need] = \
                    self._slice_need_counts.get(slice_need, 0) + 1
        self._where[job.job_id] = (shard, key, need, slice_need)
        self._need_counts[need] = self._need_counts.get(need, 0) + 1

    def discard(self, job: Job) -> bool:
        """Remove ``job`` if queued (idempotent).  Sharded admissions pop
        their entries themselves — this covers applying a non-sharded
        scheduler's decisions and the live ``try_admit`` bypass."""
        entry = self._where.pop(job.job_id, None)
        if entry is None:
            return False
        shard, key, need, slice_need = entry
        if key[0] == 0:                     # preempted: sorted ``pre`` list
            i = bisect_left(shard.pre, (key,))
            assert i < len(shard.pre) and shard.pre[i][1] is job, job.job_id
            shard.pre.pop(i)
        else:
            f = shard.fifo
            for i, ent in enumerate(f):
                if ent[1] is job:
                    del f[i]
                    break
            else:
                raise AssertionError(f"queue desync: job {job.job_id}")
        self._removed(shard, need, slice_need)
        return True

    def pop_head(self, shard: _AdmissionShard) -> Job:
        """Pop the shard's head entry (the sharded pass admits heads)."""
        if shard.pre:
            _, job = shard.pre.pop(0)
        else:
            _, job = shard.fifo.popleft()
        _, _, need, slice_need = self._where.pop(job.job_id)
        self._removed(shard, need, slice_need)
        return job

    def _removed(self, shard: _AdmissionShard, need: int,
                 slice_need: Optional[int] = None) -> None:
        if len(shard) == 0:
            del self._shards[shard.pid]
        c = self._need_counts[need] - 1
        if c:
            self._need_counts[need] = c
        else:
            del self._need_counts[need]
        if slice_need is not None:
            c = self._slice_need_counts[slice_need] - 1
            if c:
                self._slice_need_counts[slice_need] = c
            else:
                del self._slice_need_counts[slice_need]

    def min_need(self) -> float:
        """Min over queued jobs of ``min_devices`` (inf when empty) — the
        engine's exact re-admission gate, O(#distinct values)."""
        if DEBUG_QUEUE:
            self._debug_check()
        if not self._need_counts:
            return float("inf")
        return min(self._need_counts)

    def min_slice_need(self) -> float:
        """Min over queued harvest-eligible jobs of their cheapest
        single-device slice bytes (inf when none) — the byte analog of
        ``min_need`` for the colocation-aware admission gate: the pool's
        ``total_slack`` below this provably admits nothing via slack."""
        if not self._slice_need_counts:
            return float("inf")
        return min(self._slice_need_counts)

    def shards(self) -> Iterable[_AdmissionShard]:
        return self._shards.values()

    def ordered(self) -> Iterator[Job]:
        """Exact global ``fifo_order``: k-way merge of the sorted shard
        chains (keys are unique — they embed the job id)."""
        chains = [chain(s.pre, s.fifo) for s in self._shards.values()]
        return (job for _, job in heapq.merge(*chains))

    def _debug_check(self) -> None:
        jobs = [job for s in self._shards.values()
                for _, job in chain(s.pre, s.fifo)]
        assert len(jobs) == len(self._where), \
            (len(jobs), len(self._where))
        scan: Dict[int, int] = {}
        for j in jobs:
            scan[j.min_devices] = scan.get(j.min_devices, 0) + 1
        assert scan == self._need_counts, (scan, self._need_counts)
        sscan: Dict[int, int] = {}
        for s in self._shards.values():
            if not s.harvest:
                continue
            for _, j in chain(s.pre, s.fifo):
                sn = None
                for p in j.plans:
                    if p.n_devices == 1 and p.slice_bytes > 0 and \
                            (sn is None or p.slice_bytes < sn):
                        sn = p.slice_bytes
                if sn is not None:
                    sscan[sn] = sscan.get(sn, 0) + 1
        assert sscan == self._slice_need_counts, \
            (sscan, self._slice_need_counts)


class SortedIdSet:
    """Set of ids kept in sorted order (insort on add), so hot iteration
    sites (``_retry_serve_scale``) stop paying a per-release
    O(n log n) ``sorted(...)``.  Iteration yields a sorted snapshot —
    callers mutate while iterating."""
    __slots__ = ("_ids", "_set")

    def __init__(self):
        self._ids: List[int] = []
        self._set: set = set()

    def add(self, x: int) -> None:
        if x not in self._set:
            self._set.add(x)
            insort(self._ids, x)

    def discard(self, x: int) -> None:
        if x in self._set:
            self._set.remove(x)
            i = bisect_left(self._ids, x)
            assert self._ids[i] == x
            del self._ids[i]

    def __contains__(self, x: int) -> bool:
        return x in self._set

    def __len__(self) -> int:
        return len(self._ids)

    def __bool__(self) -> bool:
        return bool(self._ids)

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids.copy())


class SortedIdDict:
    """``{id: small int}`` with sorted-id iteration and an O(#distinct)
    ``min_value`` (a value-count multiset, like the queue's need counts) —
    the elastic scan's ``_demoted`` index, minus its per-release
    ``sorted(dict)`` and ``min(values())`` scans."""
    __slots__ = ("_map", "_ids", "_val_counts")

    def __init__(self):
        self._map: Dict[int, int] = {}
        self._ids: List[int] = []
        self._val_counts: Dict[int, int] = {}

    def __setitem__(self, k: int, v: int) -> None:
        old = self._map.get(k)
        if old is None:
            insort(self._ids, k)
        else:
            if old == v:
                return
            self._drop_val(old)
        self._map[k] = v
        self._val_counts[v] = self._val_counts.get(v, 0) + 1

    def pop(self, k: int, default=None):
        v = self._map.pop(k, None)
        if v is None:
            return default
        i = bisect_left(self._ids, k)
        assert self._ids[i] == k
        del self._ids[i]
        self._drop_val(v)
        return v

    def _drop_val(self, v: int) -> None:
        c = self._val_counts[v] - 1
        if c:
            self._val_counts[v] = c
        else:
            del self._val_counts[v]

    def min_value(self) -> int:
        return min(self._val_counts)

    def __contains__(self, k: int) -> bool:
        return k in self._map

    def __len__(self) -> int:
        return len(self._map)

    def __bool__(self) -> bool:
        return bool(self._map)

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids.copy())


class Scheduler:
    """Interface: decide placements against the shared cluster state.

    ``state`` is the engine's ``ClusterPool`` (or a ``{node_id: Node}``
    dict from legacy callers).  After ``schedule`` returns, callers must
    consult ``applied(state)``: True means the scheduler already committed
    the returned placements to the shared state; False means the caller
    applies them (a dict is never mutated — pool-aware schedulers work on a
    private snapshot in that case).
    """
    name = "base"
    applies_to_pool = False          # commits to a *shared ClusterPool* itself
    #: single-job admission on arrive is bit-identical to a full pass for
    #: this policy (see ``LifecycleEngine._fast_admit`` for the proof
    #: obligation) — only HAS-against-a-shared-pool sets it
    admits_single = False
    #: the policy understands memory-slice (``Grant``) placements on a
    #: slicing-enabled pool — required for ``colocate=True`` engines.
    #: Snapshot-based policies copy whole-device idle counts only, so
    #: they must not drive a sliced pool (byte budgets would be dropped).
    supports_slicing = False

    def schedule(self, queued: List[Job], state: ClusterState
                 ) -> List[Tuple[Job, Tuple[Tuple[str, int], ...], int, int]]:
        """Return [(job, placements, d, t)] to start now."""
        raise NotImplementedError

    def applied(self, state) -> bool:
        """Whether ``schedule`` already committed its placements to
        ``state`` — only ever True for a shared ``ClusterPool``."""
        return self.applies_to_pool and isinstance(state, ClusterPool)


class HASAdmission(Scheduler):
    """The one admission policy: MARP's ranked plans + HAS best-fit
    placement, ``fifo_order``.  ``FrenzyScheduler`` is this class under its
    paper name; the orchestrator's restart-on-release runs it too.

    Runs directly against the indexed ``ClusterPool``: plan retrieval is a
    per-plan counter lookup and placement touches only the entries it
    selects, so a pass is O(queue x plans) instead of O(queue x plans x
    nodes).  Placements are committed to a shared pool as jobs are admitted
    (``applies_to_pool``) — a rejected job mutates nothing, so there is no
    rollback path.
    """
    name = "has"
    applies_to_pool = True
    admits_single = True
    supports_slicing = True

    def schedule(self, queued, state):
        if isinstance(state, ClusterPool):
            pool = state
        else:
            pool = ClusterPool(snapshot_nodes(state).values())
        if isinstance(queued, AdmissionQueue) and pool is state:
            return self._schedule_sharded(queued, pool)
        select_plan = pool.select_plan
        find_placements = pool.find_placements
        slicing = pool.slicing
        out = []
        # Identical plan lists are shared objects (predict_plans_shared), and
        # within one pass capacity only shrinks (admissions take, nothing
        # frees) — so a plan list that found no feasible plan stays
        # infeasible for the rest of the pass.  Dedupe those no-fit walks by
        # object identity (slicing splits the verdict on harvest
        # eligibility: slack can admit what whole devices cannot).
        no_fit = set()
        for job in fifo_order(queued):
            if slicing:
                harvest = job.kind in ("serve", "finetune")
                plans_key = (id(job.plans), harvest)
                if plans_key in no_fit:
                    continue                # backfill: later jobs may fit
                plan = select_plan(job.plans, harvest=harvest)
            else:
                plans_key = id(job.plans)
                if plans_key in no_fit:
                    continue                # backfill: later jobs may fit
                plan = select_plan(job.plans)
            if plan is None:
                no_fit.add(plans_key)
                continue
            if slicing:
                placements = find_placements(plan, harvest=harvest)
                if placements is not None:
                    placements = _wrap_grants(pool, plan, placements)
            else:
                placements = find_placements(plan)
            if placements is None:
                continue
            pool.apply(placements)
            _record_plan(job, plan, placements)
            out.append((job, placements, plan.d, plan.t))
        return out

    def _schedule_sharded(self, queue: AdmissionQueue, pool: ClusterPool
                          ) -> List[Tuple[Job, Tuple[Tuple[str, int], ...],
                                          int, int]]:
        """Sharded admission pass — bit-identical decisions to the list
        scan above (golden-tested), without touching jobs that provably
        cannot start:

        * shard heads are walked in exact global ``fifo_order`` through a
          heap, so the next job considered is always the one the list
          scan would consider next among live shards;
        * a shard whose ``eligible`` bound fails is skipped outright —
          the bound is a necessary condition for ``select_plan``, and
          within a pass capacity only shrinks, so an ineligible shard
          stays infeasible for the rest of the pass (exactly when the
          list scan would have marked it ``no_fit``);
        * a shard whose ``select_plan`` fails is dropped for the rest of
          the pass — the seed's ``no_fit`` dedupe, one level up.

        Admitted jobs are popped from the queue here; the engine's
        post-decision removal is an idempotent ``discard``.
        """
        idle_by_type = pool.idle_by_type
        select_plan = pool.select_plan
        find_placements = pool.find_placements
        # slicing mode: eligibility also consults the pool's free-bytes
        # histogram (harvest shards), selection/placement go through the
        # harvest paths, and committed placements carry byte budgets
        spool = pool if pool.slicing else None
        heap = []
        for shard in queue.shards():
            if shard.eligible(idle_by_type, spool):
                heap.append((shard.head()[0], shard.sid, shard))
        heapq.heapify(heap)
        out = []
        while heap:
            _, _, shard = heapq.heappop(heap)
            if not shard.eligible(idle_by_type, spool):
                continue                    # shrank below its cheapest plan
            if spool is None:
                plan = select_plan(shard.plans)
            else:
                plan = select_plan(shard.plans, harvest=shard.harvest)
            if plan is None:
                continue                    # no-fit: drop shard this pass
            if spool is None:
                placements = find_placements(plan)
            else:
                placements = find_placements(plan, harvest=shard.harvest)
                if placements is not None:
                    placements = _wrap_grants(pool, plan, placements)
            if placements is None:          # unreachable on a consistent
                continue                    # pool (select_plan just held)
            job = queue.pop_head(shard)
            pool.apply(placements)
            _record_plan(job, plan, placements)
            out.append((job, placements, plan.d, plan.t))
            if len(shard):
                heapq.heappush(heap, (shard.head()[0], shard.sid, shard))
        return out


def _wrap_grants(pool: ClusterPool, plan: ResourcePlan,
                 placements) -> tuple:
    """Colocation mode: every committed placement carries a byte budget.
    Whole-device ``(node_id, k)`` pairs become *exclusive* grants sized by
    the plan's memtrace-corrected slice (so ``mem - slice_bytes`` is
    harvestable slack); slice grants from the harvest placement path pass
    through.  Plans without a byte budget (hand-built, ``slice_bytes=0``)
    reserve the full device — opaque to harvesting, never oversubscribed."""
    nodes = pool.nodes
    return tuple(
        p if isinstance(p, Grant) else
        Grant(p[0], p[1],
              min(plan.slice_bytes, nodes[p[0]].mem) if plan.slice_bytes > 0
              else nodes[p[0]].mem)
        for p in placements)


def _record_plan(job: Job, plan: ResourcePlan,
                 placements: Tuple[Tuple[str, int], ...],
                 allocation: Optional[Allocation] = None) -> None:
    """Remember which ranked plan a job runs under (the elastic scan
    migrates jobs running below their top-ranked plan)."""
    job.plan = plan
    try:
        job.plan_rank = job.plans.index(plan)
    except ValueError:                      # plan not from job.plans
        job.plan_rank = 0
    job.allocation = allocation if allocation is not None else \
        Allocation(plan=plan, placements=tuple(placements))


# --------------------------------------------------------------------------


#: sim rate model: (job, placements, d, t) -> samples/s
RateFn = Callable[[Job, Tuple[Tuple[str, int], ...], int, int], float]

#: sim OOM model: (job, placements, pool) -> observed peak bytes if this
#: placement will exceed device memory, else None.  Consulted once per
#: (re)start; ``cluster.traces.misprediction_oracle`` builds one from a
#: deterministic per-job-class true-peak multiplier.
OomCheckFn = Callable[[Job, Tuple[Tuple[str, int], ...], ClusterPool],
                      Optional[float]]

#: post-OOM replanning: job -> fresh MARP plan ranking (computed against
#: the updated memtrace corrector, so the OOMed class is excluded)
ReplanFn = Callable[[Job], Sequence[ResourcePlan]]

#: virtual seconds from (re)start to OOM detection in the sim — memory
#: peaks within the first steps, so the crash lands early in the run
DEFAULT_OOM_DETECT_SECONDS = 30.0


class LifecycleEngine:
    """One event loop, one admission/restart policy, for both paths.

    * **Live path** (``Orchestrator`` / ``serverless.submit``): no rate
      model; ``submit_job`` / ``complete_job`` / ``node_join`` /
      ``node_leave`` are called as the world changes, and the engine keeps
      the pool + queue + job states consistent.
    * **Sim path** (``cluster.simulator.simulate``): a ``rate_fn`` prices
      placements, ``run()`` drives the virtual clock from arrival and
      cluster-event traces, and finish events are self-scheduled.

    Invariants (extending ROADMAP "Control-plane architecture"):
    the engine never mutates idle counts except through the pool; admission
    re-runs on capacity growth only when ``pool.total_idle >= min(queued
    min_devices)`` (exact lower bound — skipped runs cannot change
    decisions); all elastic/churn machinery is dormant when ``elastic`` is
    False and no node events occur.
    """

    def __init__(self, nodes: Iterable[Node], scheduler: Scheduler = None, *,
                 rate_fn: Optional[RateFn] = None,
                 charge_overhead: bool = False,
                 elastic: bool = False,
                 migration_bandwidth: float = DEFAULT_MIGRATION_BANDWIDTH,
                 oom_check_fn: Optional[OomCheckFn] = None,
                 replan_fn: Optional[ReplanFn] = None,
                 oom_detect_seconds: float = DEFAULT_OOM_DETECT_SECONDS,
                 max_oom_retries: int = 8,
                 scale_up_delay: float = DEFAULT_SCALE_UP_DELAY,
                 ckpt_policy: Optional[str] = None,
                 ckpt_fixed_interval_s: float = 0.0,
                 restart_backoff_s: float = 0.0,
                 max_restarts: Optional[int] = None,
                 retain_jobs: bool = True,
                 on_complete: Optional[Callable[[Job], None]] = None,
                 reset: bool = False,
                 colocate: bool = False):
        self.pool = ClusterPool(nodes, reset=reset)
        self.scheduler = scheduler if scheduler is not None else HASAdmission()
        self._applies = self.scheduler.applied(self.pool)
        # arrive fast path: single-job admission against the shared pool,
        # exact only for schedulers that declare it (HASAdmission)
        self._admit_single = self._applies and self.scheduler.admits_single
        # fractional-GPU packing (opt-in): serve replicas and LoRA
        # finetune jobs may harvest the slack bytes of running train jobs.
        # Requires a slicing-aware policy driving the shared pool —
        # snapshot schedulers copy whole-device counts only and would drop
        # byte budgets on the floor.
        self.colocate = colocate
        if colocate:
            assert self.scheduler.supports_slicing and self._applies, \
                ("colocate=True requires a slicing-aware pool scheduler "
                 f"(HASAdmission), got {self.scheduler.name}")
            self.pool.enable_slicing()
        self.rate_fn = rate_fn
        self.charge_overhead = charge_overhead
        self.elastic = elastic
        self.migration_bandwidth = migration_bandwidth
        self.oom_check_fn = oom_check_fn
        self.replan_fn = replan_fn
        self.oom_detect_seconds = oom_detect_seconds
        self.max_oom_retries = max_oom_retries
        self.scale_up_delay = scale_up_delay
        # failure plane: periodic-checkpoint policy + restart budget.
        # ``ckpt_policy``: None (no periodic checkpoints — crashes roll back
        # to the last graceful event), "young_daly" (per-placement optimal
        # interval), or "fixed" (``ckpt_fixed_interval_s`` for every job).
        # ``max_restarts`` is the combined budget across OOM + crash causes
        # and defaults to ``max_oom_retries`` so OOM-only runs are
        # unchanged.  ``restart_backoff_s`` (0 = restart hot) is the base
        # of the deterministic exponential backoff crashed jobs wait out.
        assert ckpt_policy in (None, "young_daly", "fixed"), ckpt_policy
        self.ckpt_policy = ckpt_policy
        self.ckpt_fixed_interval_s = ckpt_fixed_interval_s
        self.restart_backoff_s = restart_backoff_s
        self.max_restarts = max_oom_retries if max_restarts is None \
            else max_restarts
        #: streaming-scale knobs: with ``retain_jobs=False`` a job leaving
        #: the system (done/failed) is dropped from ``self.jobs`` after
        #: ``on_complete`` sees it, so a 1M-job run holds only live jobs
        self.retain_jobs = retain_jobs
        self.on_complete = on_complete
        self.peak_live_jobs = 0             # max concurrent tracked jobs
        self.jobs: Dict[int, Job] = {}
        self.queued: AdmissionQueue = AdmissionQueue()
        self.queued.colocate = colocate
        self._events: List[tuple] = []      # (time, seq, kind, payload, epoch)
        self._seq = 0
        self._offline: Dict[str, Node] = {}   # departed nodes, by id
        # node -> {running job id -> number of placement entries on that
        # node}.  Refcounted so serve replica churn can (un)register only
        # the replicas that changed, and so ``node_leave``/``node_fail``
        # collect victims in O(victims) instead of scanning running jobs.
        self._node_jobs: Dict[str, Dict[int, int]] = {}
        # jobs running below their top-ranked plan: id -> fewest devices any
        # better-ranked plan needs (the elastic scan's capacity gate)
        self._demoted = SortedIdDict()
        self._mig_cost: Dict[object, float] = {}
        self._save_cost: Dict[object, float] = {}   # one durable save, by cfg
        # counters
        self.sched_time_s = 0.0
        self.sched_calls = 0
        #: ``sched_time_s`` split by triggering event kind (arrive /
        #: finish / churn / scale / oom / migrate / reschedule)
        self.sched_time_by_kind: Dict[str, float] = {}
        self.preemption_count = 0
        self.migration_count = 0
        self.scale_up_count = 0             # serve replicas added
        self.scale_down_count = 0           # serve replicas released
        # serve jobs running below their SLO replica target (capacity was
        # tight at scale time); retried whenever capacity frees
        self._serve_backlog = SortedIdSet()
        self.oom_count = 0
        self.oom_failures = 0               # jobs abandoned after retries
        #: per-OOM telemetry: (time, job_id, device_type, pred, observed).
        #: Ring-bounded so a streamed 1M-job pathological run can't
        #: grow it without limit; evictions are counted in ``.dropped``
        #: and surfaced as ``SimResult.oom_log_dropped``, never silent.
        self.oom_log: RingLog = RingLog(DEFAULT_LOG_CAPACITY)
        # failure-plane telemetry (pure accumulation — never consulted by
        # any decision, per the telemetry-is-free invariant)
        self.node_fail_count = 0            # abrupt node crash-faults
        self.crash_count = 0                # job crashes (victims of faults)
        self.crash_failures = 0             # jobs abandoned over the budget
        self.replica_fail_count = 0         # serve replicas lost to faults
        self.lost_work_s = 0.0              # compute rolled back by crashes
        self.ckpt_overhead_s = 0.0          # run time spent saving state
        self.useful_work_s = 0.0            # durable non-serve compute
        #: per-victim crash log: (time, node_id, job_id, lost_work_s) —
        #: ring-bounded like ``oom_log`` (drops reported, not silent)
        self.failure_log: RingLog = RingLog(DEFAULT_LOG_CAPACITY)
        self.makespan = 0.0
        # observability plane: event countdown to the next metrics sample
        # (``METRICS.sample_stride`` amortizes the sampling cost; primed
        # here, so sim-path sampling starts with engines constructed
        # while metrics are enabled) and the admission-wait buffer
        # flushed into the histogram at each sample; a new engine is a
        # new run — job ids restart, so open tracer segments from a
        # previous run must not bleed into this one
        self._obs_tick = METRICS.sample_stride if METRICS.enabled else 0
        self._admit_waits: List[float] = []
        if TRACER.enabled:
            TRACER.new_run()

    # ------------------------------------------------------------ live API
    def submit_job(self, job: Job, now: float = 0.0) -> Job:
        """Live ``arrive``: register + admit.  Single-job admission only:
        capacity cannot have grown since the last pass, so no already-queued
        job can newly fit — a full-queue pass would make identical decisions
        (golden-tested) at O(queue) cost per submit."""
        self.jobs.setdefault(job.job_id, job)
        self.peak_live_jobs = max(self.peak_live_jobs, len(self.jobs))
        if job.kind == "serve" and job.serve_accounted < 0:
            job.serve_accounted = now       # queue wait counts against SLO
        if TRACER.enabled:
            TRACER.job_state(job.job_id, "queued", now)
        if not self.try_admit(job, now):
            self.queued.append(job)
        if METRICS.enabled:
            self._obs_event(now)            # live path: no _dispatch tick
        return job

    def try_admit(self, job: Job, now: float = 0.0) -> bool:
        """Single-job admission (the orchestrator's ``try_start``): HAS over
        this job's plans only, ignoring the rest of the queue."""
        if job.state != "queued":
            return False
        if self.colocate:
            harvest = job.kind in ("serve", "finetune")
            alloc = self.pool.schedule(job.plans, harvest=harvest)
        else:
            alloc = self.pool.schedule(job.plans)
        if alloc is None:
            return False
        if self.colocate:
            placements = _wrap_grants(self.pool, alloc.plan, alloc.placements)
            self.pool.apply(placements)
            _record_plan(job, alloc.plan, placements)
        else:
            placements = alloc.placements
            self.pool.apply(placements)
            _record_plan(job, alloc.plan, placements, allocation=alloc)
        self.queued.discard(job)
        self._start(job, placements, alloc.plan.d, alloc.plan.t, now)
        return True

    def _gate_open(self) -> bool:
        """Exact re-admission gate: only re-run the scheduler when the
        pool could fit some queued job's cheapest plan — a skipped run
        provably admits nothing (ROADMAP invariant).  Colocation
        adds the byte axis: slack covering some queued harvest job's
        cheapest slice also opens the gate (necessary condition — a
        single device's free bytes never exceed the pool total)."""
        if not self.queued:
            return False
        if self.pool.total_idle >= self.queued.min_need():
            return True
        return self.colocate and \
            self.pool.total_slack >= self.queued.min_slice_need()

    def complete_job(self, job_id: int, now: float = 0.0) -> None:
        """Live ``finish``: release capacity, restart queued jobs (the one
        restart policy — the scheduler, FIFO with backfill)."""
        job = self.jobs[job_id]
        if job.state != "running":
            return
        self._finish(job, now)
        if self._gate_open():
            self._run_scheduler(now, "finish")
        self._maybe_migrate(now)
        self._retry_serve_scale(now)
        if METRICS.enabled:
            self._obs_event(now)            # live path: no _dispatch tick

    def node_join(self, node: Optional[Node] = None, node_id: str = "",
                  now: float = 0.0) -> Optional[Node]:
        """``node_join``: grow the pool (or re-add a departed node, all
        devices idle), then re-admit / migrate."""
        if node is None:
            node = self._offline.pop(node_id, None)
            if node is None:
                return None                 # unknown id: ignore
            node.idle = node.total
        else:
            self._offline.pop(node.node_id, None)
        if node.node_id in self.pool.nodes:
            return self.pool.nodes[node.node_id]
        self.pool.add_node(node)
        if TRACER.enabled:
            TRACER.instant("node_join", now, node.node_id)
        if self._gate_open():
            self._run_scheduler(now, "churn")
        self._maybe_migrate(now)
        self._retry_serve_scale(now)
        return node

    def node_leave(self, node_id: str, now: float = 0.0) -> List[Job]:
        """``node_leave``: checkpoint-preempt every job touching the node,
        requeue them with remaining work, drop the node from the pool."""
        if node_id not in self.pool.nodes:
            return []                       # already gone: ignore
        if TRACER.enabled:
            TRACER.instant("node_leave", now, node_id)
        victims = sorted((self.jobs[jid]
                          for jid in self._node_jobs.get(node_id, ())),
                         key=lambda j: j.job_id)
        for job in victims:
            self._preempt(job, now)
        self._offline[node_id] = self.pool.remove_node(node_id)
        self._node_jobs.pop(node_id, None)  # drained by the preempts above
        if self._gate_open():
            self._run_scheduler(now, "churn")
        self._maybe_migrate(now)
        return victims

    def node_fail(self, node_id: str, now: float = 0.0) -> List[Job]:
        """``node_fail``: the node crash-faults.  Unlike ``node_leave``
        there is no checkpoint-on-the-way-out: every train/finetune job
        touching the node rolls back to its last *durable* checkpoint
        (``_crash``), serve jobs lose exactly the replicas placed on the
        node and stay up degraded when any replica survives.  Returns the
        fully-crashed victims (sorted by id)."""
        if node_id not in self.pool.nodes:
            return []                       # already gone: ignore
        self.node_fail_count += 1
        if TRACER.enabled:
            TRACER.instant("node_fail", now, node_id)
        victims: List[Job] = []
        for jid in sorted(self._node_jobs.get(node_id, {})):
            job = self.jobs[jid]
            if job.kind == "serve" \
                    and self._fail_serve_replicas(job, node_id, now):
                self.failure_log.append((now, node_id, jid, 0.0))
                if TRACER.enabled:
                    TRACER.instant("replica_fail", now, jid)
                continue                    # partial loss: job survives
            lost = self._crash(job, now)
            self.failure_log.append((now, node_id, jid, lost))
            if TRACER.enabled:
                TRACER.instant("crash", now, jid)
                TRACER.job_state(jid, job.state, now)
            victims.append(job)
        self._offline[node_id] = self.pool.remove_node(node_id)
        self._node_jobs.pop(node_id, None)  # drained by the crashes above
        if self._gate_open():
            self._run_scheduler(now, "fail")
        self._maybe_migrate(now)
        return victims

    def reschedule(self, now: float = 0.0) -> None:
        """Explicit ``reschedule``: re-run admission + the elastic scan."""
        if self.queued:
            self._run_scheduler(now, "reschedule")
        self._maybe_migrate(now)

    def oom_job(self, job_id: int, observed_bytes: float,
                now: float = 0.0) -> Optional[Job]:
        """Live ``oom``: a runner watched the job die on an out-of-memory.
        Feeds the observed peak into the memory feedback plane, requeues
        the job with its accrued progress, and re-runs admission (the
        corrected prediction excludes the placement that just died)."""
        job = self.jobs.get(job_id)
        if job is None or job.state != "running":
            return None
        self._oom(job, float(observed_bytes), now)
        return job

    def set_request_rate(self, job_id: int, rate: float,
                         now: float = 0.0) -> Optional[Job]:
        """``request_rate_change``: the offered rate of a serve job moved.
        Closes the current SLO-accounting segment, then lets the
        autoscaler react — synchronously on the live path, via typed
        ``scale_up``/``scale_down`` events on the sim path."""
        job = self.jobs.get(job_id)
        if job is None or job.kind != "serve" \
                or job.state in ("done", "failed"):
            return None
        self._account_serve(job, now)
        job.request_rate = float(rate)
        if job.state == "running":
            if self.rate_fn is None:
                self._scale_to(job, self._serve_target(job), now)
            else:
                self._schedule_scale(job, now)
        return job

    # ------------------------------------------------------------- sim API
    def run(self, jobs: Union[Sequence[Job], Iterable[Job]],
            cluster_events: Union[Sequence[ClusterEvent],
                                  Iterable[ClusterEvent]] = (),
            rate_events: Union[Sequence[RateEvent],
                               Iterable[RateEvent]] = ()) -> None:
        """Event loop over job arrivals + cluster dynamics + request-rate
        traces (sim path).  Requires ``rate_fn``.

        **Sequence inputs** reproduce the seed path exactly: everything is
        pre-pushed into one heap keyed by (time, seq) — arrivals carry
        their job id, trace events and self-scheduled finishes draw from
        one monotonic counter, so with no cluster/rate events this is
        bit-identical to the seed loop's ordering.

        **Iterator inputs stream**: each source is pulled lazily (it must
        yield in nondecreasing time order — asserted), so a 1M-job trace
        never materializes.  Tie order at equal times matches the
        pre-pushed seq numbering exactly: arrivals < cluster events <
        rate events < heap-resident runtime events (runtime seqs are
        allocated after every trace seq on the sequence path).
        """
        assert self.rate_fn is not None, "sim run() needs a rate_fn"
        events = self._events
        if isinstance(jobs, _SequenceABC) \
                and isinstance(cluster_events, _SequenceABC) \
                and isinstance(rate_events, _SequenceABC):
            streams: List[list] = []
            for j in jobs:
                self.jobs[j.job_id] = j
                heapq.heappush(events, (j.arrival, j.job_id, ARRIVE, j, 0))
            self.peak_live_jobs = max(self.peak_live_jobs, len(self.jobs))
            seq = len(jobs)
            for ev in sorted(cluster_events,
                             key=lambda e: (e.time, e.kind, e.node_id)):
                heapq.heappush(events, (ev.time, seq, ev.kind, ev, 0))
                seq += 1
            for rev in sorted(rate_events, key=lambda e: (e.time, e.job_id)):
                heapq.heappush(events, (rev.time, seq, RATE_CHANGE, rev, 0))
                seq += 1
            self._seq = seq
        else:
            streams = self._make_streams(jobs, cluster_events, rate_events)
        while True:
            # earliest stream head, respecting source priority on time ties
            # (streams are listed arrival < cluster < rate; strict ``<``
            # keeps the earlier-priority head on ties)
            src = None
            for s in streams:
                if s[0] is not None and (src is None or s[0][0] < src[0][0]):
                    src = s
            if src is not None and (not events or src[0][0] <= events[0][0]):
                t, kind, payload = src[0]
                self._pull(src)
                self._dispatch(t, kind, payload, 0)
                continue
            if not events:
                break
            now, _, kind, payload, epoch = heapq.heappop(events)
            self._dispatch(now, kind, payload, epoch)
        if METRICS.enabled:
            self._obs_sample(self.makespan)  # close the series at the end

    def _make_streams(self, jobs, cluster_events, rate_events) -> List[list]:
        """Lazy event sources: ``[head, iterator, to_event, last_time]``
        per source, priority-ordered.  Sequence-typed cluster/rate inputs
        are sorted exactly as the pre-push path sorts them; iterator
        inputs are trusted to be time-ordered (asserted in ``_pull``)."""
        if isinstance(cluster_events, _SequenceABC):
            cluster_events = sorted(cluster_events,
                                    key=lambda e: (e.time, e.kind, e.node_id))
        if isinstance(rate_events, _SequenceABC):
            rate_events = sorted(rate_events, key=lambda e: (e.time, e.job_id))
        specs = [
            (iter(jobs), lambda j: (j.arrival, ARRIVE, j)),
            (iter(cluster_events), lambda e: (e.time, e.kind, e)),
            (iter(rate_events), lambda e: (e.time, RATE_CHANGE, e)),
        ]
        streams = []
        for it, conv in specs:
            s = [None, it, conv, float("-inf")]
            self._pull(s)
            streams.append(s)
        return streams

    @staticmethod
    def _pull(s: list) -> None:
        item = next(s[1], None)
        if item is None:
            s[0] = None
            return
        ev = s[2](item)
        assert ev[0] >= s[3], \
            f"streamed events must be time-ordered ({ev[0]} < {s[3]})"
        s[3] = ev[0]
        s[0] = ev

    def _dispatch(self, now: float, kind: str, payload, epoch: int) -> None:
        # inline stride tick (hot path): a countdown primed at engine
        # construction — 0 forever when metrics were off then, one
        # compare-and-decrement per event when on (``_obs_sample``
        # re-arms it, re-reading ``METRICS.enabled`` so a mid-run
        # ``disable()`` stops sampling after at most one stride)
        t = self._obs_tick
        if t > 0:
            if t == 1:
                self._obs_sample(now)
            else:
                self._obs_tick = t - 1
        if kind == ARRIVE:
            self.makespan = max(self.makespan, now)
            self._on_arrive(now, payload)
        elif kind == FINISH:
            job = payload
            if epoch != job.epoch or job.state != "running":
                return                      # stale: job migrated/preempted
            self.makespan = max(self.makespan, now)
            self._finish(job, now)
            if self._gate_open():
                self._run_scheduler(now, "finish")
            self._maybe_migrate(now)
        elif kind == OOM:
            job, observed = payload
            if epoch != job.epoch or job.state != "running":
                return                      # stale: job migrated/preempted
            self.makespan = max(self.makespan, now)
            self._oom(job, observed, now)
        elif kind == RATE_CHANGE:
            self.set_request_rate(payload.job_id, payload.rate, now)
        elif kind == SCALE_UP:
            job = payload
            if epoch != job.epoch or job.state != "running":
                return                      # stale: job migrated/preempted
            self._account_serve(job, now)
            target = self._serve_target(job)
            if target > job.serve_replicas \
                    or self._prefill_target(job) > job.prefill_replicas:
                self._scale_to(job, target, now)
        elif kind == SCALE_DOWN:
            job = payload
            if epoch != job.epoch or job.state != "running":
                return
            self._account_serve(job, now)
            target = self._serve_target(job)
            if target < job.serve_replicas \
                    or self._prefill_target(job) < job.prefill_replicas:
                self._scale_to(job, target, now)
        elif kind == NODE_JOIN:
            self.node_join(payload.node, payload.node_id, now)
        elif kind == NODE_LEAVE:
            self.node_leave(payload.node_id, now)
        elif kind == NODE_FAIL:
            self.node_fail(payload.node_id, now)
        elif kind == RESTART:
            job = payload
            if epoch != job.epoch or job.state != "backoff":
                return                      # stale: job moved on already
            self.makespan = max(self.makespan, now)
            job.state = "queued"
            self.queued.append(job)
            if TRACER.enabled:              # backoff expired: requeued
                TRACER.job_state(job.job_id, "queued", now)
            if self._gate_open():
                self._run_scheduler(now, "restart")
        elif kind == RESCHEDULE:
            self.reschedule(now)
        else:
            raise ValueError(f"unknown event kind {kind!r}")

    # ------------------------------------------------------ event handlers
    def _on_arrive(self, now: float, job: Job) -> None:
        self.jobs.setdefault(job.job_id, job)
        self.peak_live_jobs = max(self.peak_live_jobs, len(self.jobs))
        if job.kind == "serve" and job.serve_accounted < 0:
            job.serve_accounted = now       # queue wait counts against SLO
        # (no tracer emit here: the arrival's implicit ``queued`` segment
        # starts at ``job.arrival`` and is synthesized by
        # ``TRACER.admitted`` at first start — one emit instead of two on
        # the hottest path; jobs still queued at run end have no span)
        self.queued.append(job)
        # Exact admission gate, extended to arrivals: when even the
        # cheapest queued plan (including this job's) cannot fit the idle
        # pool, a full pass provably admits nothing — the O(1) gate check
        # *is* the admission decision, counted as one scheduler call so
        # ``sched_calls`` stays one-per-arrival like the ungated path.
        # (Colocation widens the gate with the slack-bytes bound; the
        # extra check is short-circuited off the golden path.)
        if self.pool.total_idle < self.queued.min_need() and not (
                self.colocate
                and self.pool.total_slack >= self.queued.min_slice_need()):
            self.sched_calls += 1
            if TRACER.enabled:              # the gate *is* the pass
                tr = TRACER
                b = tr.sched                # inline emit: flat-ring record
                b.append("arrive"); b.append(now)
                b.append(0.0); b.append(0)
                if len(b) > tr.sched_trim:
                    tr.trim()
            return
        if self._admit_single:
            self._fast_admit(now, job)
        else:
            self._run_scheduler(now, "arrive")

    def _fast_admit(self, now: float, job: Job) -> None:
        """Arrive fast path (``admits_single`` schedulers): admission
        considers only the arriving job, O(plans) instead of O(queue).

        Exact for HAS against the shared pool: every capacity-growing
        event ends with a gated full pass, a completed pass leaves every
        still-queued job unsatisfiable (each shard failed ``select_plan``
        at a capacity no smaller than the post-pass one), and between
        passes capacity never grows without triggering another — so at
        arrival time no *previously* queued job can be admissible, and a
        full pass could start only this job, with exactly this placement
        (the live ``submit_job`` contract, golden-tested on the sim
        path)."""
        t0 = time.perf_counter()
        if self.colocate:
            harvest = job.kind in ("serve", "finetune")
            alloc = self.pool.schedule(job.plans, harvest=harvest)
            if alloc is not None:
                placements = _wrap_grants(self.pool, alloc.plan,
                                          alloc.placements)
                self.pool.apply(placements)
                _record_plan(job, alloc.plan, placements)
                self.queued.discard(job)
        else:
            alloc = self.pool.schedule(job.plans)
            if alloc is not None:
                placements = alloc.placements
                self.pool.apply(placements)
                _record_plan(job, alloc.plan, placements, allocation=alloc)
                self.queued.discard(job)
        elapsed = time.perf_counter() - t0
        self.sched_time_s += elapsed
        self.sched_time_by_kind["arrive"] = \
            self.sched_time_by_kind.get("arrive", 0.0) + elapsed
        self.sched_calls += 1
        if alloc is None:
            if TRACER.enabled:
                # reuses the measurement above — emitted *outside* the
                # timed window, so ``charge_overhead`` virtual timestamps
                # are identical with tracing on or off
                tr = TRACER
                b = tr.sched
                b.append("arrive"); b.append(now)
                b.append(elapsed); b.append(0)
                if len(b) > tr.sched_trim:
                    tr.trim()
            return
        start = now + (elapsed if self.charge_overhead else 0.0)
        # a successful fast-admit pass and its admission are one-to-one:
        # the pass rides the job's ``adm`` trace record (``pass_wall``)
        # instead of a second ring emit on the hottest path
        self._start(job, placements, alloc.plan.d, alloc.plan.t,
                    start, pass_wall=elapsed)

    def _run_scheduler(self, now: float, trigger: str = "other") -> None:
        t0 = time.perf_counter()
        decisions = self.scheduler.schedule(self.queued, self.pool)
        elapsed = time.perf_counter() - t0
        self.sched_time_s += elapsed
        self.sched_time_by_kind[trigger] = \
            self.sched_time_by_kind.get(trigger, 0.0) + elapsed
        self.sched_calls += 1
        if TRACER.enabled:                  # outside the timed window
            tr = TRACER
            b = tr.sched
            b.append(trigger); b.append(now)
            b.append(elapsed); b.append(len(decisions))
            if len(b) > tr.sched_trim:
                tr.trim()
        if not decisions:
            return
        start = now + (elapsed if self.charge_overhead else 0.0)
        for job, placements, d, t in decisions:
            if not self._applies:
                self.pool.apply(placements)  # Node.take asserts capacity
            # sharded HAS admissions already popped their queue entries;
            # discard covers every other scheduler (idempotent)
            self.queued.discard(job)
            self._start(job, placements, d, t, start)

    def _start(self, job: Job, placements, d: int, t: int,
               start: float, pass_wall: float = None) -> None:
        job.placements = tuple(placements)
        job.state = "running"
        if job.start_time < 0:
            job.start_time = start
            if METRICS.enabled:             # first admission: queue wait,
                self._admit_waits.append(start - job.arrival)
                # flushed into the histogram at the next ``_obs_sample``
        if TRACER.enabled:                  # inline ``TRACER.admitted()``
            tr = TRACER                     # — one 4-slot record implies
            b = tr.adm                      # the queued span, the running
            b.append(job.job_id)            # open, and (fused fast-admit)
            b.append(job.arrival)           # the scheduler pass; spans
            b.append(start)                 # are synthesized cold, in
            b.append(pass_wall)             # ``Tracer.events``
            if len(b) > tr.adm_trim:
                tr.trim()
        self._register(job)
        if self.rate_fn is not None:
            raw = self.rate_fn(job, job.placements, d, t)
            # checkpoint policy (no-op raw rate when off): progress stalls
            # for one save per interval, so the *effective* rate prices it
            job.rate, job._ckpt_tau, job.ckpt_cost_s = \
                self._effective_rate(job, raw, job.placements)
            # preempted jobs resume from their checkpoint: restore cost first
            resume = start + (self._migration_seconds(job)
                              if job.preemptions else 0.0)
            job.progress_time = resume
            observed = (self.oom_check_fn(job, job.placements, self.pool)
                        if self.oom_check_fn is not None else None)
            if observed is not None:
                # doomed placement: memory peaks within the first steps, so
                # the job dies shortly after (re)start instead of finishing
                job.finish_time = -1.0
                t_oom = resume + self.oom_detect_seconds
                self._seq += 1
                heapq.heappush(self._events,
                               (t_oom, self._seq, OOM, (job, float(observed)),
                                job.epoch))
            else:
                finish = resume \
                    + (job.total_samples - job.samples_done) / job.rate
                job.finish_time = finish
                self._seq += 1
                heapq.heappush(self._events,
                               (finish, self._seq, FINISH, job, job.epoch))
        if job.kind == "serve":
            self._serve_started(job, start)
        self._track_demotion(job)

    def _finish(self, job: Job, now: float) -> None:
        if job.rate > 0.0 and now > job.progress_time:
            self._charge_work(job, now - job.progress_time)
            job.progress_time = now
        self._serve_teardown(job, now)
        self.pool.release(job.placements)
        self._unregister(job)
        job.state = "done"
        job.finish_time = now
        job.samples_done = float(job.total_samples)
        if TRACER.enabled:                  # inline ``TRACER.finished()``
            tr = TRACER                     # — the closing span IS the
            b = tr.fin                      # "done" marker (no instant)
            b.append(job.job_id); b.append(now)
            if len(b) > tr.fin_trim:
                tr.trim()
        self._demoted.pop(job.job_id, None)
        self._completed(job)

    def _completed(self, job: Job) -> None:
        """Terminal transition (done/failed): hand the job to the caller's
        accumulator and, in streaming mode (``retain_jobs=False``), drop
        it from the live map so a 1M-job sim holds only live jobs."""
        if self.on_complete is not None:
            self.on_complete(job)
        if not self.retain_jobs:
            self.jobs.pop(job.job_id, None)

    def _oom(self, job: Job, observed: float, now: float) -> None:
        """``oom`` event: kill, feed back, requeue (or fail after retries).

        The observed peak is recorded against the *raw* plan prediction
        only while the feedback plane is enabled — the static-margin
        baseline must stay memoryless so on/off comparisons are clean.
        Progress accrues up to the crash (periodic checkpointing keeps all
        but the dying step), and the requeued job gets preemption priority
        plus a fresh plan ranking from ``replan_fn`` — computed against
        the updated corrector, so the class that just OOMed is no longer
        deemed feasible on that device class (no-repeat-OOM invariant).
        """
        plan = job.plan
        self.oom_count += 1
        job.record_restart("oom")
        self.oom_log.append((now, job.job_id,
                             plan.device_type if plan else "",
                             float(plan.pred_bytes) if plan else 0.0,
                             float(observed)))
        if memtrace.is_enabled() and plan is not None and job.cfg is not None:
            memtrace.record(job.cfg.family, plan.zero, plan.device_type,
                            plan.pred_bytes, observed, source="oom")
        self._accrue(job, now)
        self._serve_teardown(job, now)
        self.pool.release(job.placements)
        self._unregister(job)
        job.placements = ()
        job.rate = 0.0
        job.finish_time = -1.0
        job.epoch += 1                      # stale any in-flight finish
        job.allocation = None
        job.plan = None
        job.plan_rank = -1
        self._demoted.pop(job.job_id, None)
        # one combined budget across causes: an OOM-then-crash job cannot
        # spend ``max_restarts`` twice (equals ``max_oom_retries`` unless
        # overridden, so OOM-only runs are unchanged)
        if job.total_restarts > self.max_restarts:
            job.state = "failed"            # crash-looping: stop retrying
            self.oom_failures += 1
        else:
            job.state = "queued"
            job.preemptions += 1            # checkpoint-restart priority
            if self.replan_fn is not None and job.cfg is not None:
                plans = tuple(self.replan_fn(job))
                if plans:
                    job.plans = plans
                    job._min_dev = 0        # plan list changed: drop cache
                else:                       # no device can ever fit it now
                    job.state = "failed"
                    self.oom_failures += 1
        if job.state == "queued":
            # with a backoff base configured, OOM restarts wait it out too
            # (same combined escalation as crash restarts); the 0.0 default
            # keeps the immediate-requeue path
            delay = self._backoff_delay(job)
            if delay > 0.0 and self.rate_fn is not None:
                job.state = "backoff"
                self._seq += 1
                heapq.heappush(self._events,
                               (now + delay, self._seq, RESTART, job,
                                job.epoch))
            else:
                self.queued.append(job)
        else:
            self._completed(job)
        if TRACER.enabled:
            # one fused record for the whole OOM: the ``oom:`` prefix has
            # materialization synthesize the "oom" instant alongside the
            # queued | backoff | failed transition
            tr = TRACER
            b = tr.mark
            b.append(job.job_id); b.append(now)
            b.append("oom:" + job.state)
            if len(b) > tr.mark_trim:
                tr.trim()
        # the released capacity may admit queued work (incl. this job)
        if self._gate_open():
            self._run_scheduler(now, "oom")
        self._maybe_migrate(now)
        self._retry_serve_scale(now)

    def _preempt(self, job: Job, now: float) -> None:
        """Checkpoint a running job and requeue it with remaining work."""
        self._accrue(job, now)
        self._serve_teardown(job, now)
        self.pool.release(job.placements)
        self._unregister(job)
        job.placements = ()
        job.rate = 0.0
        job.finish_time = -1.0              # old prediction is void
        job.state = "queued"
        job.epoch += 1                      # in-flight finish becomes stale
        job.preemptions += 1
        job.allocation = None
        job.plan = None
        job.plan_rank = -1
        self.preemption_count += 1
        self._demoted.pop(job.job_id, None)
        self.queued.append(job)
        if TRACER.enabled:
            TRACER.job_state(job.job_id, "queued", now)

    # --------------------------------------------------- elastic migration
    def _maybe_migrate(self, now: float) -> None:
        """Migrate demoted jobs (running below their top-ranked plan) to a
        better-ranked plan when freed capacity allows and the predicted
        finish — including the checkpoint save+restore cost — improves.

        The new placement must fit *alongside* the old one (the job keeps
        computing until the restore target is secured), so a failed check
        mutates nothing.
        """
        if not self.elastic or self.rate_fn is None or not self._demoted:
            return
        # exact capacity gate (mirrors the admission min_need gate): no
        # better-ranked plan can be satisfiable with fewer idle devices than
        # its device count, so a skipped scan cannot change decisions
        if self.pool.total_idle < self._demoted.min_value():
            return
        migrated = False
        for jid in self._demoted:           # sorted snapshot (SortedIdDict)
            job = self.jobs[jid]
            if job.state != "running" or job.plan is None:
                self._demoted.pop(jid, None)
                continue
            best = self.pool.select_plan(job.plans)
            if best is None:
                continue
            rank = job.plans.index(best)
            if rank >= job.plan_rank:
                continue
            placements = self.pool.find_placements(best)
            if placements is None:
                continue
            if self.colocate:
                placements = _wrap_grants(self.pool, best, placements)
            new_raw = self.rate_fn(job, placements, best.d, best.t)
            # compare effective rates: the candidate placement may carry a
            # different checkpoint interval (different device MTBF)
            new_rate, new_tau, new_cost = \
                self._effective_rate(job, new_raw, placements)
            if new_rate <= job.rate:
                continue
            mig = self._migration_seconds(job)
            dt_run = max(now - job.progress_time, 0.0)
            done = job.samples_done + dt_run * job.rate
            done = min(done, float(job.total_samples))
            new_finish = now + mig + (job.total_samples - done) / new_rate
            # a doomed placement (finish_time = -1, OOM pending) has an
            # effectively infinite finish: any surviving migration pays off
            cur_finish = job.finish_time if job.finish_time >= 0 \
                else float("inf")
            if new_finish >= cur_finish:
                continue                    # migration does not pay off
            # commit: apply new, release old, reschedule the finish
            self.pool.apply(placements)
            self.pool.release(job.placements)
            self._unregister(job)
            if dt_run > 0.0:                # telemetry for the old segment
                self._charge_work(job, dt_run)
            job.samples_done = done
            job.progress_time = now + mig
            job.placements = tuple(placements)
            self._register(job)
            _record_plan(job, best, placements)
            job.plan_rank = rank
            job.rate = new_rate
            job._ckpt_tau, job.ckpt_cost_s = new_tau, new_cost
            job.epoch += 1                  # stale the old finish event
            job.migrations += 1
            self.migration_count += 1
            # the restored placement faces the same OOM exposure a fresh
            # start would (its old scheduled OOM, if any, just went stale)
            observed = (self.oom_check_fn(job, job.placements, self.pool)
                        if self.oom_check_fn is not None else None)
            self._seq += 1
            if observed is not None:
                job.finish_time = -1.0
                heapq.heappush(self._events,
                               (now + mig + self.oom_detect_seconds,
                                self._seq, OOM, (job, float(observed)),
                                job.epoch))
            else:
                job.finish_time = new_finish
                heapq.heappush(self._events,
                               (new_finish, self._seq, FINISH, job,
                                job.epoch))
            migrated = True
            if TRACER.enabled:
                TRACER.instant("migrate", now, job.job_id)
            self._track_demotion(job)
        # migrations released their old (often different-class) placements;
        # queued jobs may now fit — one more admission pass, same exact gate
        if migrated and self._gate_open():
            self._run_scheduler(now, "migrate")

    def _migration_seconds(self, job: Job) -> float:
        """Checkpoint-restore cost of moving/resuming this job, from the
        serialized training-state size (``ckpt.checkpoint``).  LoRA
        finetune jobs move only adapters + optimizer slices — near-free."""
        if job.cfg is None:
            return 0.0
        rank = job.lora_rank if job.kind == "finetune" else 0
        key = (job.cfg, rank)
        cost = self._mig_cost.get(key)
        if cost is None:
            from repro_torch.ckpt.checkpoint import migration_seconds
            cost = migration_seconds(job.cfg,
                                     bandwidth=self.migration_bandwidth,
                                     lora_rank=rank)
            self._mig_cost[key] = cost
        return cost

    # ------------------------------------------------------------ serving
    def _serve_teardown(self, job: Job, now: float) -> None:
        """A serve job is leaving the running state (finish / OOM /
        preemption): close its SLO segment and drop the replica group —
        the caller releases ``job.placements`` (still the flattened union
        of every replica) right after.  No-op for train jobs."""
        if job.kind != "serve":
            return
        self._account_serve(job, now)
        job.serve_replicas = 0
        job.replica_placements = []
        job.prefill_replicas = 0
        job.prefill_placements = []
        self._serve_backlog.discard(job.job_id)

    def _serve_started(self, job: Job, start: float) -> None:
        """A serve job was (re)admitted: the admission placement is replica
        0; compute the per-replica capacity from the shared rate model and
        scale out to the SLO target (or the pinned static count)."""
        job.serve_replicas = 1
        job.replica_placements = [job.placements]
        if job.cfg is not None and job.plan is not None:
            job.replica_rate, job.replica_step_s = serve_plan_capacity(
                job.cfg, job.plan, job.global_batch, job.seq_len)
        if job.disaggregated and job.cfg is not None:
            # the prefill pool runs its own (role="prefill") plan; absent a
            # ranking, it reuses the decode plan shape.  Per-request service
            # time is one prompt forward plus the priced KV handoff, and an
            # unset TTFT target defaults to the one-replica/70%-load p95.
            job.prefill_plan = (job.prefill_plans[0] if job.prefill_plans
                                else job.plan)
            if job.prefill_plan is not None:
                job.prefill_service_s = prefill_service_seconds(
                    job.cfg, job.prefill_plan, job.avg_prompt_len,
                    handoff_bandwidth=self.migration_bandwidth)
                if job.slo_ttft_s <= 0.0:
                    job.slo_ttft_s = default_ttft_slo(
                        job.cfg, job.prefill_plan, job.avg_prompt_len,
                        handoff_bandwidth=self.migration_bandwidth)
        self._account_serve(job, start)
        # initial provisioning is part of admission (both the autoscaled
        # and the pinned-static arm start at their full target).  On the
        # sim path it rides a scale_up event at the start instant rather
        # than mutating the pool mid-decision-batch — a non-committing
        # scheduler's remaining decisions were priced against the pool as
        # the scheduler saw it.
        if self.rate_fn is not None:
            self._seq += 1
            heapq.heappush(self._events,
                           (start, self._seq, SCALE_UP, job, job.epoch))
        else:
            self._scale_to(job, self._serve_target(job), start)

    def _serve_target(self, job: Job) -> int:
        """Replica target: the SLO model's count, or the pinned static
        count for ``autoscale=False`` baselines."""
        if not job.autoscale:
            return max(job.static_replicas, 1)
        return replicas_for_slo(job.replica_rate, job.replica_step_s,
                                job.request_rate, job.slo_p95_s,
                                max_replicas=job.max_replicas)

    def _prefill_target(self, job: Job) -> int:
        """Prefill-pool replica target (0 unless disaggregated).  Sized
        independently of the decode pool: demand is the request *arrival*
        rate (decode tokens/s over tokens-per-request), service is one
        prompt forward plus the priced KV handoff, and the same
        ``replicas_for_slo`` inversion applies against the TTFT target."""
        if not job.disaggregated or job.prefill_plan is None:
            return 0
        if not job.autoscale:
            return max(job.static_replicas, 1)
        service_s = max(job.prefill_service_s, 1e-9)
        req_s = job.request_rate / max(job.avg_new_tokens, 1.0)
        return replicas_for_slo(1.0 / service_s, service_s, req_s,
                                job.slo_ttft_s,
                                max_replicas=job.max_replicas)

    def _schedule_scale(self, job: Job, now: float) -> None:
        """Emit the typed scale event the new rate calls for (sim path).
        Scale-ups land after ``scale_up_delay`` (replica provisioning);
        scale-downs are immediate (releasing capacity is free).  Targets
        are recomputed at fire time, so a stale event self-cancels.
        Either pool (decode, or prefill when disaggregated) moving is
        enough to emit."""
        target = self._serve_target(job)
        pf_target = self._prefill_target(job)
        if target > job.serve_replicas or pf_target > job.prefill_replicas:
            self._seq += 1
            heapq.heappush(self._events,
                           (now + self.scale_up_delay, self._seq, SCALE_UP,
                            job, job.epoch))
        elif target < job.serve_replicas \
                or pf_target < job.prefill_replicas:
            self._seq += 1
            heapq.heappush(self._events,
                           (now, self._seq, SCALE_DOWN, job, job.epoch))

    def _scale_to(self, job: Job, target: int, now: float) -> None:
        """Grow/shrink the replica group to ``target`` replicas of the
        running plan.  Additional replicas are plain pool placements of
        ``job.plan``; a shortfall (pool too tight) parks the job on the
        serve backlog, retried whenever capacity frees."""
        if job.state != "running" or job.plan is None:
            return
        target = max(1, min(target, job.max_replicas))
        # colocation: extra replicas may ride slack bytes too (the
        # admission placement already did); whole-device falls out of the
        # harvest path when no slack fits
        harvest = self.colocate and job.kind in ("serve", "finetune")
        changed = False
        while job.serve_replicas < target:
            if harvest:
                placements = self.pool.find_placements(job.plan,
                                                       harvest=True)
            else:
                placements = self.pool.find_placements(job.plan)
            if placements is None:
                break                       # capacity tight; SLO will show it
            if self.colocate:
                placements = _wrap_grants(self.pool, job.plan, placements)
            self.pool.apply(placements)
            job.replica_placements.append(tuple(placements))
            self._register_placements(job.job_id, placements)
            job.serve_replicas += 1
            job.scale_ups += 1
            self.scale_up_count += 1
            changed = True
        released = False
        while job.serve_replicas > target:
            replica = job.replica_placements.pop()
            self.pool.release(replica)
            self._unregister_placements(job.job_id, replica)
            job.serve_replicas -= 1
            job.scale_downs += 1
            self.scale_down_count += 1
            changed = released = True
        # disaggregated: the prefill pool scales on the same transitions,
        # against its own TTFT-derived target (non-disaggregated jobs have
        # target 0 == prefill_replicas — this block never runs for them)
        pf_target = self._prefill_target(job)
        while job.prefill_replicas < pf_target:
            if harvest:
                placements = self.pool.find_placements(job.prefill_plan,
                                                       harvest=True)
            else:
                placements = self.pool.find_placements(job.prefill_plan)
            if placements is None:
                break                       # capacity tight; TTFT will show it
            if self.colocate:
                placements = _wrap_grants(self.pool, job.prefill_plan,
                                          placements)
            self.pool.apply(placements)
            job.prefill_placements.append(tuple(placements))
            self._register_placements(job.job_id, placements)
            job.prefill_replicas += 1
            job.scale_ups += 1
            self.scale_up_count += 1
            changed = True
        while job.prefill_replicas > pf_target:
            replica = job.prefill_placements.pop()
            self.pool.release(replica)
            self._unregister_placements(job.job_id, replica)
            job.prefill_replicas -= 1
            job.scale_downs += 1
            self.scale_down_count += 1
            changed = released = True
        if changed:
            # the refcounted index was updated per replica above; only the
            # flattened union needs rebuilding (O(changed replicas) index
            # work instead of re-registering the whole group)
            job.placements = tuple(p for rep in job.replica_placements
                                   for p in rep) \
                + tuple(p for rep in job.prefill_placements for p in rep)
            if TRACER.enabled:
                TRACER.instant("scale", now,
                               (job.job_id, job.serve_replicas,
                                job.prefill_replicas))
        if job.serve_replicas < target or job.prefill_replicas < pf_target:
            self._serve_backlog.add(job.job_id)
        else:
            self._serve_backlog.discard(job.job_id)
        if released and self._gate_open():
            self._run_scheduler(now, "scale")

    def _retry_serve_scale(self, now: float) -> None:
        """Capacity freed: serve jobs parked below their replica target get
        another scale attempt.  No-op (one set check) when no serve job is
        short — the train-only golden path never enters."""
        if not self._serve_backlog:
            return
        for jid in self._serve_backlog:     # sorted snapshot (SortedIdSet)
            job = self.jobs.get(jid)
            if job is None or job.state != "running" \
                    or job.kind != "serve":
                self._serve_backlog.discard(jid)
                continue
            self._account_serve(job, now)
            self._scale_to(job, self._serve_target(job), now)

    def _account_serve(self, job: Job, now: float) -> None:
        """Close the current SLO-accounting segment: between transitions
        the rate and replica count are constant, so the p95 verdict and
        the GPU-seconds of the segment are exact."""
        if job.kind != "serve":
            return
        if job.serve_accounted < 0:
            job.serve_accounted = now
            return
        dt = now - job.serve_accounted
        job.serve_accounted = now
        if dt <= 0.0:
            return
        job.slo_total_s += dt
        if job.state == "running" and job.serve_replicas > 0:
            cap = job.serve_replicas * job.replica_rate
            p95 = p95_token_latency(cap, job.request_rate,
                                    job.replica_step_s)
            good = p95 <= job.slo_p95_s
            if job.disaggregated:
                # both pools must hold: the decode p95 above, and the
                # prefill pool's TTFT under the same queueing model with
                # per-request service = prompt forward + KV handoff
                if job.prefill_replicas > 0:
                    req_s = job.request_rate / max(job.avg_new_tokens, 1.0)
                    service_s = max(job.prefill_service_s, 1e-9)
                    ttft = p95_token_latency(
                        job.prefill_replicas / service_s, req_s, service_s)
                    good = good and ttft <= job.slo_ttft_s
                else:
                    good = False            # no prefill pool: nothing admits
            if good:
                job.slo_good_s += dt
                if METRICS.enabled:
                    METRICS.inc("serve/slo_good_s", dt)
            per_replica = job.plan.n_devices if job.plan is not None else 0
            devs = job.serve_replicas * per_replica
            if job.disaggregated and job.prefill_plan is not None:
                devs += job.prefill_replicas * job.prefill_plan.n_devices
            job.gpu_seconds += dt * devs
            # benchmark telemetry (pure accumulation, decisions unchanged):
            # time-weighted modeled p95 (capped so saturated segments stay
            # finite) and tokens actually served under the capacity limit
            p95_cap = (10.0 * job.slo_p95_s if job.slo_p95_s > 0.0
                       else 30.0 * max(job.replica_step_s, 1e-9))
            job.p95_weight_s += dt * min(p95, p95_cap)
            job.p95_obs_s += dt
            job.tokens_served += dt * min(job.request_rate, cap)
        # queued/preempted segments count as missed: no replicas serving
        if METRICS.enabled:
            METRICS.inc("serve/slo_total_s", dt)

    # ------------------------------------------------- observability plane
    def _obs_event(self, now: float) -> None:
        """One engine event passed (callers pre-check ``METRICS.enabled``):
        count down the sample stride and feed the bounded time series at
        the boundary.  Pure accumulation — the stride only amortizes the
        sampling cost, it never changes what the engine does."""
        t = self._obs_tick
        if t <= 1:                          # also re-arms the countdown
            self._obs_sample(now)
        else:
            self._obs_tick = t - 1

    def _obs_sample(self, now: float) -> None:
        """Sample pool/queue/serve state into ``METRICS`` (downsampled
        series — bounded memory regardless of run length).  The pool only
        mutates inside events, so the event grid is the mutation grid.
        Re-arms the ``_dispatch`` countdown."""
        m = METRICS
        self._obs_tick = m.sample_stride if m.enabled else 0
        w = self._admit_waits               # buffered first-start waits
        if w:
            m.observe_many("queue/admission_wait_s", w)
            m.inc("jobs/admitted", len(w))
            w.clear()
        pool = self.pool
        total = pool.total_devices
        if total > 0:
            m.sample("cluster/util_pct", now,
                     100.0 * (total - pool.total_idle) / total)
        for dev_type, idle in pool.idle_by_type.items():
            m.sample("cluster/idle/" + dev_type, now, float(idle))
        m.sample("queue/depth", now, float(len(self.queued)))
        if self.scale_up_count:             # any serve activity at all
            m.sample("serve/replicas", now,
                     float(self.scale_up_count - self.scale_down_count))
            tot = m.counters.get("serve/slo_total_s", 0.0)
            if tot > 0.0:
                m.sample("serve/slo_attainment", now,
                         m.counters.get("serve/slo_good_s", 0.0) / tot)

    # ------------------------------------------------------------- helpers
    def _track_demotion(self, job: Job) -> None:
        """(Un)register a running job with the elastic scan, keyed by the
        fewest devices any better-ranked plan of it would need.  Serve
        jobs scale replicas instead of migrating plans — excluded."""
        if job.kind == "serve":
            self._demoted.pop(job.job_id, None)
            return
        if self.elastic and job.plan is not None and job.plan_rank > 0:
            self._demoted[job.job_id] = min(
                p.n_devices for p in job.plans[:job.plan_rank])
        else:
            self._demoted.pop(job.job_id, None)

    def _accrue(self, job: Job, now: float) -> None:
        """Fold compute since the last checkpoint into ``samples_done``
        (*graceful* accrual: node_leave preemption, OOM, rate changes —
        the departing runtime saves state on the way out, zero lost
        work)."""
        if job.rate > 0.0 and now > job.progress_time:
            dt = now - job.progress_time
            job.samples_done = min(job.samples_done + dt * job.rate,
                                   float(job.total_samples))
            self._charge_work(job, dt)
        job.progress_time = now

    def _charge_work(self, job: Job, dt: float) -> None:
        """Telemetry split of a run segment into useful compute vs
        checkpoint-save stall (pure accumulation — never read back by any
        decision).  With no checkpoint policy the whole segment is
        useful."""
        tau, cost = job._ckpt_tau, job.ckpt_cost_s
        if tau > 0.0:
            ov = dt * cost / (tau + cost)
            job.ckpt_overhead_s += ov
            self.ckpt_overhead_s += ov
            dt -= ov
        if job.kind != "serve":
            self.useful_work_s += dt

    def _accrue_crash(self, job: Job, now: float) -> float:
        """Crash accrual: only *durable* progress survives.  Under a
        periodic-checkpoint interval ``tau`` the job completed
        ``k = floor(elapsed / (tau + C))`` save cycles — those samples are
        kept; the partial cycle in flight is lost.  With no interval,
        everything since the last graceful checkpoint is lost.  Returns
        the lost seconds (telemetry)."""
        dt = now - job.progress_time
        lost = 0.0
        if job.rate > 0.0 and dt > 0.0:
            tau, cost = job._ckpt_tau, job.ckpt_cost_s
            if tau > 0.0:
                cycle = tau + cost
                k = int(dt // cycle)
                job.samples_done = min(
                    job.samples_done + k * cycle * job.rate,
                    float(job.total_samples))
                lost = dt - k * cycle
                job.ckpt_overhead_s += k * cost
                self.ckpt_overhead_s += k * cost
                self.useful_work_s += k * tau
            else:
                lost = dt
            job.lost_work_s += lost
            self.lost_work_s += lost
        job.progress_time = now
        return lost

    def _crash(self, job: Job, now: float) -> float:
        """A running job lost its placement to a node fault: roll back to
        the last durable checkpoint, then restart via deterministic
        exponential backoff — or abandon it once the combined restart
        budget is spent.  Returns the lost seconds."""
        if job.kind == "serve":
            # a serve job's "progress" is wall-clock serving time already
            # delivered — there is nothing to roll back; the SLO ledger
            # records the outage instead
            lost = 0.0
            self._accrue(job, now)
        else:
            lost = self._accrue_crash(job, now)
        self._serve_teardown(job, now)
        self.pool.release(job.placements)
        self._unregister(job)
        job.placements = ()
        job.rate = 0.0
        job.finish_time = -1.0
        job.epoch += 1                      # stale any in-flight events
        job.allocation = None
        job.plan = None
        job.plan_rank = -1
        self._demoted.pop(job.job_id, None)
        job.record_restart("crash")
        self.crash_count += 1
        if job.total_restarts > self.max_restarts:
            job.state = "failed"            # budget spent: stop retrying
            self.crash_failures += 1
            self._completed(job)
            return lost
        job.preemptions += 1                # checkpoint-restart priority
        delay = self._backoff_delay(job)
        if delay > 0.0 and self.rate_fn is not None:
            job.state = "backoff"
            self._seq += 1
            heapq.heappush(self._events,
                           (now + delay, self._seq, RESTART, job, job.epoch))
        else:
            job.state = "queued"
            self.queued.append(job)
        return lost

    def _backoff_delay(self, job: Job) -> float:
        """Deterministic exponential backoff with deterministic jitter:
        ``base * 2^(n-1) * (1 + U[0, 0.25))`` for the job's n-th restart,
        where U is drawn from a generator seeded by (job id, n) — the
        same restart of the same job always waits the same time, and two
        jobs crashed by one fault wave fan out instead of stampeding."""
        if self.restart_backoff_s <= 0.0:
            return 0.0
        n = max(job.total_restarts, 1)
        jitter = random.Random(
            f"backoff|{job.job_id}|{n}").uniform(0.0, 0.25)
        return self.restart_backoff_s * (2.0 ** (min(n, 10) - 1)) \
            * (1.0 + jitter)

    def _fail_serve_replicas(self, job: Job, node_id: str,
                             now: float) -> bool:
        """Partial serve failure: drop exactly the decode/prefill replicas
        placed on the failed node; the survivors keep serving degraded.
        Returns False when no decode replica survives — the caller crashes
        the whole job instead.  The SLO segment is closed at the fault, so
        the dead-replica window is honestly accounted at the reduced
        capacity until the backlog refills the group."""
        dead = [rep for rep in job.replica_placements
                if any(nid == node_id for nid, _ in rep)]
        if len(dead) >= len(job.replica_placements):
            return False                    # whole decode pool died
        self._account_serve(job, now)       # close the pre-fault segment
        for rep in dead:
            job.replica_placements.remove(rep)
            self.pool.release(rep)
            self._unregister_placements(job.job_id, rep)
            job.serve_replicas -= 1
            job.replica_fails += 1
            self.replica_fail_count += 1
        for rep in [rep for rep in job.prefill_placements
                    if any(nid == node_id for nid, _ in rep)]:
            job.prefill_placements.remove(rep)
            self.pool.release(rep)
            self._unregister_placements(job.job_id, rep)
            job.prefill_replicas -= 1
            job.replica_fails += 1
            self.replica_fail_count += 1
        job.placements = tuple(p for rep in job.replica_placements
                               for p in rep) \
            + tuple(p for rep in job.prefill_placements for p in rep)
        # replacement replicas ride the normal provisioning path: parked on
        # the backlog and re-scaled after ``scale_up_delay`` (sim) or on
        # the next capacity event (live)
        self._serve_backlog.add(job.job_id)
        if self.rate_fn is not None:
            self._seq += 1
            heapq.heappush(self._events,
                           (now + self.scale_up_delay, self._seq, SCALE_UP,
                            job, job.epoch))
        return True

    def _effective_rate(self, job: Job, raw: float, placements
                        ) -> Tuple[float, float, float]:
        """Resolve the periodic-checkpoint interval for this (job,
        placement) and fold the save stall into the rate:
        ``(raw * tau/(tau+C), tau, C)``.  Resolution order: per-job
        ``ckpt_interval_s`` override, else the engine policy — Young–Daly
        ``sqrt(2*C*MTBF_agg)`` with the aggregate MTBF of the placement's
        devices, or the fixed interval.  Returns ``(raw, 0, 0)`` untouched
        when checkpointing is off (the bit-identity path) or for serve
        jobs (replicas hold no training state)."""
        if (self.ckpt_policy is None and job.ckpt_interval_s <= 0.0) \
                or job.kind == "serve" or job.cfg is None or raw <= 0.0:
            return raw, 0.0, 0.0
        cost = self._checkpoint_cost(job)
        if cost <= 0.0:
            return raw, 0.0, 0.0
        if job.ckpt_interval_s > 0.0:
            tau = job.ckpt_interval_s
        elif self.ckpt_policy == "fixed":
            tau = self.ckpt_fixed_interval_s
        else:                               # young_daly
            hazard = 0.0
            for nid, k in placements:
                node = self.pool.nodes[nid]
                dev = DEVICE_TYPES[node.device_type]
                hazard += k / dev.mtbf_s
            if hazard <= 0.0:
                return raw, 0.0, 0.0
            tau = math.sqrt(2.0 * cost / hazard)
        if tau <= 0.0:
            return raw, 0.0, 0.0
        tau = max(tau, cost)                # an interval under C is absurd
        return raw * tau / (tau + cost), tau, cost

    def _checkpoint_cost(self, job: Job) -> float:
        """Seconds one durable save stalls the job (cached per config —
        LoRA finetunes save only adapters, near-free)."""
        if job.cfg is None:
            return 0.0
        rank = job.lora_rank if job.kind == "finetune" else 0
        key = (job.cfg, rank)
        cost = self._save_cost.get(key)
        if cost is None:
            from repro_torch.ckpt.checkpoint import checkpoint_seconds
            cost = checkpoint_seconds(job.cfg,
                                      bandwidth=self.migration_bandwidth,
                                      lora_rank=rank)
            self._save_cost[key] = cost
        return cost

    def _register(self, job: Job) -> None:
        self._register_placements(job.job_id, job.placements)

    def _unregister(self, job: Job) -> None:
        self._unregister_placements(job.job_id, job.placements)

    def _register_placements(self, job_id: int, placements) -> None:
        """Refcount placement entries into the node -> jobs index — serve
        replica churn registers only the replicas that changed."""
        for nid, _ in placements:
            per_node = self._node_jobs.setdefault(nid, {})
            per_node[job_id] = per_node.get(job_id, 0) + 1

    def _unregister_placements(self, job_id: int, placements) -> None:
        for nid, _ in placements:
            per_node = self._node_jobs.get(nid)
            if per_node is None:
                continue
            left = per_node.get(job_id, 0) - 1
            if left > 0:
                per_node[job_id] = left
            else:
                per_node.pop(job_id, None)

