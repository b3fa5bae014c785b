"""Schedulers for the simulator: Frenzy (MARP+HAS), Sia-like ILP baseline,
and Opportunistic/FCFS (Lyra-style) baseline (paper §V-A-c).

The port's copy of the JAX package's ``repro.cluster.schedulers``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

Scheduler state contract: ``schedule(queued, state)`` accepts either the
lifecycle engine's long-lived ``ClusterPool`` (the fast path —
incrementally indexed, shared with the event loop) or a plain
``{node_id: Node}`` dict (legacy callers, e.g. the overhead benchmark).  A
scheduler that sets ``applies_to_pool = True`` commits its placements to a
shared pool itself, so the caller must not re-apply them; with a dict it
works on a private snapshot and the caller applies the returned decisions,
exactly like the seed ``_clone_nodes`` protocol.

Queue order is ``lifecycle.fifo_order`` for every scheduler here: FIFO by
(arrival, id), except jobs preempted by node departures go first, least
remaining work ahead — churn must not starve nearly-finished work.
``queued`` may be a plain list or the engine's persistent
``AdmissionQueue``; ``fifo_order`` handles both (the queue yields its
k-way shard merge instead of re-sorting), and ``FrenzyScheduler``
additionally takes the sharded-pass fast path when given the queue plus
the shared pool — bit-identical decisions either way.

Fractional-GPU packing: only pool-applying schedulers can place
byte slices — a slice grant is a budget against the *shared* pool's
per-device open-slot accounting, which a snapshot scheduler's private
``{node_id: Node}`` clone cannot represent (``work[nid].idle -= k``
counts whole devices).  ``Scheduler.supports_slicing`` is the capability
bit: ``HASAdmission`` (hence ``FrenzyScheduler``) sets it True; the
snapshot baselines here inherit the default False and the engine rejects
``colocate=True`` for them at construction instead of silently dropping
byte budgets.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import calibration
from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.core.lifecycle import (HASAdmission, fifo_order, nodes_map,
                                  snapshot_nodes)
from repro_torch.core.marp import (_active_analytic, _dp_efficiency,
                             _tp_efficiency)
from repro_torch.cluster.simulator import Scheduler, SimJob, job_rate  # noqa: F401

# Back-compat aliases (pre-lifecycle module layout).
_nodes_map = nodes_map
_snapshot_nodes = snapshot_nodes
_fifo = fifo_order


class FrenzyScheduler(HASAdmission):
    """MARP's ranked plans + HAS best-fit placement, FIFO order — the
    paper-named face of the shared ``lifecycle.HASAdmission`` policy (one
    admission implementation for simulator, orchestrator, and serverless
    submission; see that class for the indexing/no-rollback details).
    Inherits ``supports_slicing = True``: with ``colocate=True`` it
    places small serve replicas and LoRA finetunes as byte slices in the
    slack of running train jobs."""
    name = "frenzy"


class OpportunisticScheduler(Scheduler):
    """FCFS; always grabs the computationally strongest idle devices first
    for the user-specified device count (Lyra-style opportunistic)."""
    name = "opportunistic"

    def schedule(self, queued, state):
        nodes = _nodes_map(state)
        work = _snapshot_nodes(state)
        total = sum(n.total for n in nodes.values())
        out = []
        for job in _fifo(queued):
            # manual trial-and-error: the user walks the plan list until one
            # is physically satisfiable by this cluster's device classes
            plan = None
            for cand_plan in job.plans:
                fit = sum(n.total for n in nodes.values()
                          if n.mem >= cand_plan.min_mem)
                if fit >= cand_plan.n_devices:
                    plan = cand_plan
                    break
            if plan is None:
                break
            # user-specified count (the manual pick), clamped to the cluster
            need = min(job.requested_n or plan.n_devices, total)
            min_mem = plan.min_mem
            # strongest devices first, ignore fragmentation/locality
            cand = sorted(work.values(),
                          key=lambda n: -DEVICE_TYPES[n.device_type].flops)
            placements: List[Tuple[str, int]] = []
            left = need
            for n in cand:
                if n.mem < min_mem or n.idle == 0:
                    continue
                take = min(n.idle, left)
                placements.append((n.node_id, take))
                left -= take
                if left == 0:
                    break
            if left > 0:
                break                               # FCFS blocking
            for node_id, k in placements:
                work[node_id].idle -= k
            out.append((job, tuple(placements), plan.d, plan.t))
        return out


class ElasticFlowScheduler(Scheduler):
    """ElasticFlow-style [ASPLOS'23] admission-control baseline (paper
    §III-A-1): homogeneous-minded serverless scaling — picks the smallest
    feasible plan, then grows it while idle devices remain (elastic
    scale-out), but is memory/heterogeneity-blind: it treats every device
    class as interchangeable and only checks counts, so placements can land
    on slow classes (the deficiency the paper attributes to it)."""
    name = "elasticflow"

    def schedule(self, queued, state):
        work = _snapshot_nodes(state)
        out = []
        for job in _fifo(queued):
            if not job.plans:
                continue
            idle = sum(n.idle for n in work.values())
            # smallest feasible plan, grown to the largest same-type plan
            # that still fits the idle pool
            cands = sorted(job.plans, key=lambda p: p.n_devices)
            plan = next((p for p in cands if p.n_devices <= idle), None)
            if plan is None:
                break
            for p in reversed(cands):           # elastic scale-out
                if p.n_devices <= idle and p.min_mem <= plan.min_mem * 2:
                    plan = p
                    break
            placements: List[Tuple[str, int]] = []
            left = plan.n_devices
            for n in sorted(work.values(), key=lambda n: -n.idle):
                if n.idle == 0 or n.mem < plan.min_mem:
                    continue
                take = min(n.idle, left)
                placements.append((n.node_id, take))
                left -= take
                if left == 0:
                    break
            if left > 0:
                break
            for node_id, kk in placements:
                work[node_id].idle -= kk
            out.append((job, tuple(placements), plan.d, plan.t))
        return out


class SiaScheduler(Scheduler):
    """Sia-like goodput-optimising ILP (branch & bound, exact up to a node
    budget).  Each queued job has candidate configs (device type, count,
    d, t, rate); the ILP maximises total rate subject to per-type idle
    counts — this is the expensive search the paper contrasts with HAS
    (Fig 5a).

    Two things keep the search from blowing up combinatorially at mid
    queue depths (q16 once cost ~80x q8 per call): the incumbent is
    **warm-started** with the greedy FIFO solution before the recursion
    (so the very first bound comparisons already prune against a strong
    score instead of -1), and the optimistic remaining-goodput bound is a
    precomputed suffix array instead of an O(jobs) sum per visited node.
    ``max_nodes`` remains the exactness budget: past it the best
    incumbent (never worse than greedy) is returned.
    ``tests/test_sched_perf.py`` guards the per-call cost."""
    name = "sia"

    def __init__(self, max_nodes: int = 200_000, max_configs: int = 6):
        self.max_nodes = max_nodes
        self.max_configs = max_configs

    def schedule(self, queued, state):
        if not queued:
            return []
        nodes = _nodes_map(state)
        # idle devices per type, and nodes per type for final placement
        idle_by_type: Dict[str, int] = {}
        for n in nodes.values():
            idle_by_type[n.device_type] = idle_by_type.get(n.device_type, 0) + n.idle
        types = sorted(idle_by_type)
        jobs = _fifo(queued)

        # candidate configs per job: (type_idx, n, d, t, rate).  Sia
        # schedules at the user-specified GPU count (paper §V-A-c): it
        # optimises placement across types but cannot right-size the job.
        cands: List[List[Tuple[int, int, int, int, float]]] = []
        for job in jobs:
            cj = []
            plans = job.plans
            if job.requested_n:
                fixed = [p for p in plans if p.n_devices == job.requested_n]
                if fixed:
                    plans = fixed
            for plan in plans:
                if plan.device_type not in idle_by_type:
                    continue
                ti = types.index(plan.device_type)
                dev = DEVICE_TYPES[plan.device_type]
                if dev.mem < plan.min_mem:
                    continue
                fps = 6.0 * _active_analytic(job.cfg) * job.seq_len
                # same MFU source as MARP/job_rate (seed's 0.45 when
                # calibration is off) so the ILP's goodput objective stays
                # consistent with the simulated world
                mfu = calibration.mfu_for(job.cfg.family, plan.device_type)
                rate = (plan.n_devices * dev.flops * mfu
                        * _tp_efficiency(plan.t, dev)
                        * _dp_efficiency(plan.d) / fps)
                cj.append((ti, plan.n_devices, plan.d, plan.t, rate))
            cj.sort(key=lambda c: -c[4])
            cands.append(cj[:self.max_configs])

        # optimistic remaining goodput per suffix (capacity-blind upper
        # bound), computed once — the recursion reads it O(1) per node
        suffix = [0.0] * (len(jobs) + 1)
        for i in range(len(jobs) - 1, -1, -1):
            suffix[i] = suffix[i + 1] + max((c[4] for c in cands[i]),
                                            default=0.0)

        # warm start: greedy FIFO descent (each job takes its best-rate
        # config that still fits).  This is the admission order Sia would
        # fall back to anyway, and it gives the branch & bound a strong
        # incumbent from the first prune.
        g_avail = [idle_by_type[t] for t in types]
        g_choice: List[Optional[int]] = []
        g_score = 0.0
        for cj in cands:
            pick = None
            for ci, (ti, n, d, t, rate) in enumerate(cj):
                if g_avail[ti] >= n:
                    g_avail[ti] -= n
                    g_score += rate
                    pick = ci
                    break
            g_choice.append(pick)
        best = {"score": g_score, "choice": tuple(g_choice), "nodes": 0}

        def rec(i: int, avail: Tuple[int, ...], score: float,
                choice: Tuple[Optional[int], ...]):
            if best["nodes"] > self.max_nodes:
                return
            best["nodes"] += 1
            if i == len(jobs):
                if score > best["score"]:
                    best["score"] = score
                    best["choice"] = choice
                return
            if score + suffix[i] <= best["score"]:
                return                              # prune
            for ci, (ti, n, d, t, rate) in enumerate(cands[i]):
                if avail[ti] >= n:
                    na = list(avail)
                    na[ti] -= n
                    rec(i + 1, tuple(na), score + rate, choice + (ci,))
            rec(i + 1, avail, score, choice + (None,))   # skip job

        rec(0, tuple(idle_by_type[t] for t in types), 0.0, ())

        out = []
        if best["choice"] is None:
            return out
        work = _snapshot_nodes(state)
        for ji, (job, ci) in enumerate(zip(jobs, best["choice"])):
            if ci is None:
                continue
            ti, n, d, t, rate = cands[ji][ci]
            dtype = types[ti]
            placements: List[Tuple[str, int]] = []
            left = n
            # densest nodes of that type first
            for node in sorted((x for x in work.values()
                                if x.device_type == dtype and x.idle > 0),
                               key=lambda x: -x.idle):
                take = min(node.idle, left)
                placements.append((node.node_id, take))
                node.idle -= take
                left -= take
                if left == 0:
                    break
            if left > 0:
                continue                            # resources raced away
            out.append((job, tuple(placements), d, t))
        return out
