"""The simulated run ``obs.report --demo`` reports on: the port's copies of
the JAX package's ``benchmarks.sched_scale.make_scaled_cluster`` and
``benchmarks.obs_overhead.churn_oom_sim``, built on the port's control
plane (``cluster``, ``core.orchestrator``), so that the report's demo
needs nothing outside the port."""
from __future__ import annotations

from repro_torch.cluster.schedulers import FrenzyScheduler
from repro_torch.cluster.simulator import simulate
from repro_torch.cluster.traces import (churn_schedule, misprediction_oracle,
                                        scale_workload)
from repro_torch.core.orchestrator import make_cluster


def make_scaled_cluster(n_nodes: int):
    """Heterogeneous cluster of ~n_nodes in the paper sim cluster's 3:2:1
    device-class mix (§V-A)."""
    a = n_nodes // 2
    b = n_nodes // 3
    c = n_nodes - a - b
    return make_cluster([(a, 8, "RTX2080Ti"), (b, 8, "A100-40G"),
                         (c, 4, "RTX6000")])


def churn_oom_sim(n_nodes: int, n_jobs: int, seed: int = 17):
    """One churn + misprediction sim on the scale-benchmark cluster mix.
    Deterministic (``charge_overhead=False``): the same inputs replay the
    same decisions, obs on or off."""
    nodes = make_scaled_cluster(n_nodes)
    types = sorted({n.device_type for n in nodes})
    jobs = scale_workload(n_jobs, types, seed=seed)
    horizon = max(j.arrival for j in jobs)
    churn = churn_schedule(nodes, horizon=horizon, churn_frac=0.02,
                           seed=seed)
    return simulate(jobs, nodes, FrenzyScheduler(), charge_overhead=False,
                    cluster_events=churn,
                    oom_check_fn=misprediction_oracle(seed=seed))
