"""The serverless front door (paper §I): users submit a model + training
config and nothing else; MARP predicts resources, HAS places the job, and
the shared lifecycle engine (via the orchestrator) owns it from there —
admission, FIFO restart on release, and requeue-with-progress when cluster
capacity churns.  This is what `python -m repro_torch.launch.submit` drives.

The port's copy of the JAX package's ``repro.core.serverless``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.lifecycle import Job
from repro_torch.core.marp import ResourcePlan, predict_plans
from repro_torch.core.orchestrator import Orchestrator


@dataclass
class SubmitResult:
    job: Job
    plans: Sequence[ResourcePlan]

    @property
    def started(self) -> bool:
        return self.job.state == "running"

    def describe(self) -> str:
        lines = [f"job {self.job.job_id}: {self.job.state}"]
        if self.job.allocation:
            p = self.job.allocation.plan
            lines.append(f"  plan: d={p.d} t={p.t} -> {p.n_devices}x"
                         f" {p.device_type} (>= {p.min_mem_gb:.1f} GB each,"
                         f" predicted {p.pred_bytes / 2**30:.1f} GB)")
            for node_id, k in self.job.allocation.placements:
                lines.append(f"  node {node_id}: {k} device(s)")
        else:
            lines.append(f"  queued ({len(self.plans)} feasible plans,"
                         " awaiting resources)")
        if self.job.kind == "serve" and self.job.serve_replicas:
            lines.append(f"  serving: {self.job.serve_replicas} replica(s)"
                         f" at {self.job.request_rate:.0f} tok/s offered"
                         f" (p95 target {self.job.slo_p95_s * 1e3:.0f} ms)")
        if self.job.preemptions or self.job.migrations or self.job.ooms:
            lines.append(f"  lifecycle: {self.job.preemptions} preemption(s),"
                         f" {self.job.migrations} migration(s),"
                         f" {self.job.ooms} oom(s)")
        if self.job.state == "failed":
            reason = "no feasible plan with headroom remains" \
                if not self.job.plans else "retry budget exhausted"
            lines.append(f"  failed: repeated out-of-memory kills"
                         f" ({reason})")
        return "\n".join(lines)


def submit(orch: Orchestrator, cfg: ModelConfig, train: TrainConfig, *,
           mode: str = "exact") -> SubmitResult:
    """Serverless submission: no device counts or types from the user."""
    device_types = sorted({n.device_type for n in orch.nodes.values()})
    plans = predict_plans(cfg, train.global_batch, train.seq_len,
                          device_types=device_types, zero=train.zero,
                          mode=mode)
    if not plans:
        raise RuntimeError(
            f"MARP found no feasible (d, t) plan for {cfg.name} at"
            f" batch={train.global_batch} seq={train.seq_len} on device types"
            f" {device_types} — the model cannot fit this cluster.")
    rec = orch.submit(plans, cfg=cfg, global_batch=train.global_batch,
                      seq_len=train.seq_len, mode=mode)
    return SubmitResult(job=rec, plans=plans)


def submit_serve(orch: Orchestrator, cfg: ModelConfig, *, batch: int,
                 cache_len: int, request_rate: float = 0.0,
                 slo_p95_s: Optional[float] = None, autoscale: bool = True,
                 static_replicas: int = 0) -> SubmitResult:
    """Serverless serving submission: no device counts, types, or replica
    counts from the user — MARP's serve sweep picks the plan, and the SLO
    autoscaler owns the replica count from there (drive it with
    ``orch.set_request_rate``).  ``slo_p95_s`` defaults to a p95 target
    one replica meets at 70% load (``marp.default_serve_slo``)."""
    from repro_torch.core.marp import default_serve_slo, predict_serve_plans
    device_types = sorted({n.device_type for n in orch.nodes.values()})
    plans = predict_serve_plans(cfg, batch, cache_len,
                                device_types=device_types)
    if not plans:
        raise RuntimeError(
            f"MARP found no feasible serve plan for {cfg.name} at"
            f" batch={batch} cache_len={cache_len} on device types"
            f" {device_types} — the model cannot fit this cluster.")
    if slo_p95_s is None:
        slo_p95_s = default_serve_slo(cfg, plans[0], batch, cache_len)
    rec = orch.submit_serve(plans, cfg=cfg, batch=batch,
                            cache_len=cache_len, request_rate=request_rate,
                            slo_p95_s=slo_p95_s, autoscale=autoscale,
                            static_replicas=static_replicas)
    return SubmitResult(job=rec, plans=plans)


def report_oom(orch: Orchestrator, result: SubmitResult,
               observed_bytes: float) -> SubmitResult:
    """A runner watched the submitted job die out-of-memory: feed the
    observed peak through the lifecycle into the memory feedback plane and
    requeue the job (with the plane enabled, onto a plan with headroom)."""
    orch.oom(result.job.job_id, observed_bytes)
    return result
