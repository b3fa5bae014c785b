"""Workload traces (paper §V-A-b) and cluster-dynamics traces.

The port's copy of the JAX package's ``repro.cluster.traces``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

Real Philly / Helios traces are not redistributable offline; we generate
synthetic traces with the published statistical character (Philly: many
short small-GPU jobs, heavy-tailed durations; Helios: larger GPU counts,
longer runtimes — per the papers' own characterisations), plus the paper's
*NewWorkload*: queues of GPT-2 and BERT models of varying size/batch.

Beyond job arrivals, ``churn_schedule`` and ``spot_schedule`` generate
*cluster* events (``node_leave``/``node_join``) for the lifecycle engine's
dynamic-availability path: maintenance-style independent churn, and
spot-market reclamation waves that take out correlated batches of nodes.
``misprediction_oracle`` injects memory-misprediction noise (the paper's
"accuracy exceeds 92%" leaves a tail where it doesn't): a deterministic
per-job-class true-peak multiplier that feeds the lifecycle engine's
``oom`` events and, through them, the memory feedback plane.
"""
from __future__ import annotations

import heapq
import math
import random
from collections import deque
from dataclasses import replace
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.devices import DEVICE_TYPES
from repro_torch.core.lifecycle import (ClusterEvent, RateEvent, NODE_FAIL,
                                  NODE_JOIN, NODE_LEAVE)
from repro_torch.core.marp import (default_serve_slo, predict_plans_shared,
                             predict_serve_plans_shared, replicas_for_slo,
                             serve_plan_capacity)
from repro_torch.cluster.simulator import SimJob


def make_gpt(name: str, h: int, l: int, heads: int, vocab: int = 50257,
             ff_mult: int = 4) -> ModelConfig:
    return ModelConfig(name=name, family="dense", num_layers=l, d_model=h,
                       num_heads=heads, num_kv_heads=heads, d_ff=ff_mult * h,
                       vocab_size=vocab, attention="gqa", mlp_variant="gelu",
                       tie_embeddings=True)


# the paper's NewWorkload model pool: GPT-2 and BERT at several sizes
GPT2_SIZES = {
    "gpt2-124m": make_gpt("gpt2-124m", 768, 12, 12),
    "gpt2-350m": make_gpt("gpt2-350m", 1024, 24, 16),
    "gpt2-774m": make_gpt("gpt2-774m", 1280, 36, 20),
    "gpt2-1.5b": make_gpt("gpt2-1.5b", 1600, 48, 25),
    "gpt2-2.7b": make_gpt("gpt2-2.7b", 2560, 32, 32),
    "gpt2-7b":   make_gpt("gpt2-7b", 4096, 32, 32),
}
BERT_SIZES = {
    "bert-base":  make_gpt("bert-base", 768, 12, 12, vocab=30522),
    "bert-large": make_gpt("bert-large", 1024, 24, 16, vocab=30522),
}


def _mk_job(rng: random.Random, job_id: int, arrival: float,
            cfg: ModelConfig, batch: int, seq: int, samples: int,
            device_types: Sequence[str],
            lora_rank: int = 0) -> Optional[SimJob]:
    # shared memoized tuple: jobs with the same (cfg, batch, seq) carry the
    # *same* plan-list object, so schedulers can dedupe no-fit checks
    plans = predict_plans_shared(cfg, batch, seq,
                                 device_types=tuple(device_types),
                                 max_devices=64, lora_rank=lora_rank)
    if not plans:
        return None
    # opportunistic baselines use a "user-specified" count: the smallest
    # feasible size, sometimes doubled (manual over-provisioning trial and
    # error, paper §III-B-1)
    req = min(p.n_devices for p in plans)
    if rng.random() < 0.3:
        req *= 2
    return SimJob(job_id=job_id, arrival=arrival, cfg=cfg, global_batch=batch,
                  seq_len=seq, total_samples=samples, plans=plans,
                  requested_n=req)


def new_workload_iter(n_jobs: int, device_types: Sequence[str],
                      seed: int = 0, mean_interarrival: float = 120.0
                      ) -> Iterator[SimJob]:
    """Streaming form of ``new_workload`` — same rng, same jobs, one at a
    time (the engine's streaming run path holds only live jobs)."""
    rng = random.Random(seed)
    pool = list(GPT2_SIZES.values()) + list(BERT_SIZES.values())
    t, jid = 0.0, 0
    while jid < n_jobs:
        t += rng.expovariate(1.0 / mean_interarrival)
        cfg = rng.choice(pool)
        batch = rng.choice([8, 16, 32, 64])
        seq = rng.choice([512, 1024, 2048])
        minutes = rng.lognormvariate(math.log(30), 0.8)     # ~30 min median
        job = _mk_job(rng, jid, t, cfg, batch, seq, samples=1,
                      device_types=device_types)
        if job is None:
            continue
        # convert target duration to samples using a nominal 1-device rate
        job.total_samples = max(int(minutes * 60 * 2), 1)   # ~2 samples/s
        yield job
        jid += 1


def new_workload(n_jobs: int, device_types: Sequence[str],
                 seed: int = 0, mean_interarrival: float = 120.0
                 ) -> List[SimJob]:
    """The paper's NewWorkload: GPT-2 + BERT queues (30/60 tasks)."""
    return list(new_workload_iter(n_jobs, device_types, seed,
                                  mean_interarrival))


def scale_workload_iter(n_jobs: int, device_types: Sequence[str],
                        seed: int = 0, mean_interarrival: float = 1.0,
                        mean_minutes: float = 10.0,
                        start_id: int = 0) -> Iterator[SimJob]:
    """Streaming form of ``scale_workload`` (identical rng draw order, so
    ``list(scale_workload_iter(...))`` with ``start_id=0`` is bit-identical
    to the list builder).  ``start_id`` offsets job ids so several traffic
    classes can merge into one trace without collisions."""
    rng = random.Random(300 + seed)
    pool = list(GPT2_SIZES.values()) + list(BERT_SIZES.values())
    t, made = 0.0, 0
    while made < n_jobs:
        t += rng.expovariate(1.0 / mean_interarrival)
        cfg = rng.choice(pool)
        batch = rng.choice([8, 16, 32, 64])
        seq = rng.choice([512, 1024, 2048])
        job = _mk_job(rng, start_id + made, t, cfg, batch, seq, 1,
                      device_types)
        if job is None:
            continue
        minutes = rng.lognormvariate(math.log(mean_minutes), 0.8)
        job.total_samples = max(int(minutes * 60 * 2), 1)
        yield job
        made += 1


def scale_workload(n_jobs: int, device_types: Sequence[str], seed: int = 0,
                   mean_interarrival: float = 1.0,
                   mean_minutes: float = 10.0) -> List[SimJob]:
    """Control-plane stress mix for large clusters (benchmarks/sched_scale):
    the NewWorkload model pool at a high arrival rate with short runtimes,
    so queues build and drain quickly and the event loop is scheduler-bound.
    Draws from a small (cfg, batch, seq) key set — as production trace
    replays do — so MARP's plan cache and the schedulers' shared-plan-list
    dedupe engage."""
    return list(scale_workload_iter(n_jobs, device_types, seed,
                                    mean_interarrival, mean_minutes))


#: finetune model pool: mid-sized GPT-2s (LoRA on the small end is not
#: worth a cluster job; the large end finetunes full-parameter).
FINETUNE_SIZES = ("gpt2-350m", "gpt2-774m", "gpt2-1.5b")


def finetune_workload_iter(n_jobs: int, device_types: Sequence[str],
                           seed: int = 0, mean_interarrival: float = 2.0,
                           mean_minutes: float = 5.0,
                           start_id: int = 0,
                           lora: bool = False) -> Iterator[SimJob]:
    """LoRA finetune traffic (``kind="finetune"``): short, latency-tolerant
    jobs whose training state is adapters-only (``ckpt.lora_state_bytes``)
    — near-free checkpoints make them ideal preemption/backfill fodder for
    the admission shards.  By default placement still prices the *full*
    training state (frozen weights + optimizer + activations live
    on-device); only the checkpoint and migration traffic shrinks.
    ``lora=True`` additionally prices *placement* as a LoRA finetune
    (``predict_plans_shared(..., lora_rank=rank)``: frozen bf16 base +
    adapter-only train state), shrinking ``slice_bytes`` so the jobs
    become colocation harvesters — rng draw order is unchanged, so the
    two modes see identical arrivals/models/ranks."""
    rng = random.Random(800 + seed)
    t, made = 0.0, 0
    while made < n_jobs:
        t += rng.expovariate(1.0 / mean_interarrival)
        cfg = GPT2_SIZES[rng.choice(FINETUNE_SIZES)]
        batch = rng.choice([4, 8, 16])
        seq = rng.choice([512, 1024])
        rank = rng.choice([8, 16, 32])
        job = _mk_job(rng, start_id + made, t, cfg, batch, seq, 1,
                      device_types, lora_rank=rank if lora else 0)
        if job is None:
            continue
        minutes = rng.lognormvariate(math.log(mean_minutes), 0.8)
        job.total_samples = max(int(minutes * 60 * 2), 1)
        job.kind = "finetune"
        job.lora_rank = rank
        yield job
        made += 1


def finetune_workload(n_jobs: int, device_types: Sequence[str],
                      seed: int = 0, mean_interarrival: float = 2.0,
                      mean_minutes: float = 5.0,
                      start_id: int = 0) -> List[SimJob]:
    return list(finetune_workload_iter(n_jobs, device_types, seed,
                                       mean_interarrival, mean_minutes,
                                       start_id))


def mixed_scale_workload_iter(n_train: int, n_finetune: int,
                              device_types: Sequence[str], seed: int = 0,
                              mean_interarrival: float = 1.0,
                              mean_minutes: float = 10.0
                              ) -> Iterator[SimJob]:
    """Train + LoRA-finetune traffic classes merged by arrival time — the
    scale benchmark's mixed stream.  Lazy: pulls one job per class ahead,
    so a 1M-job merge holds O(1) jobs."""
    train = scale_workload_iter(n_train, device_types, seed,
                                mean_interarrival, mean_minutes)
    ft = finetune_workload_iter(n_finetune, device_types, seed,
                                start_id=n_train)
    return heapq.merge(train, ft, key=lambda j: j.arrival)


def churn_schedule(nodes: Sequence, *, horizon: float,
                   churn_frac: float = 0.05, seed: int = 0,
                   mean_downtime: Optional[float] = None
                   ) -> List[ClusterEvent]:
    """Independent node churn (maintenance, failures): a ``churn_frac``
    fraction of the fleet each departs once, at a uniform time in the first
    80% of ``horizon``, and rejoins after an exponential downtime (default
    mean: 10% of the horizon).  Every departure is paired with a rejoin, so
    capacity always eventually returns and all jobs can finish."""
    rng = random.Random(400 + seed)
    n_churn = int(round(len(nodes) * churn_frac))
    if n_churn <= 0 or horizon <= 0:
        return []
    down = mean_downtime if mean_downtime is not None else horizon * 0.1
    events: List[ClusterEvent] = []
    for node in rng.sample(list(nodes), min(n_churn, len(nodes))):
        t_leave = rng.uniform(0.0, horizon * 0.8)
        t_join = t_leave + rng.expovariate(1.0 / down)
        events.append(ClusterEvent(time=t_leave, kind=NODE_LEAVE,
                                   node_id=node.node_id))
        events.append(ClusterEvent(time=t_join, kind=NODE_JOIN,
                                   node_id=node.node_id))
    events.sort(key=lambda e: (e.time, e.kind, e.node_id))
    return events


def churn_schedule_iter(nodes: Sequence, *, horizon: float,
                        churn_frac: float = 0.05, seed: int = 0,
                        mean_downtime: Optional[float] = None
                        ) -> Iterator[ClusterEvent]:
    """Streaming form of ``churn_schedule`` for the engine's iterator run
    path.  Churn is fleet-bounded (2 events per churned node), so the
    sorted list is materialized internally and yielded — memory scales
    with the fleet, never with the job count."""
    yield from churn_schedule(nodes, horizon=horizon,
                              churn_frac=churn_frac, seed=seed,
                              mean_downtime=mean_downtime)


def spot_schedule(nodes: Sequence, *, horizon: float, n_waves: int = 3,
                  wave_frac: float = 0.1, seed: int = 0,
                  mean_downtime: Optional[float] = None,
                  crash: bool = False) -> List[ClusterEvent]:
    """Spot-fleet reclamation (ShuntServe-style): the market reclaims
    correlated *waves* of nodes — each wave takes out ``wave_frac`` of the
    fleet at (almost) the same instant — and replacement capacity is
    provisioned back after an exponential delay per node.

    ``crash=True`` makes the reclaims *abrupt* ``node_fail`` events (no
    checkpoint on the way out — the failure plane's crash semantics)
    instead of graceful ``node_leave``; times, nodes, and rng draws are
    identical, only the event kind changes."""
    rng = random.Random(500 + seed)
    if horizon <= 0 or n_waves <= 0:
        return []
    down = mean_downtime if mean_downtime is not None else horizon * 0.15
    leave_kind = NODE_FAIL if crash else NODE_LEAVE
    pool = list(nodes)
    events: List[ClusterEvent] = []
    # process waves in time order so each wave reclaims only nodes that are
    # actually online at that instant (no overlapping leave/join pairs)
    wave_times = sorted(rng.uniform(horizon * 0.05, horizon * 0.8)
                        for _ in range(n_waves))
    offline_until: dict = {}
    for t_wave in wave_times:
        online = [n for n in pool
                  if offline_until.get(n.node_id, -1.0) <= t_wave]
        want = max(1, int(len(pool) * wave_frac))
        if not online:
            continue                        # whole fleet reclaimed: skip wave
        for node in rng.sample(online, min(want, len(online))):
            t_leave = t_wave + rng.uniform(0.0, 1.0)   # near-simultaneous
            t_join = t_leave + rng.expovariate(1.0 / down)
            offline_until[node.node_id] = t_join
            events.append(ClusterEvent(time=t_leave, kind=leave_kind,
                                       node_id=node.node_id))
            events.append(ClusterEvent(time=t_join, kind=NODE_JOIN,
                                       node_id=node.node_id))
    events.sort(key=lambda e: (e.time, e.kind, e.node_id))
    return events


def failure_schedule(nodes: Sequence, *, horizon: float, seed: int = 0,
                     mtbf_scale: float = 1.0,
                     mean_downtime: Optional[float] = None
                     ) -> List[ClusterEvent]:
    """Crash-fault injection from the device catalog: each node fails as a
    Poisson process with hazard ``devices / (mtbf_s * mtbf_scale)`` of its
    device type (``mtbf_scale < 1`` models a flakier fleet), is repaired
    after an exponential downtime (default mean: 5% of the horizon), and
    can fail again after rejoining.  Every ``node_fail`` is paired with a
    ``node_join``, so capacity always eventually returns.  List form of
    ``failure_schedule_iter`` (bit-identical)."""
    return list(failure_schedule_iter(nodes, horizon=horizon, seed=seed,
                                      mtbf_scale=mtbf_scale,
                                      mean_downtime=mean_downtime))


def failure_schedule_iter(nodes: Sequence, *, horizon: float, seed: int = 0,
                          mtbf_scale: float = 1.0,
                          mean_downtime: Optional[float] = None
                          ) -> Iterator[ClusterEvent]:
    """Streaming ``failure_schedule``: a heap of one pending event per
    node, so memory scales with the fleet while the event *count* scales
    with ``horizon / MTBF`` — a year-long trace never materializes.

    Streaming-rng discipline (the streaming contract): every exponential draw
    happens when its event is popped, in nondecreasing event-time order —
    the same order a list builder would draw in — so the list and iterator
    forms are bit-identical and downstream consumers can rely on
    ``_pull``'s time-ordering assertion."""
    rng = random.Random(900 + seed)
    if horizon <= 0:
        return
    down = mean_downtime if mean_downtime is not None else horizon * 0.05
    heap: List[tuple] = []
    for i, node in enumerate(nodes):
        dev = DEVICE_TYPES[node.device_type]
        node_mtbf = dev.mtbf_s * mtbf_scale / max(node.total, 1)
        t = rng.expovariate(1.0 / node_mtbf)
        if t < horizon:
            heapq.heappush(heap, (t, i, NODE_FAIL, node.node_id, node_mtbf))
    while heap:
        t, i, kind, node_id, node_mtbf = heapq.heappop(heap)
        yield ClusterEvent(time=t, kind=kind, node_id=node_id)
        if kind == NODE_FAIL:
            # repair: the node always comes back (possibly past horizon)
            t_join = t + rng.expovariate(1.0 / down)
            heapq.heappush(heap, (t_join, i, NODE_JOIN, node_id, node_mtbf))
        else:
            t_next = t + rng.expovariate(1.0 / node_mtbf)
            if t_next < horizon:
                heapq.heappush(heap,
                               (t_next, i, NODE_FAIL, node_id, node_mtbf))


def diurnal_rate_trace(*, horizon: float, base_rate: float,
                       peak_rate: float, period: Optional[float] = None,
                       n_points: int = 48, phase: float = 0.0
                       ) -> List[Tuple[float, float]]:
    """Smooth day/night request-rate curve (HAS-GPU-style diurnal load):
    a raised sinusoid between ``base_rate`` and ``peak_rate`` sampled at
    ``n_points`` piecewise-constant steps over ``horizon``.  ``period``
    defaults to the horizon (one day-cycle per run)."""
    period = period if period is not None else horizon
    mid = (base_rate + peak_rate) / 2.0
    amp = (peak_rate - base_rate) / 2.0
    out = []
    for i in range(n_points):
        t = horizon * i / n_points
        r = mid - amp * math.cos(2.0 * math.pi * (t / period) + phase)
        out.append((t, max(r, 0.0)))
    return out


def bursty_rate_trace(*, horizon: float, base_rate: float,
                      burst_rate: float, n_bursts: int = 4,
                      burst_len: Optional[float] = None, seed: int = 0
                      ) -> List[Tuple[float, float]]:
    """Flash-crowd request rate: ``base_rate`` background with
    ``n_bursts`` non-overlapping windows at ``burst_rate`` (each
    ``burst_len`` seconds, default 4% of the horizon) at deterministic
    uniform times — the trace a static-replica deployment must provision
    peak capacity for."""
    rng = random.Random(600 + seed)
    blen = burst_len if burst_len is not None else horizon * 0.04
    out = [(0.0, base_rate)]
    starts: List[float] = []
    for _ in range(n_bursts * 20):          # rejection-sample spacing
        if len(starts) >= n_bursts:
            break
        t = rng.uniform(horizon * 0.05, horizon * 0.9 - blen)
        if all(abs(t - s) > 2.0 * blen for s in starts):
            starts.append(t)
    for t in sorted(starts):
        out.append((t, burst_rate))
        out.append((t + blen, base_rate))
    return out


#: serve model pool: the small end of NewWorkload (interactive-sized).
SERVE_SIZES = ("gpt2-124m", "gpt2-350m", "gpt2-774m")


def serve_workload(n_jobs: int, device_types: Sequence[str], *,
                   horizon: float = 4 * 3600.0, seed: int = 0,
                   trace: str = "bursty", peak_mult: float = 6.0,
                   static: bool = False, disaggregated: bool = False,
                   start_id: int = 0
                   ) -> Tuple[List[SimJob], List[RateEvent]]:
    """Serve jobs + their request-rate traces for the co-scheduling sim.

    Each job is a continuous-batching replica group of a small model:
    ranked serve plans from ``predict_serve_plans_shared`` (zero=0), an
    SLO from ``default_serve_slo``, and a diurnal or bursty rate trace
    scaled to its single-replica capacity (base load ~1-2 replicas, peak
    ``peak_mult``x the base).  With ``static=True`` the jobs pin the
    replica count a static deployment would provision for the trace peak
    (``autoscale=False``) — the baseline arm of
    ``benchmarks/serve_autoscale.py``.  Traces are deterministic per
    seed and identical across the two arms.

    ``disaggregated=True`` marks every job for prefill/decode pool
    disaggregation: request shape (prompt length, decode budget) derives
    from the cache length *without consuming rng draws*, and the prefill
    pool gets its own ``role="prefill"`` plan ranking — so the unified
    and disaggregated arms see bit-identical jobs and rate traces."""
    jobs: List[SimJob] = []
    rate_events: List[RateEvent] = []
    for job, curve_events in serve_workload_iter(
            n_jobs, device_types, horizon=horizon, seed=seed, trace=trace,
            peak_mult=peak_mult, static=static,
            disaggregated=disaggregated, start_id=start_id):
        jobs.append(job)
        rate_events.extend(curve_events)
    return jobs, rate_events


def serve_workload_iter(n_jobs: int, device_types: Sequence[str], *,
                        horizon: float = 4 * 3600.0, seed: int = 0,
                        trace: str = "bursty", peak_mult: float = 6.0,
                        static: bool = False, disaggregated: bool = False,
                        start_id: int = 0
                        ) -> Iterator[Tuple[SimJob, List[RateEvent]]]:
    """Streaming form of ``serve_workload``: yields ``(job, rate_events)``
    pairs one job at a time, identical rng draw order.  A job's rate
    events span its whole serving horizon, so a globally time-sorted rate
    stream cannot be produced lazily — callers either collect the events
    (list mode sorts them) or keep the serve population small in streamed
    sims (rate memory is O(serve jobs), never O(total jobs)).
    ``start_id`` renumbers job/rate-event ids (rng draws unchanged) so
    serve traffic can join a merged multi-class trace."""
    rng = random.Random(700 + seed)
    jid = 0
    t = 0.0
    while jid < n_jobs:
        t += rng.expovariate(1.0 / max(horizon * 0.002, 1.0))
        cfg = GPT2_SIZES[rng.choice(SERVE_SIZES)]
        batch = rng.choice([8, 16, 32])
        cache_len = rng.choice([1024, 2048])
        plans = predict_serve_plans_shared(cfg, batch, cache_len,
                                           device_types=tuple(device_types),
                                           max_devices=64)
        if not plans:
            continue
        top = plans[0]
        replica_rate, step_s = serve_plan_capacity(cfg, top, batch,
                                                   cache_len)
        slo = default_serve_slo(cfg, top, batch, cache_len)
        base = replica_rate * rng.uniform(0.4, 0.9)
        peak = base * peak_mult
        if trace == "diurnal":
            curve = diurnal_rate_trace(horizon=horizon - t, base_rate=base,
                                       peak_rate=peak,
                                       phase=rng.uniform(0, 2 * math.pi))
        else:
            curve = bursty_rate_trace(horizon=horizon - t, base_rate=base,
                                      burst_rate=peak, seed=seed * 1000 + jid)
        job = SimJob(job_id=start_id + jid, arrival=t, cfg=cfg,
                     global_batch=batch, seq_len=cache_len,
                     total_samples=max(int(horizon - t), 1),
                     plans=plans, kind="serve", request_rate=curve[0][1],
                     slo_p95_s=slo)
        if disaggregated:
            job.disaggregated = True
            job.avg_prompt_len = cache_len // 2
            job.avg_new_tokens = max(cache_len // 4, 1)
            job.prefill_plans = predict_serve_plans_shared(
                cfg, batch, cache_len, device_types=tuple(device_types),
                max_devices=64, role="prefill")
        if static:
            job.autoscale = False
            job.static_replicas = replicas_for_slo(
                replica_rate, step_s, peak, slo,
                max_replicas=job.max_replicas)
        yield job, [RateEvent(time=t + off, job_id=start_id + jid,
                              rate=rate)
                    for off, rate in curve[1:]]
        jid += 1


def serve_stream(n_jobs: int, device_types: Sequence[str], *,
                 horizon: float = 4 * 3600.0, seed: int = 0,
                 trace: str = "bursty", peak_mult: float = 6.0,
                 static: bool = False, disaggregated: bool = False,
                 start_id: int = 0
                 ) -> Tuple[Iterator[SimJob], Iterator[RateEvent]]:
    """Paired lazy ``(jobs, rate_events)`` streams over one underlying
    ``serve_workload_iter`` — the streamed-run form of ``serve_workload``.

    The engine's iterator path needs each source in nondecreasing time
    order, but a job's rate curve spans its whole serving horizon, so the
    list form must materialize and sort every event.  Here the two streams
    share one generator: the rate stream keeps a heap keyed
    ``(time, job_id)`` and pulls jobs ahead (into a buffer the job stream
    drains) only until the earliest pending event is provably global-min —
    an unpulled job arrives at ``t >= last_arrival`` and its events start
    strictly after ``t``, so ``heap[0].time <= last_arrival`` is a safe
    emission bound.  Memory is O(live serve jobs' pending events + jobs
    pulled ahead), never O(total jobs), and rng draws happen in exactly
    the list builder's order, so both streams are bit-identical to the
    sorted list forms (streaming-rng discipline)."""
    source = serve_workload_iter(n_jobs, device_types, horizon=horizon,
                                 seed=seed, trace=trace,
                                 peak_mult=peak_mult, static=static,
                                 disaggregated=disaggregated,
                                 start_id=start_id)
    pending: deque = deque()                 # jobs pulled by the rate side
    heap: List[tuple] = []                   # (time, job_id, seq, event)
    state = {"done": False, "last_arrival": float("-inf"), "seq": 0}

    def pull() -> Optional[SimJob]:
        pair = next(source, None)
        if pair is None:
            state["done"] = True
            return None
        job, evs = pair
        state["last_arrival"] = job.arrival
        for e in evs:
            heapq.heappush(heap, (e.time, e.job_id, state["seq"], e))
            state["seq"] += 1
        return job

    def jobs_iter() -> Iterator[SimJob]:
        while True:
            if pending:
                yield pending.popleft()
                continue
            job = pull()
            if job is None:
                return
            yield job

    def rate_iter() -> Iterator[RateEvent]:
        while True:
            while not state["done"] and (
                    not heap or heap[0][0] > state["last_arrival"]):
                job = pull()
                if job is not None:
                    pending.append(job)
            if not heap:
                return
            yield heapq.heappop(heap)[3]

    return jobs_iter(), rate_iter()


def rate_events_iter(n_jobs: int, device_types: Sequence[str], *,
                     horizon: float = 4 * 3600.0, seed: int = 0,
                     trace: str = "bursty", peak_mult: float = 6.0,
                     static: bool = False, disaggregated: bool = False,
                     start_id: int = 0) -> Iterator[RateEvent]:
    """Globally time-ordered rate-event stream on its own: the rate half
    of ``serve_stream`` with the job half drained internally.  Useful when
    the serve jobs are materialized separately (rng is deterministic, so
    two passes see identical draws); ``list(rate_events_iter(...))`` is
    bit-identical to the list form's events sorted by ``(time, job_id)``
    — the order the engine's pre-push path uses.  Jobs are discarded as
    they are pulled (not buffered), so memory is just the event heap."""
    source = serve_workload_iter(n_jobs, device_types, horizon=horizon,
                                 seed=seed, trace=trace,
                                 peak_mult=peak_mult, static=static,
                                 disaggregated=disaggregated,
                                 start_id=start_id)
    heap: List[tuple] = []
    seq = 0
    last_arrival = float("-inf")
    done = False
    while True:
        while not done and (not heap or heap[0][0] > last_arrival):
            pair = next(source, None)
            if pair is None:
                done = True
                break
            job, evs = pair
            last_arrival = job.arrival
            for e in evs:
                heapq.heappush(heap, (e.time, e.job_id, seq, e))
                seq += 1
        if not heap:
            return
        yield heapq.heappop(heap)[3]


def misprediction_oracle(*, severity: float = 0.5, frac: float = 0.2,
                         mild: float = 0.05, seed: int = 0
                         ) -> Callable:
    """Memory-misprediction noise for the lifecycle engine's OOM path.

    Every job class ``(model, batch, seq, zero)`` gets a deterministic
    true-peak multiplier: with probability ``frac`` the class is badly
    mispredicted (multiplier ``1 + severity`` — the tail outside the
    paper's 92% accuracy), otherwise mildly noisy (uniform within
    ``1 ± mild``).  The multiplier is derived from a stable string seed,
    so identical traces see identical mispredictions across runs and
    across feedback-on/off arms.

    Returns an ``oom_check_fn(job, placements, pool)``: the true peak is
    ``plan.pred_bytes * multiplier``; if it exceeds the smallest per-device
    memory *budget* of the placement, the placement is doomed and the
    observed peak is returned (else None).  Budgets follow the pool's
    reservation semantics: a whole-device placement — legacy tuple or
    *exclusive* ``Grant`` — is judged against the node's physical device
    memory (the host owns the card; its declared ``nbytes`` only bounds
    the slack advertised to tenants, and a burst into unharvested slack
    is not an OOM), while a fractional slice ``Grant`` is a hard byte
    budget — colocated tenants OOM against their slice, not the card, so
    mispredictions stay honest under fractional-GPU packing.  Jobs
    admitted outside the HAS path (no ``job.plan``) are not modelled.
    """
    from repro_torch.core.has import Grant
    mults: Dict[Tuple, float] = {}

    def mult_for(job: SimJob) -> float:
        plan = job.plan
        key = (job.cfg.name, job.global_batch, job.seq_len, plan.zero)
        m = mults.get(key)
        if m is None:
            rng = random.Random(f"mispred|{seed}|{key!r}")
            if rng.random() < frac:
                m = 1.0 + severity
            else:
                m = rng.uniform(1.0 - mild, 1.0 + mild)
            mults[key] = m
        return m

    def check(job, placements, pool):
        if job.plan is None or job.cfg is None or not placements:
            return None
        true_peak = job.plan.pred_bytes * mult_for(job)
        def budget(p):
            if isinstance(p, Grant):
                return p.nbytes if not p.exclusive else pool.nodes[p.node_id].mem
            return pool.nodes[p[0]].mem

        mem = min(budget(p) for p in placements)
        return true_peak if true_peak > mem else None

    return check


def philly_like_iter(n_jobs: int, device_types: Sequence[str],
                     seed: int = 0) -> Iterator[SimJob]:
    """Streaming form of ``philly_like`` (identical rng draw order)."""
    rng = random.Random(100 + seed)
    pool = [GPT2_SIZES["gpt2-124m"], GPT2_SIZES["gpt2-350m"],
            GPT2_SIZES["gpt2-774m"], BERT_SIZES["bert-base"],
            BERT_SIZES["bert-large"]]
    t, jid = 0.0, 0
    while jid < n_jobs:
        t += rng.expovariate(1.0 / 60.0)
        cfg = rng.choice(pool)
        batch = rng.choice([4, 8, 16, 32])
        seq = rng.choice([128, 512, 1024])
        job = _mk_job(rng, jid, t, cfg, batch, seq, 1, device_types)
        if job is None:
            continue
        minutes = rng.lognormvariate(math.log(15), 1.2)
        job.total_samples = max(int(minutes * 60 * 4), 1)
        yield job
        jid += 1


def philly_like(n_jobs: int, device_types: Sequence[str], seed: int = 0
                ) -> List[SimJob]:
    """Philly [ATC'19]: mostly small (1-4 GPU) short jobs, heavy tail."""
    return list(philly_like_iter(n_jobs, device_types, seed))


def helios_like_iter(n_jobs: int, device_types: Sequence[str],
                     seed: int = 0) -> Iterator[SimJob]:
    """Streaming form of ``helios_like`` (identical rng draw order)."""
    rng = random.Random(200 + seed)
    pool = [GPT2_SIZES["gpt2-774m"], GPT2_SIZES["gpt2-1.5b"],
            GPT2_SIZES["gpt2-2.7b"], GPT2_SIZES["gpt2-7b"]]
    t, jid = 0.0, 0
    while jid < n_jobs:
        t += rng.expovariate(1.0 / 300.0)
        cfg = rng.choice(pool)
        batch = rng.choice([16, 32, 64, 128])
        seq = rng.choice([1024, 2048])
        job = _mk_job(rng, jid, t, cfg, batch, seq, 1, device_types)
        if job is None:
            continue
        hours = rng.lognormvariate(math.log(2.0), 1.0)
        job.total_samples = max(int(hours * 3600 * 1.0), 1)
        yield job
        jid += 1


def helios_like(n_jobs: int, device_types: Sequence[str], seed: int = 0
                ) -> List[SimJob]:
    """Helios [SC'21]: larger GPU demands, longer runtimes than Philly."""
    return list(helios_like_iter(n_jobs, device_types, seed))
