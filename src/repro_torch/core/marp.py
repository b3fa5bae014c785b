"""MARP — Memory-Aware Resource Predictor (paper §IV-A, Fig 2).

The port's copy of the JAX package's ``repro.core.marp``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).

For a submitted training job, MARP sweeps (data-parallel d, tensor-parallel t)
combinations, predicts peak per-device memory for each device type, keeps the
feasible combinations, and emits a **priority-ranked** list of resource plans
``Plan(n_devices, min_mem, d, t, ...)``.  HAS consumes the ranked list.

Ranking (paper: "plans at the forefront indicate higher training efficiency"):
we score each plan with a simple throughput/cost model — fewer devices is
cheaper, lower tensor-parallel degree means less blocking collective traffic,
and plans that fit in one node avoid cross-node links.  The score is
estimated-samples/sec divided by devices used (goodput per card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace
from repro_torch.core import reliability
from repro_torch.core.devices import DEVICE_TYPES, DeviceType


@dataclass(frozen=True)
class ResourcePlan:
    """Job(n, s) of the paper, plus the parallelism that produced it."""
    n_devices: int
    min_mem: int                  # bytes each device must have
    d: int                        # data parallel degree
    t: int                        # tensor parallel degree
    device_type: str              # type the memory estimate assumed
    pred_bytes: float             # predicted peak bytes/device
    score: float                  # ranking key (higher = better)
    zero: int = 1
    #: per-device byte budget for fractional-GPU packing: the
    #: memtrace-corrected peak *without* the allocator-headroom margin —
    #: the slice a colocated replica reserves on a shared device.  Sized
    #: identically to ``min_mem`` (corrected peak / margin + 1) so the
    #: no-repeat-OOM invariant of the memory feedback plane carries over
    #: to slices; ``pred_bytes`` stays the raw model output (memtrace
    #: contract).  0 on hand-built plans means "whole device only".
    #: Derived metadata, excluded from plan identity so seed-equivalence
    #: comparisons against pre-slicing plan tuples still hold.
    slice_bytes: int = field(default=0, compare=False)

    @property
    def min_mem_gb(self) -> float:
        return self.min_mem / (1024 ** 3)


#: The seed's static headroom for allocator fragmentation.  With the
#: memory feedback plane enabled (``core.memtrace``), both plan sweeps use
#: the per-(family, zero, device_type) adaptive margin instead; with it
#: disabled, ``memtrace.margin_for`` returns exactly this constant and the
#: rankings are bit-identical to the seed.
MEM_SAFETY = memtrace.BASE_MARGIN


def _tp_efficiency(t: int, dev: DeviceType) -> float:
    """Tensor parallelism serialises two all-reduces per layer — efficiency
    falls with t and with slower links."""
    if t == 1:
        return 1.0
    link_scale = dev.link_bw / 600e9  # normalised to NVLink A100
    return 1.0 / (1.0 + 0.08 * (t - 1) / max(link_scale, 0.1))


def _dp_efficiency(d: int) -> float:
    """Gradient all-reduce + input-pipeline scaling losses."""
    return 1.0 / (1.0 + 0.06 * math.log2(max(d, 1)) ** 1.5)


def plan_throughput_score(cfg: ModelConfig, dev: DeviceType, d: int, t: int,
                          global_batch: int, seq: int, *,
                          mfu: Optional[float] = None) -> float:
    """Estimated job samples/s — the paper ranks plans by training
    efficiency, so the fastest feasible plan sits at the forefront; under
    contention HAS naturally falls through to the smaller ones.

    ``mfu`` defaults to the calibration table (measured / roofline per
    (device_type, family) — ``core.calibration``); with calibration off
    that is the seed's 45% constant, keeping the ranking golden-identical.
    """
    n_active = _active_analytic(cfg)
    flops_per_sample = 6.0 * n_active * seq
    if mfu is None:
        mfu = calibration.mfu_for(cfg.family, dev.name)
    eff = mfu * _tp_efficiency(t, dev) * _dp_efficiency(d)
    total = dev.flops * eff * d * t
    # Contention-aware efficiency ranking: nearly goodput-per-card (beta=0.9)
    # so the forefront plans are efficient under load, while ties still break
    # toward more parallelism.  Calibrated in EXPERIMENTS.md §Scheduling.
    return total / flops_per_sample / ((d * t) ** 0.9)


@lru_cache(maxsize=4096)
def _active_analytic(cfg: ModelConfig) -> int:
    total = mm.analytic_param_count(cfg)
    if not cfg.num_experts:
        return total
    nm = 3 if cfg.mlp_variant == "swiglu" else 2
    n_moe = mm.moe_layer_count(cfg)
    per_e = cfg.d_model * cfg.moe_d_ff * nm
    return total - n_moe * per_e * (cfg.num_experts - cfg.top_k)


def predict_plans(cfg: ModelConfig, global_batch: int, seq: int, *,
                  device_types: Optional[Sequence[str]] = None,
                  max_devices: int = 512,
                  zero: int = 1,
                  mode: str = "exact",
                  max_t: int = 64,
                  lora_rank: int = 0) -> List[ResourcePlan]:
    """Enumerate (d, t) plans, keep feasible ones, rank by score (desc).

    mode='paper' uses the paper's GPT formulas verbatim; mode='exact' uses the
    generalised per-family model (DESIGN.md §4).

    ``lora_rank > 0`` prices a LoRA finetune instead of full training
    (``memory_model.lora_peak_bytes``: frozen bf16 base + adapter-only
    train state) — much smaller peaks, so the plans' ``slice_bytes``
    fit the slack of colocated train jobs.  The default 0 is bit-identical
    to the pre-LoRA sweep.

    The sweep is memoized on ``(cfg, batch, seq, device_types, zero, mode,
    max_devices, max_t, calibration.cache_token(),
    memtrace.cache_token())`` — trace workloads draw from a handful of
    model configs, so in the scheduling hot path this is almost always a
    cache hit.  The calibration token invalidates cached rankings whenever
    the MFU table is (re-)enabled, the memtrace token whenever the memory
    feedback plane ingests an observation or is (re-)enabled, and the
    reliability token whenever reliability-aware planning is (re-)enabled;
    with all three off the tokens are constant and the ranking is
    the seed's.
    ``ResourcePlan`` is frozen, so cached plans are shared safely; the list
    itself is fresh per call so callers may sort/slice it.
    """
    dts = tuple(device_types) if device_types else tuple(DEVICE_TYPES)
    return list(_predict_plans_cached(cfg, global_batch, seq, dts,
                                      max_devices, zero, mode, max_t,
                                      calibration.cache_token(),
                                      memtrace.cache_token(),
                                      reliability.cache_token(),
                                      lora_rank))


def predict_plans_shared(cfg: ModelConfig, global_batch: int, seq: int, *,
                         device_types: Optional[Sequence[str]] = None,
                         max_devices: int = 512,
                         zero: int = 1,
                         mode: str = "exact",
                         max_t: int = 64,
                         lora_rank: int = 0) -> Tuple[ResourcePlan, ...]:
    """``predict_plans`` returning the memoized tuple itself (immutable, so
    sharing is safe).  Identical inputs yield the *same object*, which lets
    schedulers dedupe repeated no-fit checks across jobs by plan-list
    identity — the workload-generation path for the simulator uses this."""
    dts = tuple(device_types) if device_types else tuple(DEVICE_TYPES)
    return _predict_plans_cached(cfg, global_batch, seq, dts,
                                 max_devices, zero, mode, max_t,
                                 calibration.cache_token(),
                                 memtrace.cache_token(),
                                 reliability.cache_token(),
                                 lora_rank)


@lru_cache(maxsize=4096)
def _predict_plans_cached(cfg: ModelConfig, global_batch: int, seq: int,
                          device_types: Tuple[str, ...], max_devices: int,
                          zero: int, mode: str, max_t: int,
                          cal_token: Tuple = ("off",),
                          mem_token: Tuple = ("off",),
                          rel_token: Tuple = ("off",),
                          lora_rank: int = 0
                          ) -> Tuple[ResourcePlan, ...]:
    plans: List[ResourcePlan] = []
    d_candidates = [x for x in _pow2_divisors(global_batch) if x <= max_devices]
    family = cfg.family
    for dt_name in device_types:
        dev = DEVICE_TYPES[dt_name]
        # adaptive per-class margin; exactly MEM_SAFETY with feedback off
        margin = memtrace.margin_for(family, zero, dt_name)
        cap = dev.mem * margin
        for d in d_candidates:
            t = 1
            while t <= max_t and d * t <= max_devices:
                if mode == "paper":
                    pred = mm.paper_peak_bytes(cfg, global_batch, seq, d, t)
                elif lora_rank > 0:
                    pred = mm.lora_peak_bytes(cfg, global_batch, seq, d, t,
                                              rank=lora_rank, zero=zero)
                else:
                    pred = mm.exact_peak_bytes(cfg, global_batch, seq, d, t,
                                               zero=zero)
                # residual-corrected prediction gates feasibility and sizes
                # min_mem; ``pred_bytes`` keeps the raw model output so OOM
                # post-mortems can compute observed/predicted residuals
                adj = memtrace.corrected_bytes(family, zero, dt_name, pred)
                if adj < cap:
                    score = plan_throughput_score(cfg, dev, d, t,
                                                  global_batch, seq)
                    if reliability.is_enabled():
                        # price the failure plane: a big plan on flaky
                        # hardware loses durable goodput to rollbacks and
                        # checkpoint stalls, and can rank below a smaller
                        # or more reliable one
                        score *= reliability.expected_goodput(
                            cfg, dt_name, d * t, lora_rank=lora_rank)
                    plans.append(ResourcePlan(
                        n_devices=d * t, min_mem=int(adj / margin) + 1,
                        d=d, t=t, device_type=dt_name, pred_bytes=pred,
                        score=score, zero=zero,
                        slice_bytes=int(adj / margin) + 1))
                    break          # larger t only wastes devices for this d
                t *= 2
    plans.sort(key=lambda p: (-p.score, p.n_devices, p.t))
    return tuple(plans)


def _pow2_divisors(n: int) -> List[int]:
    out = [1]
    while out[-1] * 2 <= n and n % (out[-1] * 2) == 0:
        out.append(out[-1] * 2)
    return out


def required_devices(cfg: ModelConfig, global_batch: int, seq: int,
                     device_type: str = "v5e", **kw) -> Optional[ResourcePlan]:
    """The serverless entry point: 'how many cards of this type do I need?'"""
    plans = predict_plans(cfg, global_batch, seq,
                          device_types=[device_type], **kw)
    return plans[0] if plans else None


# --------------------------------------------------------------- serving ---
# Beyond-paper: the paper covers training only; the same memory-aware plan
# machinery applies to serving (bf16 weights + KV/SSM cache instead of the
# 20 B/param optimizer state).  The rate model here is shared with the SLO
# autoscaler in ``core.lifecycle``: one replica of a plan decodes at
# ``serve_plan_rate`` tokens/s in steps of ``serve_step_seconds``, and the
# p95 token latency of a replica group follows the M/M/1-style queueing
# approximation in ``p95_token_latency``.

#: p95/mean ratio of the token time-in-system under the exponential
#: service approximation (ln 20 ~ 3.0): p95 ~ 3 x the mean residence.
P95_FACTOR = 3.0

#: Default utilisation target behind ``default_serve_slo``: the SLO is set
#: so one replica meets p95 at 70% load.
SLO_DEFAULT_UTIL = 0.7


def _serve_rate(cfg: ModelConfig, dev: DeviceType, batch: int,
                step_bytes: float, t: int) -> float:
    """Decode tokens/s of one (d, t) replica: each step streams the weight
    slice (2W/t) once per device plus that device's KV/SSM cache slice,
    and the d*t devices jointly emit ``batch`` tokens — so tokens/s ~
    batch * decode bandwidth / (weight slice + cache slice).  The
    bandwidth comes from ``calibration.decode_bw_for`` (raw peak HBM
    bandwidth when the decode table is off — the seed expression,
    bit-identical)."""
    bw = calibration.decode_bw_for(cfg.family, dev.name)
    return batch * bw / max(step_bytes, 1.0) * _tp_efficiency(t, dev)


def _prefill_rate(cfg: ModelConfig, dev: DeviceType, d: int, t: int) -> float:
    """Prompt tokens/s of one (d, t) replica during prefill.  Prefill is
    compute-bound (a full forward over the prompt: ~2 flops per active
    param per token), so the rate follows the calibrated MFU and parallel
    efficiencies rather than the HBM stream that governs decode."""
    mfu = calibration.mfu_for(cfg.family, dev.name)
    eff = mfu * _tp_efficiency(t, dev) * _dp_efficiency(d)
    return dev.flops * eff * d * t / (2.0 * _active_analytic(cfg))


def prefill_service_seconds(cfg: ModelConfig, plan: ResourcePlan,
                            prompt_len: float, *,
                            handoff_bandwidth: float = 16 * 2 ** 30
                            ) -> float:
    """Seconds one replica of a prefill-pool ``plan`` spends per request:
    the forward pass over the prompt **plus** the priced KV-cache handoff
    to the decode pool (``ckpt.checkpoint.kv_handoff_seconds`` — the
    ``migration_seconds`` cost-model pattern), so MARP charges the
    disaggregation transfer honestly instead of treating it as free."""
    from repro_torch.ckpt.checkpoint import kv_handoff_seconds
    dev = DEVICE_TYPES[plan.device_type]
    rate = _prefill_rate(cfg, dev, plan.d, plan.t)
    return (prompt_len / max(rate, 1e-9)
            + kv_handoff_seconds(cfg, 1, int(math.ceil(prompt_len)),
                                 handoff_bandwidth))


def prefill_pool_target(cfg: ModelConfig, plan: ResourcePlan,
                        request_rate_tok_s: float, avg_prompt_len: float,
                        avg_new_tokens: float, slo_ttft_s: float, *,
                        max_replicas: int = 64,
                        handoff_bandwidth: float = 16 * 2 ** 30) -> int:
    """Prefill-pool size for a disaggregated serve job: demand is the
    request *arrival* rate times the prompt length (the decode token rate
    divided by tokens-per-request gives arrivals), service time is one
    prompt forward plus the KV handoff, and the same
    ``replicas_for_slo`` inversion sizes the pool against the
    time-to-first-token SLO."""
    service_s = prefill_service_seconds(cfg, plan, avg_prompt_len,
                                        handoff_bandwidth=handoff_bandwidth)
    req_s = request_rate_tok_s / max(avg_new_tokens, 1.0)
    return replicas_for_slo(1.0 / max(service_s, 1e-9), service_s, req_s,
                            slo_ttft_s, max_replicas=max_replicas)


def default_ttft_slo(cfg: ModelConfig, plan: ResourcePlan,
                     avg_prompt_len: float, *,
                     handoff_bandwidth: float = 16 * 2 ** 30) -> float:
    """TTFT p95 target one prefill replica meets at ``SLO_DEFAULT_UTIL``
    load — the disaggregated analog of ``default_serve_slo``."""
    service_s = prefill_service_seconds(cfg, plan, avg_prompt_len,
                                        handoff_bandwidth=handoff_bandwidth)
    return P95_FACTOR * service_s / (1.0 - SLO_DEFAULT_UTIL)


def serve_plan_capacity(cfg: ModelConfig, plan: ResourcePlan, batch: int,
                        cache_len: int) -> Tuple[float, float]:
    """(tokens/s, step seconds) one replica of ``plan`` attains — the
    per-replica decode capacity the SLO autoscaler divides demand by."""
    dev = DEVICE_TYPES[plan.device_type]
    wbytes, cache, _ = mm.serve_bytes_split(cfg, batch, cache_len,
                                            plan.d, plan.t)
    rate = _serve_rate(cfg, dev, batch, wbytes + cache, plan.t)
    return rate, batch / max(rate, 1e-12)


def p95_token_latency(capacity_tok_s: float, demand_tok_s: float,
                      step_seconds: float) -> float:
    """p95 token time-in-system of a replica group with aggregate capacity
    ``capacity_tok_s`` under ``demand_tok_s`` load: the M/M/1-style
    ``P95_FACTOR * step / (1 - rho)`` blow-up, infinite at/over
    saturation."""
    if capacity_tok_s <= 0.0:
        return float("inf")
    rho = demand_tok_s / capacity_tok_s
    if rho >= 1.0:
        return float("inf")
    return P95_FACTOR * step_seconds / (1.0 - rho)


def replicas_for_slo(replica_rate: float, step_seconds: float,
                     demand_tok_s: float, slo_p95_s: float, *,
                     max_replicas: int = 64) -> int:
    """Fewest replicas whose pooled capacity meets the p95 SLO at
    ``demand_tok_s`` — the autoscaler's target.  Inverts
    ``p95_token_latency``: p95 <= slo iff utilisation <= 1 - F*step/slo,
    so n >= demand / (rate * that cap).  Never below 1 (an idle service
    keeps a warm replica); ``max_replicas`` bounds an unattainable SLO."""
    if demand_tok_s <= 0.0 or replica_rate <= 0.0:
        return 1
    if slo_p95_s <= 0.0:
        return max_replicas
    util_cap = 1.0 - P95_FACTOR * step_seconds / slo_p95_s
    if util_cap <= 0.0:
        return max_replicas       # SLO tighter than one bare step: saturate
    need = math.ceil(demand_tok_s / (replica_rate * util_cap) - 1e-9)
    return max(1, min(int(need), max_replicas))


def default_serve_slo(cfg: ModelConfig, plan: ResourcePlan, batch: int,
                      cache_len: int) -> float:
    """A p95 target one replica meets at ``SLO_DEFAULT_UTIL`` load — the
    serverless default when the user names no SLO."""
    _, step_s = serve_plan_capacity(cfg, plan, batch, cache_len)
    return P95_FACTOR * step_s / (1.0 - SLO_DEFAULT_UTIL)


def predict_serve_plans(cfg: ModelConfig, batch: int, cache_len: int, *,
                        device_types: Optional[Sequence[str]] = None,
                        max_devices: int = 512,
                        max_t: int = 64,
                        role: str = "decode") -> List[ResourcePlan]:
    """Enumerate (d, t) plans for batched decoding: d shards the request
    batch, t the weights.  Ranked by decode throughput per plan (decode is
    HBM-bound: rate ~ aggregate HBM bandwidth / bytes touched per token —
    ``_serve_rate``, shared with the SLO autoscaler).

    The memory feedback plane applies here too (serving state is zero=0):
    feasibility and ``min_mem`` use the residual-corrected prediction and
    the adaptive margin; with it (and the decode-bandwidth table) disabled
    this is the seed sweep, bit-identical."""
    dts = tuple(device_types) if device_types else tuple(DEVICE_TYPES)
    return list(_predict_serve_plans_cached(cfg, batch, cache_len, dts,
                                            max_devices, max_t,
                                            calibration.cache_token(),
                                            memtrace.cache_token(), role))


def predict_serve_plans_shared(cfg: ModelConfig, batch: int, cache_len: int,
                               *, device_types: Optional[Sequence[str]] = None,
                               max_devices: int = 512, max_t: int = 64,
                               role: str = "decode"
                               ) -> Tuple[ResourcePlan, ...]:
    """``predict_serve_plans`` returning the memoized tuple itself —
    identical inputs yield the *same object* (the serve analog of
    ``predict_plans_shared``), so schedulers can dedupe no-fit checks
    across serve jobs by plan-list identity."""
    dts = tuple(device_types) if device_types else tuple(DEVICE_TYPES)
    return _predict_serve_plans_cached(cfg, batch, cache_len, dts,
                                       max_devices, max_t,
                                       calibration.cache_token(),
                                       memtrace.cache_token(), role)


@lru_cache(maxsize=4096)
def _predict_serve_plans_cached(cfg: ModelConfig, batch: int, cache_len: int,
                                device_types: Tuple[str, ...],
                                max_devices: int, max_t: int,
                                cal_token: Tuple = ("off",),
                                mem_token: Tuple = ("off",),
                                role: str = "decode"
                                ) -> Tuple[ResourcePlan, ...]:
    # role axis (disaggregated serving): "decode" ranks by the HBM-bound
    # decode stream (the seed sweep, bit-identical); "prefill" ranks the
    # same feasible (d, t) grid by compute-bound prompt tokens/s.  Memory
    # feasibility is shared — a prefill replica holds the same weights and
    # writes the same cache rows it hands off.
    assert role in ("decode", "prefill"), role
    plans: List[ResourcePlan] = []
    d_candidates = [x for x in _pow2_divisors(batch) if x <= max_devices]
    family = cfg.family
    for dt_name in device_types:
        dev = DEVICE_TYPES[dt_name]
        margin = memtrace.margin_for(family, 0, dt_name)
        cap = dev.mem * margin
        for d in d_candidates:
            t = 1
            while t <= max_t and d * t <= max_devices:
                wbytes, cache, work = mm.serve_bytes_split(cfg, batch,
                                                           cache_len, d, t)
                pred = wbytes + cache + work
                adj = memtrace.corrected_bytes(family, 0, dt_name, pred)
                if adj < cap:
                    rate = (_serve_rate(cfg, dev, batch, wbytes + cache, t)
                            if role == "decode"
                            else _prefill_rate(cfg, dev, d, t))
                    plans.append(ResourcePlan(
                        n_devices=d * t, min_mem=int(adj / margin) + 1,
                        d=d, t=t, device_type=dt_name, pred_bytes=pred,
                        score=rate / ((d * t) ** 0.9), zero=0,
                        slice_bytes=int(adj / margin) + 1))
                    break
                t *= 2
    plans.sort(key=lambda p: (-p.score, p.n_devices, p.t))
    return tuple(plans)
