"""Fig 6 on the card: MARP's peak-memory prediction against the peak of one
rank of the plan, measured.

    PYTHONPATH=src python -m repro_torch.launch.memcheck --zero 1
    PYTHONPATH=src python -m repro_torch.launch.memcheck --arch stablelm-12b \
        --batch 16 --seq 4096 --d 16 --t 16 --zero 1 --rank 15
    PYTHONPATH=src python -m repro_torch.launch.memcheck --arch llama3.2-3b \
        --batch 32 --seq 4096 --pods 2 --d 16 --t 16 --zero 1
    PYTHONPATH=src python -m repro_torch.launch.memcheck --arch llama3.2-3b \
        --shape decode_32k --d 16 --t 16 --rank 0

For GPT2-350M / GPT2-7B (the paper's models) under the JAX package's
(d, t) plans and batch sizes (``COMBOS``), each row runs rank 0 of the
(d, t) plan in this one process, under PyTorch's fake process group: its
collectives return without communicating, while every shard, gathered
buffer and activation of the rank is a real CUDA allocation.  Rank 0's
local state is drawn on the card one shard at a time, at the shard's own
shape (``make_local_state(whole_leaves=False)``: the whole gpt2-7b state
is ~140 GB, one stacked expert leaf of deepseek-v2-236b 151 GB; the
values, which the fake group makes meaningless anyway, are not the
one-device state's), the rank's rows of the global batch are fed to the
card (``step.rows``; the modal embeddings at the compute dtype), the peak
statistics are reset, one sharded train step runs
(``train.build_train_step(..., mesh=)``), and the caching allocator's
peak over that step is the row's actual (with whatever the process held
before the state, ``base_bytes``: cuBLAS's workspace once an earlier step
made it, as a run of its own makes it in its step).  Each row carries
``core.memory_model``'s exact and paper predictions, both accuracies
(``1 - |pred - actual| / actual``) and the card's name and power limit,
and records the sample to ``core.memtrace`` (source "memcheck").  The
values the fake group leaves in gathered buffers mean nothing (losses may
be NaN): only the allocator's peak is read.
NCCL's own buffers lie outside the caching allocator, so the actual
counts none, as a real run's would not either.

With ``--shape prefill_32k|decode_32k|long_500k`` (and ``--arch``) it
runs rank ``--rank`` of that serving plan instead (``run_serve``): the
rank's serving weights drawn at their shards' shapes (over the data axes
too where ``launch.inputs.serve_weights_over_data`` says so), then one
prefill of its rows with the caches left at ``prefill_cache_specs``'
shards, or one decode step at position cache_len - 1 (every slot valid:
the decode kernel reads the whole cache) on a cache at ``cache_specs``'
shards, and prints the peak over it beside ``serve_peak_bytes(cfg, B,
cache_len, d, t)`` (ZeRO 3's weight term where the weights split over
data), with the card's name and power limit.

With ``--arch`` it runs that one plan, as rank ``--rank`` (default 0), and
prints its row (a plan on the head_dim / seq fallback runs each rank's
sequence rows at its own query offset; rank t - 1 has the largest);
``--pods`` > 1 puts a "pod" axis before the data axis, (pods, d, t), and
the memory model sees pods x d data shards, as MARP's plan does.
Otherwise rows go to ``experiments/memcheck_torch/memcheck_zero{Z}.json``.  The
JAX package's measurement (XLA's compile-time accounting on placeholder
CPU devices) lives in ``experiments/memcheck/`` and is not this one.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace
from repro_torch.data import SyntheticTokens
from repro_torch.launch.inputs import params_inputs
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.launch.train import compute_dtype, to_device
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import (build_train_step, make_local_state,
                                          state_specs)

DEFAULT_OUT = os.path.join(os.path.dirname(__file__),
                           "../../../experiments/memcheck_torch")

# (arch, global_batch, seq, d, t) -- the paper sweeps batch sizes and (d, t)
COMBOS = [
    ("gpt2-350m", 8, 1024, 1, 1),
    ("gpt2-350m", 8, 1024, 2, 1),
    ("gpt2-350m", 8, 1024, 4, 1),
    ("gpt2-350m", 16, 1024, 4, 2),
    ("gpt2-350m", 16, 1024, 2, 4),
    ("gpt2-7b", 2, 1024, 1, 4),
    ("gpt2-7b", 2, 1024, 2, 4),
    ("gpt2-7b", 2, 1024, 2, 8),
    ("gpt2-7b", 4, 1024, 4, 4),
    ("gpt2-7b", 8, 1024, 8, 2),
]


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Rank ``rank`` of a process group of ``world_size`` ranks whose
    collectives do not communicate (torch's fake backend), for the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_state_bytes(cfg: ModelConfig, tc: TrainConfig, mesh) -> int:
    """Bytes of one rank's state by the specs: its params (in their
    dtypes) and its fp32 master, m and v."""
    params, _ = params_inputs(cfg, mesh)
    specs = state_specs(cfg, tc, mesh, params)
    return sum(p.element_size() * math.prod(col.local_shape(p.shape, ps, mesh))
               + 3 * 4 * math.prod(col.local_shape(p.shape, os_, mesh))
               for p, ps, os_ in zip(tree_leaves(params),
                                     tree_leaves(specs["params"]),
                                     tree_leaves(specs["opt"]["master"])))


def storage_bytes(state: Dict[str, Any]) -> int:
    """Bytes of the distinct storages the state's tensors hold (a shard
    that were a view of a whole leaf would count the leaf)."""
    seen = {}
    for part in (state["params"], state["opt"]):
        for t in tree_leaves(part):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"device": name, "power_limit": limit}


def run_one(arch: str, batch: int, seq: int, d: int, t: int, zero: int = 0, *,
            cfg: Optional[ModelConfig] = None, device="cuda",
            smi: Optional[Dict[str, str]] = None,
            rank: int = 0, pods: int = 1) -> Dict[str, Any]:
    """One combo as rank ``rank`` (default 0) of its (d, t) plan on the
    card, or of its (pods, d, t) plan with a "pod" axis when ``pods`` > 1
    (the row's d is then pods x d); ``cfg`` in place of ``get_arch(arch)``
    (a smoke config, or a cut one).  Raises off CUDA: the actual is the
    card's allocator's, and there is no CPU stand-in for it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"memcheck measures the CUDA caching allocator's "
                         f"peak; {device} has none")
    cfg = cfg or get_arch(arch)
    tc = TrainConfig(global_batch=batch, seq_len=seq, microbatch=1, zero=zero)
    # what an earlier caller left in reference cycles is freed before the
    # base is read
    gc.collect()
    with fake_world(pods * d * t, rank):
        mesh = make_plan_mesh(d, t, device_type="cuda", pods=pods)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        state = make_local_state(cfg, tc, mesh, device=device,
                                 whole_leaves=False)
        want = local_state_bytes(cfg, tc, mesh)
        held = storage_bytes(state)
        grown = torch.cuda.memory_allocated(device) - base
        n_tensors = 4 * len(tree_leaves(state["params"]))
        # the allocator rounds each block up to 512 bytes
        if held != want or not want <= grown <= want + 512 * n_tensors:
            raise RuntimeError(
                f"{arch} d={d} t={t} zero={zero}: rank {rank}'s state holds {held}"
                f" B ({grown} B allocated), its specs' shards {want} B")
        step, _ = build_train_step(cfg, tc, batch, seq, mesh=mesh)
        data = to_device(next(SyntheticTokens(cfg, batch, seq, seed=tc.seed,
                                              rows=step.rows)),
                         device, compute_dtype(state))
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        step(state, data)
        torch.cuda.synchronize(device)
        actual = torch.cuda.max_memory_allocated(device)
        del state, data, step
    d *= pods
    pred_exact = mm.exact_peak_bytes(cfg, batch, seq, d, t, zero=zero,
                                     microbatch=1)
    pred_paper = mm.paper_peak_bytes(cfg, batch, seq, d, t)
    smi = smi or card()
    memtrace.record(cfg.family, zero, memtrace.device_type_for(smi["device"]),
                    pred_exact, actual, source="memcheck")
    return {"arch": arch, "batch": batch, "seq": seq, "pods": pods, "d": d,
            "t": t,
            "zero": zero, "rank": rank, "actual_bytes": int(actual),
            "state_bytes": int(want), "base_bytes": int(base),
            "pred_exact": pred_exact, "pred_paper": pred_paper,
            "acc_exact": round(1 - abs(pred_exact - actual) / actual, 4),
            "acc_paper": round(1 - abs(pred_paper - actual) / actual, 4),
            **smi}


def run_serve(arch: str, shape_name: str, d: int, t: int, *,
              cfg: Optional[ModelConfig] = None, device="cuda",
              smi: Optional[Dict[str, str]] = None, rank: int = 0,
              pods: int = 1, seed: int = 0,
              batch: Optional[int] = None) -> Dict[str, Any]:
    """Rank ``rank`` of the serving plan of ``shape_name`` (prefill_32k,
    decode_32k or long_500k) on the (d, t) mesh, or (pods, d, t) with a
    "pod" axis, under the fake process group on the card: one prefill or
    one decode step (see the module docstring), its peak beside
    ``serve_peak_bytes``.  ``batch``: a global batch in place of the
    shape's.  Raises off CUDA, as ``run_one`` does."""
    from repro_torch.configs.registry import get_shape
    from repro_torch.launch.inputs import serve_weights_over_data
    from repro_torch.models import init_cache
    from repro_torch.serve import (local_serve_params, prefill,
                                   serve_parallel, serve_step)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"memcheck measures the CUDA caching allocator's "
                         f"peak; {device} has none")
    cfg = cfg or get_arch(arch)
    shape = get_shape(shape_name)
    B = batch or shape.global_batch
    cache_len = shape.cache_len or shape.seq_len
    nd = pods * d
    b = B // nd if B % nd == 0 else B
    gc.collect()
    with fake_world(pods * d * t, rank):
        mesh = make_plan_mesh(d, t, device_type="cuda", pods=pods)
        zero_data = shape.kind == "decode" and serve_weights_over_data(
            cfg, mesh)
        par = serve_parallel(cfg, mesh, B, cache_len, zero_data=zero_data)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        params = local_serve_params(cfg, seed, mesh, zero_data=zero_data,
                                    device=device)
        weights = torch.cuda.memory_allocated(device) - base
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        if shape.kind == "prefill":
            tokens = torch.randint(0, cfg.vocab_size, (
                b, shape.seq_len - cfg.num_modal_tokens), generator=gen,
                device=device)
            batch = {"tokens": tokens}
            if cfg.num_modal_tokens:
                batch["modal_embeds"] = torch.zeros(
                    (b, cfg.num_modal_tokens, cfg.d_model),
                    dtype=torch.bfloat16, device=device)
            logits, cache = prefill(cfg, params, batch, cache_len, par)
        else:
            cache = init_cache(cfg, B, cache_len, device=device, par=par)
            tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                                   device=device)
            logits, cache = serve_step(cfg, params, tokens, cache,
                                       cache_len - 1, par)
        torch.cuda.synchronize(device)
        actual = torch.cuda.max_memory_allocated(device)
        cache_bytes = sum(x.numel() * x.element_size()
                          for sub in cache.values() for x in sub.values())
        logits_shape = tuple(logits.shape)
        finite = bool(torch.isfinite(logits).all())
        del params, cache, logits
    pred = mm.serve_peak_bytes(cfg, B, cache_len, nd, t,
                               zero=3 if zero_data else 0)
    smi = smi or card()
    return {"arch": arch, "shape": shape_name, "batch": B,
            "cache_len": cache_len, "pods": pods, "d": nd, "t": t,
            "rank": rank, "weights_over_data": zero_data,
            "actual_bytes": int(actual), "weight_bytes": int(weights),
            "cache_bytes": int(cache_bytes), "base_bytes": int(base),
            "pred_serve": pred, "logits_shape": logits_shape,
            "logits_finite": finite,
            "acc_serve": round(1 - abs(pred - actual) / actual, 4), **smi}


def describe_serve(r: Dict[str, Any]) -> str:
    pods = f" ({r['pods']} pods)" if r.get("pods", 1) > 1 else ""
    over = ", weights over data" if r["weights_over_data"] else ""
    return (f"{r['arch']} {r['shape']} B={r['batch']} cache={r['cache_len']}"
            f" d={r['d']}{pods} t={r['t']} rank {r['rank']}{over}:"
            f" actual {r['actual_bytes']} B ({r['actual_bytes'] / 2**30:.2f}"
            f" GiB; weights {r['weight_bytes']} B, cache {r['cache_bytes']}"
            f" B), serve_peak_bytes {r['pred_serve']:.0f} B"
            f" ({r['acc_serve']:.4f}); {r['device']}, {r['power_limit']}")


def describe(r: Dict[str, Any]) -> str:
    pods = f" ({r['pods']} pods)" if r.get("pods", 1) > 1 else ""
    return (f"{r['arch']} b={r['batch']} d={r['d']}{pods} t={r['t']}"
            f" zero={r['zero']}:"
            f" actual {r['actual_bytes']} B ({r['actual_bytes'] / 2**30:.2f}"
            f" GiB), exact-pred {r['pred_exact']:.0f} B ({r['acc_exact']:.4f}),"
            f" paper-pred {r['pred_paper']:.0f} B ({r['acc_paper']:.4f})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--zero", type=int, default=0)
    ap.add_argument("--arch", help="run this one plan (with --batch, --seq, "
                    "--d, --t, --rank) and print its row")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--d", type=int, default=1)
    ap.add_argument("--t", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--shape", choices=("prefill_32k", "decode_32k",
                                        "long_500k"),
                    help="run rank --rank of this serving plan of --arch "
                    "on (--pods,) --d, --t")
    args = ap.parse_args(argv)
    from repro_torch.launch import configure_allocator
    configure_allocator()
    if args.shape:
        if not args.arch:
            ap.error("--shape needs --arch")
        r = run_serve(args.arch, args.shape, args.d, args.t, rank=args.rank,
                      pods=args.pods)
        print(f"rank {args.rank}: {describe_serve(r)}", flush=True)
        return
    if args.arch:
        r = run_one(args.arch, args.batch, args.seq, args.d, args.t,
                    args.zero, rank=args.rank, pods=args.pods)
        print(f"rank {args.rank}: {describe(r)}", flush=True)
        return
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"memcheck_zero{args.zero}.json")
    if os.path.exists(path) and not args.force:
        print(f"cached: {path}")
        return
    smi = card()
    rows = []
    for arch, batch, seq, d, t in COMBOS:
        r = run_one(arch, batch, seq, d, t, args.zero, smi=smi)
        rows.append(r)
        print(describe(r), flush=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
