"""Training driver for the port: one device, or one rank of a (d, t) plan
under ``torchrun``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-350m \
        --batch 8 --seq 1024 --microbatch 1 --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-350m \
        --smoke --device cpu --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --batch 8 --seq 1024 --microbatch 1 --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-236b --smoke --device cpu --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-350m \
        --smoke --device cpu --steps 12 --ckpt-dir /path/to/ckpts
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch llama3.2-3b --smoke --device cpu --zero 3 --steps 12

The flags are the JAX driver's (``repro.launch.train``) plus ``--device``.
Under ``torchrun`` (``WORLD_SIZE`` > 1) the mesh is sized as the JAX
driver sizes it: d = min(world, batch) data shards, t = world // d model
shards; each rank holds its shards of the state, draws only its rows of
each global batch (``step.rows``) and runs the sharded step
(``train.build_train_step(..., mesh=)``; ``gloo`` on the CPU, ``nccl`` on
cards, one card a rank), and ``--zero`` chooses how the state shards over
data (0: optimizer state replicated, 1: sharded, 3: params too).  With one
process there is nothing to shard, and ``--zero`` only prices the memory
prediction.  After the first step the driver
prints the port's prediction of the peak (``core.memory_model``'s
``exact_peak_bytes`` and ``paper_peak_bytes`` for the plan) and, on a
card, the peak of allocated device memory over that step beside it, the
accuracy of each prediction (``1 - |pred - actual| / actual``, the JAX
``launch/memcheck``'s) and the memory feedback plane's class of the
sample, which it records (``core.memtrace.record``; the JAX driver records
XLA's compile-time memory analysis there).  ``--ckpt-dir DIR`` saves the
parameters after the last step (``ckpt.save``, the JAX package's layout);
under ``torchrun`` every rank gathers them from the shards
(``save_checkpoint``) and rank 0 writes the files.  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace
from repro_torch.data import SyntheticTokens
from repro_torch.launch import configure_allocator
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.train import (build_train_step, make_local_state,
                               make_train_state)
from repro_torch.train.train_loop import n_data_shards, state_specs


def to_device(raw: Dict[str, np.ndarray], device, dtype: torch.dtype
              ) -> Dict[str, torch.Tensor]:
    """A SyntheticTokens batch on ``device``: tokens, labels and, for a VLM
    config, the modal embeddings cast to the compute dtype ``dtype`` on the
    host (the params' dtype, ``compute_dtype``: what the forward would cast
    them to), so the device holds them at its width and never in float32."""
    out = {k: torch.from_numpy(raw[k]).to(device)
           for k in ("tokens", "labels") if k in raw}
    if "modal_embeds" in raw:
        out["modal_embeds"] = torch.from_numpy(raw["modal_embeds"]).to(
            dtype).to(device)
    return out


def compute_dtype(state: Dict[str, Any]) -> torch.dtype:
    """The dtype the step computes in: its params' (the embedding's)."""
    return state["params"]["embed"].dtype


def accuracy(pred: float, actual: float) -> float:
    """The JAX ``launch/memcheck``'s prediction accuracy: 1 - |pred -
    actual| / actual."""
    return 1.0 - abs(pred - actual) / actual


def memory_report(cfg: ModelConfig, tc: TrainConfig, peak: Optional[int],
                  device: torch.device, log: Callable[[str], None],
                  d: int = 1, t: int = 1) -> Dict[str, Any]:
    """The port's peak predictions for ``cfg`` under ``tc`` on a device of
    the (d, t) plan beside the observed ``peak`` (None off a card); a
    sample with a peak goes into the memory feedback plane.  Returns the
    numbers printed."""
    exact = mm.exact_peak_bytes(cfg, tc.global_batch, tc.seq_len, d, t,
                                zero=tc.zero, microbatch=tc.microbatch,
                                remat=tc.remat)
    paper = mm.paper_peak_bytes(cfg, tc.global_batch, tc.seq_len, d, t)
    out = {"exact_bytes": exact, "paper_bytes": paper}
    if peak is None:
        log(f"memory: predicted peak {exact:.0f} B (exact), {paper:.0f} B"
            f" (paper); observed peak not measured (no card)")
        return out
    dev_type = memtrace.device_type_for(torch.cuda.get_device_name(device))
    bucket = memtrace.shape_bucket(exact)
    memtrace.record(cfg.family, tc.zero, dev_type, exact, peak, source="cuda")
    out.update(device_type=dev_type, acc_exact=accuracy(exact, peak),
               acc_paper=accuracy(paper, peak))
    log(f"memory: observed peak over step 1 {peak} B, predicted {exact:.0f} B"
        f" (exact, accuracy {out['acc_exact']:.4f}), {paper:.0f} B (paper,"
        f" accuracy {out['acc_paper']:.4f}); memtrace class ({cfg.family},"
        f" zero={tc.zero}, {dev_type}, bucket {bucket}), sample recorded")
    return out


def train(cfg: ModelConfig, tc: TrainConfig, *, device="cuda",
          log_every: int = 10, log: Callable[[str], None] = print,
          mesh=None) -> Dict[str, Any]:
    """Run ``tc.steps`` steps on SyntheticTokens drawn from ``tc.seed``:
    on one device, or with ``mesh`` (a ("data", "model") DeviceMesh) as
    this rank of the plan, on its shards of the state and its rows of the
    global batch (``step.rows``; the host draws no other row's modal
    embeddings).  Returns the per-step losses and wall times (each step
    ends in a device synchronise), the peak allocated device memory over
    step 1 (None off a card) and ``memory_report``'s numbers, the final
    state and the number of microbatches."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if mesh is None:
        state = make_train_state(cfg, tc, device=device)
        d = t = 1
    else:
        state = make_local_state(cfg, tc, mesh, device=device)
        sizes = sh.axis_sizes(mesh)
        d, t = n_data_shards(mesh), sizes.get("model", 1)
    step, n_micro = build_train_step(cfg, tc, tc.global_batch, tc.seq_len,
                                     mesh=mesh)
    data = SyntheticTokens(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                           rows=step.rows)
    dtype = compute_dtype(state)
    losses, step_s, peak, memory = [], [], None, None
    for i in range(tc.steps):
        batch = to_device(next(data), device, dtype)
        if on_card:
            torch.cuda.synchronize(device)
            if i == 0:
                torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if on_card:
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if i == 0:
            if on_card:
                peak = torch.cuda.max_memory_allocated(device)
            memory = memory_report(cfg, tc, peak, device, log, d, t)
        if i % log_every == 0 or i == tc.steps - 1:
            log(f"step {i:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({step_s[-1] * 1e3:.1f} ms)")
    return {"losses": losses, "step_s": step_s, "peak_bytes": peak,
            "memory": memory, "state": state, "n_micro": n_micro}


def save_checkpoint(ckpt_dir: str, step: int, cfg: ModelConfig,
                    tc: TrainConfig, state: Dict[str, Any], mesh=None) -> bool:
    """``ckpt.save`` of the state's parameters; with ``mesh`` (a
    collective: every rank of the plan calls it) they are gathered from the
    ranks' shards first and rank 0 writes.  Returns whether this process
    wrote the files."""
    params = state["params"]
    if mesh is not None:
        specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
        with torch.no_grad():
            params = col.gather_state(state, specs, mesh, parts=("params",),
                                      ssm_heads=cfg.n_ssm_heads)["params"]
        if dist.get_rank() != 0:
            return False
    ckpt.save(ckpt_dir, step, params)
    return True


def loss_fell(losses) -> bool:
    """The JAX driver's test: the mean of the last 10 steps' losses is below
    the mean of the first 10."""
    return bool(np.mean(losses[-10:]) < np.mean(losses[:10]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--zero", type=int, default=1,
                    help="ZeRO stage over the data shards (under torchrun)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="",
                    help="save the parameters here after the last step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    configure_allocator()

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    tc = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                     microbatch=args.microbatch, learning_rate=args.lr,
                     steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                     zero=args.zero)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = _run(cfg, tc, args, args.device, None, print)
    else:
        out = _run_rank(cfg, tc, args, world)
    losses = out["losses"]
    if not loss_fell(losses):
        raise RuntimeError("loss did not fall")
    return losses


def _run(cfg, tc, args, device, mesh, say):
    say(f"arch={cfg.name} device={device} batch={args.batch} "
        f"seq={args.seq} microbatch={args.microbatch}", flush=True)
    out = train(cfg, tc, device=device, log_every=args.log_every,
                log=lambda s: say(s, flush=True), mesh=mesh)
    losses = out["losses"]
    if args.ckpt_dir and save_checkpoint(args.ckpt_dir, args.steps, cfg, tc,
                                         out["state"], mesh):
        print(f"checkpoint saved to {args.ckpt_dir}")
    say(f"microbatches {out['n_micro']} first-10-mean "
        f"{np.mean(losses[:10]):.4f} last-10-mean {np.mean(losses[-10:]):.4f}")
    return out


def _run_rank(cfg, tc, args, world):
    """This rank of a ``torchrun`` launch: the plan's mesh over the
    process group (d = min(world, batch), t = world // d, the JAX
    driver's sizing), its card (LOCAL_RANK) on CUDA."""
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    d = min(world, args.batch)
    t = world // d
    if d * t != world:
        raise ValueError(f"{world} ranks do not form a plan of d={d} data "
                         f"shards (batch {args.batch}) x t model shards")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = make_plan_mesh(d, t, device_type=device.type)
        rank0 = dist.get_rank() == 0
        say = print if rank0 else (lambda *a, **k: None)
        say(f"plan d={d} t={t} zero={tc.zero} ({world} ranks)")
        return _run(cfg, tc, args, device, mesh, say)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
