"""Training driver for the port, on one device.

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

The flags are the JAX driver's (``repro.launch.train``) plus ``--device``.
``--zero`` is accepted and has no effect on the run: it chooses how the
optimizer state is sharded over data-parallel devices, and there is one
device; the memory prediction prices it.  After the first step the driver
prints the port's prediction of the peak (``core.memory_model``'s
``exact_peak_bytes`` and ``paper_peak_bytes`` for one device) and, on a
card, the peak of allocated device memory over that step beside it, the
accuracy of each prediction (``1 - |pred - actual| / actual``, the JAX
``launch/memcheck``'s) and the memory feedback plane's class of the
sample, which it records (``core.memtrace.record``; the JAX driver records
XLA's compile-time memory analysis there).  ``--ckpt-dir DIR`` saves the
parameters after the last step (``ckpt.save``, the JAX package's layout).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace
from repro_torch.data import SyntheticTokens
from repro_torch.launch import configure_allocator
from repro_torch.train import build_train_step, make_train_state


def to_device(raw: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A SyntheticTokens batch on ``device``: tokens, labels and, for a VLM
    config, the modal embeddings (float32, cast by the forward)."""
    return {k: torch.from_numpy(raw[k]).to(device)
            for k in ("tokens", "labels", "modal_embeds") if k in raw}


def accuracy(pred: float, actual: float) -> float:
    """The JAX ``launch/memcheck``'s prediction accuracy: 1 - |pred -
    actual| / actual."""
    return 1.0 - abs(pred - actual) / actual


def memory_report(cfg: ModelConfig, tc: TrainConfig, peak: Optional[int],
                  device: torch.device, log: Callable[[str], None]
                  ) -> Dict[str, Any]:
    """The port's peak predictions for ``cfg`` under ``tc`` on one device
    beside the observed ``peak`` (None off a card); a sample with a peak
    goes into the memory feedback plane.  Returns the numbers printed."""
    exact = mm.exact_peak_bytes(cfg, tc.global_batch, tc.seq_len, 1, 1,
                                zero=tc.zero, microbatch=tc.microbatch,
                                remat=tc.remat)
    paper = mm.paper_peak_bytes(cfg, tc.global_batch, tc.seq_len, 1, 1)
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
          log_every: int = 10, log: Callable[[str], None] = print
          ) -> Dict[str, Any]:
    """Run ``tc.steps`` steps on SyntheticTokens drawn from ``tc.seed``.
    Returns the per-step losses and wall times (each step ends in a device
    synchronise), the peak allocated device memory over step 1 (None off
    a card) and ``memory_report``'s numbers, the final state and the
    number of microbatches."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    state = make_train_state(cfg, tc, device=device)
    step, n_micro = build_train_step(cfg, tc, tc.global_batch, tc.seq_len)
    data = SyntheticTokens(cfg, tc.global_batch, tc.seq_len, seed=tc.seed)
    losses, step_s, peak, memory = [], [], None, None
    for i in range(tc.steps):
        batch = to_device(next(data), device)
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
            memory = memory_report(cfg, tc, peak, device, log)
        if i % log_every == 0 or i == tc.steps - 1:
            log(f"step {i:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({step_s[-1] * 1e3:.1f} ms)")
    return {"losses": losses, "step_s": step_s, "peak_bytes": peak,
            "memory": memory, "state": state, "n_micro": n_micro}


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
                    help="accepted for the JAX driver's flags; no effect on "
                         "one device")
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
    print(f"arch={cfg.name} device={args.device} batch={args.batch} "
          f"seq={args.seq} microbatch={args.microbatch}", flush=True)
    out = train(cfg, tc, device=args.device, log_every=args.log_every,
                log=lambda s: print(s, flush=True))
    losses = out["losses"]
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, out["state"]["params"])
        print(f"checkpoint saved to {args.ckpt_dir}")
    print(f"microbatches {out['n_micro']} first-10-mean "
          f"{np.mean(losses[:10]):.4f} last-10-mean {np.mean(losses[-10:]):.4f}")
    if not loss_fell(losses):
        raise RuntimeError("loss did not fall")
    return losses


if __name__ == "__main__":
    main()
