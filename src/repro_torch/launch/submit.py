"""The serverless front door (paper Fig 1): submit models, watch MARP
predict resources and HAS place them on a heterogeneous cluster.

    PYTHONPATH=src python -m repro_torch.launch.submit --arch gpt2-350m \
        --batch 32 --seq 1024 --cluster paper-sim

The port's copy of the JAX package's ``repro.launch.submit``, line for line
with its imports pointed at ``repro_torch``: the same arguments print the
same text (``tests/test_torch_submit.py``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.orchestrator import (Orchestrator, make_cluster,
                                           PAPER_REAL_CLUSTER,
                                           PAPER_SIM_CLUSTER, TPU_FLEET)
from repro_torch.core.serverless import submit

CLUSTERS = {"paper-real": PAPER_REAL_CLUSTER, "paper-sim": PAPER_SIM_CLUSTER,
            "tpu-fleet": TPU_FLEET}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--zero", type=int, default=1)
    ap.add_argument("--cluster", choices=sorted(CLUSTERS), default="paper-sim")
    ap.add_argument("--mode", choices=["exact", "paper"], default="exact")
    args = ap.parse_args(argv)

    orch = Orchestrator(make_cluster(CLUSTERS[args.cluster]))
    print(f"cluster '{args.cluster}': "
          + ", ".join(f"{n.node_id}({n.idle}x{n.device_type})"
                      for n in orch.snapshot()))
    results = []
    for arch in args.arch:
        cfg = get_arch(arch)
        tc = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                         zero=args.zero)
        res = submit(orch, cfg, tc, mode=args.mode)
        print(f"\n=== {arch} (batch={args.batch}, seq={args.seq}) ===")
        print(f"MARP produced {len(res.plans)} feasible plans; top 3:")
        for p in res.plans[:3]:
            print(f"  d={p.d:3d} t={p.t:2d} -> {p.n_devices:3d} x"
                  f" >= {p.min_mem_gb:5.1f} GB ({p.device_type}),"
                  f" score {p.score:.3g}")
        print(res.describe())
        results.append(res)
    return results


if __name__ == "__main__":
    main()
