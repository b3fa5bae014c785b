"""Dry run of every (architecture x input shape x mesh) combination on the
meta device: the port's counterpart of the JAX package's
``repro/launch/dryrun.py``.  It needs no GPU.

For each combo it runs rank ``--rank`` (default 0) of the production plan
((16, 16), or (2, 16, 16) with ``--multi-pod``) under PyTorch's fake
process group, on meta tensors (shapes, no data, no allocation): a train
step (``build_train_step(..., mesh=)`` on the rank's state from
``make_local_state(device="meta", whole_leaves=False)``, ZeRO and
microbatch from ``launch.inputs.default_train_config``), a prefill of the
rank's rows, or one decode step at position cache_len - 1.  The kernels'
wrappers run as on the card and skip the launch (``kernels.meta``), so
the tensors held at each moment are the card's.  ``launch.op_analysis``
watches the step and the row records its peak (``core.memory_model.
dryrun_peak_bytes``), FLOPs, bytes and collectives by kind:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --memcheck-rows

One JSON row per combo goes to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.  A train step
of n > 2 microbatches is traced as a step of 2 microbatches of the same
shape and extrapolated linearly from the counts after each (every
microbatch after the first runs the same ops;
``trace_train(every_micro=True)`` traces all n).  A
combo the port's sharded step does not run raises NotImplementedError
naming ``parallel.sharding.DEFERRED`` (ROADMAP queue 1 item 14): its row
is ``refused``, not failed.  Any other exception is a failure, and
``main`` exits 1 when there is one.

``--memcheck-rows`` dry-runs the plans of the card's committed Fig 6 rows
(``experiments/memcheck_torch/memcheck_zero{0,1,3}.json``) and prints
each dry-run peak plus the row's ``base_bytes`` beside its
``actual_bytes``: those are the card's numbers, the dry run's are counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, TrainConfig
from repro_torch.configs.registry import (ASSIGNED, get_arch, get_shape,
                                          shape_applicable)
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace
from repro_torch.launch.inputs import (default_train_config,
                                       serve_weights_over_data)
from repro_torch.launch.memcheck import fake_world, local_state_bytes
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.launch.op_analysis import (Analysis, OpStats,
                                            alloc_bytes)
from repro_torch.launch.train import compute_dtype
from repro_torch.parallel.sharding import DEFERRED
from repro_torch.train import train_loop as tl
from repro_torch.train.train_loop import (build_train_step, make_local_state,
                                          resolve_microbatches)

ROOT = os.path.join(os.path.dirname(__file__), "../../..")
DEFAULT_OUT = os.path.join(ROOT, "experiments/dryrun_torch")
MEMCHECK_ROWS = os.path.join(ROOT, "experiments/memcheck_torch")
MESHES = {False: (1, 16, 16), True: (2, 16, 16)}
#: the most |dry-run peak + base_bytes over the card's actual_bytes - 1| a
#: card row may show: the 30 committed rows read 0.9912 to 1.0004, the
#: farthest (gpt2-350m on one card) lacking only the 64 MiB workspace cuBLAS
#: makes during its step
MEMCHECK_TOLERANCE = 0.01


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch(cfg: ModelConfig, rows: int, seq: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Stand-ins of ``rows`` rows of a batch, in the dtypes the card is fed
    them (``launch.train.to_device``): ``data.SyntheticTokens``' int32
    tokens and labels, the modal embeddings at the compute dtype
    ``dtype``."""
    out = {"tokens": _meta((rows, seq - cfg.num_modal_tokens), torch.int32),
           "labels": _meta((rows, seq), torch.int32)}
    if cfg.num_modal_tokens:
        out["modal_embeds"] = _meta((rows, cfg.num_modal_tokens,
                                     cfg.d_model), dtype)
    return out


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def trace_train(cfg: ModelConfig, tc: TrainConfig, pods: int, d: int,
                t: int, rank: int = 0, every_micro: bool = False
                ) -> Tuple[OpStats, Dict[str, Any]]:
    """Rank ``rank``'s train step of the (pods, d, t) plan on meta tensors,
    under the fake process group, fed the rank's rows of the global batch
    as the card is: its ``OpStats`` and the row's fields.  A step of n > 2
    microbatches is traced as a step of 2 and extrapolated
    (``OpStats.extended``), unless ``every_micro``; the entry then holds
    the rank's rows of all n microbatches, as on the card."""
    B, S = tc.global_batch, tc.seq_len
    with fake_world(pods * d * t, rank):
        mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
        n_micro = resolve_microbatches(tc, B, mesh)
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        n = n_micro if every_micro or n_micro <= 2 else 2
        b = B // n_micro * n
        step, _ = build_train_step(cfg, dataclasses.replace(
            tc, global_batch=b), b, S, mesh=mesh)
        dtype = compute_dtype(state)
        data = train_batch(cfg, len(step.rows), S, dtype)
        analysis, marks = Analysis(live=(state, data)), []
        tl.MICRO_DONE = lambda i: marks.append(analysis.snapshot())
        try:
            with analysis as st:
                step(state, data)
        finally:
            tl.MICRO_DONE = None
        # the card's rank holds its rows of every microbatch, n of whose
        # n_micro were traced
        rows = len(step.rows) // n * n_micro
        st.entry_bytes += (_alloc(train_batch(cfg, rows, S, dtype))
                           - _alloc(data))
        del step, data
        state_bytes = local_state_bytes(cfg, tc, mesh)
        del state
    out = st if n == n_micro else st.extended(*marks, n_micro)
    return out, {"kind": "train", "zero": tc.zero, "n_micro": n_micro,
                 "cache_len": None, "state_bytes": state_bytes}


def _alloc(batch: Dict[str, torch.Tensor]) -> int:
    return sum(alloc_bytes(t.numel() * t.element_size())
               for t in batch.values())


def trace_serve(cfg: ModelConfig, shape_name: str, pods: int, d: int,
                t: int, rank: int = 0, batch: Optional[int] = None
                ) -> Tuple[OpStats, Dict[str, Any]]:
    """Rank ``rank``'s prefill or decode step of the serving plan of
    ``shape_name`` (at a global batch of ``batch`` in place of the
    shape's) on meta tensors, as ``launch.memcheck.run_serve`` runs it on
    the card."""
    from repro_torch.models import init_cache
    from repro_torch.serve import (local_serve_params, prefill,
                                   serve_parallel, serve_step)
    shape = get_shape(shape_name)
    B = batch or shape.global_batch
    cache_len = shape.cache_len or shape.seq_len
    nd = pods * d
    b = B // nd if B % nd == 0 else B
    with fake_world(pods * d * t, rank):
        mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
        zero_data = shape.kind == "decode" and serve_weights_over_data(
            cfg, mesh)
        par = serve_parallel(cfg, mesh, B, cache_len, zero_data=zero_data)
        params = local_serve_params(cfg, 0, mesh, zero_data=zero_data,
                                    device="meta")
        if shape.kind == "prefill":
            batch = {"tokens": _meta((b, shape.seq_len
                                      - cfg.num_modal_tokens), torch.long)}
            if cfg.num_modal_tokens:
                batch["modal_embeds"] = _meta(
                    (b, cfg.num_modal_tokens, cfg.d_model), torch.bfloat16)
            held = (params, batch)
            with Analysis(live=held) as st:
                logits, cache = prefill(cfg, params, batch, cache_len, par)
        else:
            cache = init_cache(cfg, B, cache_len, device="meta", par=par)
            tokens = _meta((b, 1), torch.long)
            held = (params, cache, tokens)
            with Analysis(live=held) as st:
                logits, cache = serve_step(cfg, params, tokens, cache,
                                           cache_len - 1, par)
        state_bytes = _nbytes(params) + sum(_nbytes(sub)
                                            for sub in cache.values())
        del params, cache, logits
    pred = mm.serve_peak_bytes(cfg, B, cache_len, nd, t,
                               zero=3 if zero_data else 0)
    return st, {"kind": shape.kind, "zero": 3 if zero_data else 0,
                "n_micro": None, "cache_len": cache_len,
                "weights_over_data": zero_data, "state_bytes": state_bytes,
                "pred_serve": pred}


def trace_combo(arch: str, shape_name: str, multi_pod: bool,
                tc: Optional[TrainConfig] = None, rank: int = 0
                ) -> Tuple[OpStats, Dict[str, Any]]:
    """Trace one combination (the JAX package's ``lower_combo``)."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    pods, d, t = MESHES[multi_pod]
    if shape.kind == "train":
        tc = tc or default_train_config(cfg, shape)
        stats, meta = trace_train(cfg, tc, pods, d, t, rank)
        pred = mm.exact_peak_bytes(cfg, shape.global_batch, shape.seq_len,
                                   pods * d, t, zero=tc.zero)
        meta["pred_exact"] = pred
        return stats, meta
    return trace_serve(cfg, shape_name, pods, d, t, rank)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            force: bool = False, tag: str = "",
            tc: Optional[TrainConfig] = None, rank: int = 0) -> dict:
    pods, d, t = MESHES[multi_pod]
    name = f"{pods}x{d}x{t}" if pods > 1 else f"{d}x{t}"
    key = f"{arch}__{shape_name}__{name}{tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "n_devices": pods * d * t, "rank": rank, "ok": False}
    t0 = time.time()
    try:
        stats, meta = trace_combo(arch, shape_name, multi_pod, tc, rank)
        rec.update({k: v for k, v in meta.items() if k != "state_bytes"})
        rec["trace_s"] = round(time.time() - t0, 1)
        peak = mm.dryrun_peak_bytes(stats)
        rec["memory"] = {"peak_bytes": peak, "entry_bytes": stats.entry_bytes,
                         "state_bytes": meta["state_bytes"]}
        rec["bytes_per_device"] = peak
        if meta["kind"] == "train" and peak is not None:
            cfg = get_arch(arch)
            memtrace.record(cfg.family, meta["zero"], memtrace.ANY_DEVICE,
                            meta["pred_exact"], peak, source="dryrun")
        rec["analysis"] = {**stats.to_json(),
                           "kernel_flops": dict(stats.kernel_flops),
                           "kernel_calls": dict(stats.kernel_calls)}
        rec["ok"] = True
    except NotImplementedError as e:
        if DEFERRED not in str(e):
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
        else:
            rec["refused"] = str(e)
    except Exception as e:  # noqa: BLE001 -- record failures, they are bugs
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK " if rec["ok"] else "REF " if "refused" in rec else "FAIL"
    peak = rec.get("bytes_per_device") or 0
    print(f"[{status}] {key}: {peak / 2**30:.2f} GiB/dev (dry-run count),"
          f" {rec['total_s']}s"
          + (f"  {rec['refused'][:200]}" if "refused" in rec else "")
          + ("" if rec["ok"] or "refused" in rec
             else f"  {rec.get('error', '')[:200]}"), flush=True)
    return rec


def failed(rec: dict) -> bool:
    return not rec["ok"] and "refused" not in rec


def all_combos():
    for arch in ASSIGNED:
        for shape_name in INPUT_SHAPES:
            if shape_applicable(arch, shape_name):
                yield arch, shape_name


def memcheck_row(row: dict) -> dict:
    """The dry run of one committed card row's plan (rank 0 of its
    (d, t) plan at its ZeRO, microbatch 1): its peak, and the peak plus
    the row's ``base_bytes`` over its ``actual_bytes``."""
    cfg = get_arch(row["arch"])
    tc = TrainConfig(global_batch=row["batch"], seq_len=row["seq"],
                     microbatch=1, zero=row["zero"])
    pods = row.get("pods", 1)
    stats, _ = trace_train(cfg, tc, pods, row["d"] // pods, row["t"],
                           row.get("rank", 0))
    peak = mm.dryrun_peak_bytes(stats)
    return {"peak_bytes": peak,
            "ratio": (peak + row["base_bytes"]) / row["actual_bytes"]}


def memcheck_rows(zeros=(0, 1, 3)):
    """Every committed card row of ``memcheck_zero{Z}.json``."""
    for z in zeros:
        with open(os.path.join(MEMCHECK_ROWS, f"memcheck_zero{z}.json")) as f:
            yield from json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--memcheck-rows", action="store_true",
                    help="dry-run the plans of experiments/memcheck_torch's"
                         " card rows, each peak beside the card's")
    args = ap.parse_args(argv)

    if args.memcheck_rows:
        worst = 0.0
        for row in memcheck_rows():
            r = memcheck_row(row)
            worst = max(worst, abs(r["ratio"] - 1))
            print(f"{row['arch']} b={row['batch']} d={row['d']} t={row['t']}"
                  f" zero={row['zero']}: dry-run peak {r['peak_bytes']} B"
                  f" + base {row['base_bytes']} B against the card's"
                  f" actual {row['actual_bytes']} B ({row['device']},"
                  f" {row['power_limit']}): {r['ratio']:.4f}", flush=True)
        print(f"largest |dry-run / card - 1|: {worst:.4f}")
        raise SystemExit(0 if worst <= MEMCHECK_TOLERANCE else 1)
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    n_fail = 0
    if args.all:
        for arch, shape_name in all_combos():
            for mp in meshes:
                rec = run_one(arch, shape_name, mp, args.out, args.force,
                              rank=args.rank)
                n_fail += failed(rec)
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape, or --all, or --memcheck-rows")
        if not shape_applicable(args.arch, args.shape):
            print(f"[SKIP] {args.arch} x {args.shape}: not applicable")
            raise SystemExit(0)
        for mp in meshes:
            rec = run_one(args.arch, args.shape, mp, args.out, args.force,
                          rank=args.rank)
            n_fail += failed(rec)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
