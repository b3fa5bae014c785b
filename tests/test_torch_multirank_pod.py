"""The sharded train step with the pod axis on the CPU: 4 ``gloo`` processes
on (pod, data, model) = (2, 1, 2) and (2, 2, 1) meshes against the
single-process port step, from the same seed and batches -- the pattern
of tests/test_torch_multirank.py -- and against the JAX package's own
sharded step on a 4-host-device ("pod", "data", "model") mesh.

The data axes ("pod", "data") act as one, flattened pod-major (index
pod * d + data for d data ranks a pod, the order of JAX's
``PartitionSpec(("pod", "data"))``): the batch, the gradient
reduce-scatter and all-reduce, the loss mean, the ZeRO-3 gather, the
ZeRO-1 all-gather and the MoE's load-balance statistics all run over
it.  On (2, 1, 2) it is the pod axis's own group;
on (2, 2, 1) one group over both axes.

Configs: llama3.2-3b smoke (dense GQA, tied, vocabulary-sharded logits at
t = 2) and mixtral-8x22b smoke (MoE, 4 experts top-2: expert-parallel at
t = 2, data-parallel on (2, 2, 1)), each at ZeRO 0, 1 and 3.  The
single-process reference takes microbatches of MB * d rows, d = pods x
data: the global microbatch the MoE's aux loss is a mean over.
Tolerances (tests/test_torch_multirank_harness.py): step 1's fp32
gradients gathered from the optimizer shards within 1e-5 of max |g| per
leaf, the grad norm within 1e-5 relative, four bf16 losses within 2e-2
and falling.  Every rank's shards have the specs' shapes, and
``gather_state`` of the rank's fresh state equals the single-process
params and master weights bit for bit.  At ZeRO 3 each (arch, mesh)
runs in the JAX package's ``build_train_step`` too, from the same bf16
parameters and batches: every rank's four bf16 losses and step 1's grad
norm within 2e-2 of the JAX step's.
"""
import os

import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import global_norm, tree_leaves
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, MB, S, as_fp32, bad_shards, batches,
    jax_results, join_ranks, one_thread, spawn_ranks, start_jax,
    train_config)

ARCHS = ["llama3.2-3b", "mixtral-8x22b"]
ZEROS = [0, 1, 3]
MESHES = [(2, 1, 2), (2, 2, 1)]            # (pod, data, model)
CASES = [(arch, mesh, zero) for arch in ARCHS for mesh in MESHES
         for zero in ZEROS]
WORLD = 4
# the plans also run in the JAX package's sharded step
JAX_ZERO = 3
JAX_JOBS = [{"arch": arch, "fields": {}, "mesh": mesh, "zero": JAX_ZERO}
            for arch in ARCHS for mesh in MESHES]


def _key(arch, mesh, zero):
    return f"{arch}-{'x'.join(map(str, mesh))}-zero{zero}"


def _case(arch, mesh_shape, zero):
    """One case on this rank: step 1's gathered fp32 gradients, the fp32
    and bf16 grad norms, four bf16 losses, the shards off their specs'
    shapes, and the gathered fresh params and master weights."""
    cfg, tc = smoke_config(arch), train_config(zero)
    pods, d, t = mesh_shape
    mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)
    data = batches(cfg, step.rows)
    state = as_fp32(make_local_state(cfg, tc, mesh, device="cpu"))
    acc, _ = step.accumulate(state["params"], data[0])
    grads = [col.gather_leaf(g, s, mesh).numpy()
             for g, s in zip(acc, tree_leaves(specs["opt"]["master"]))]
    gnorm = float(step.global_norm(acc))

    state = make_local_state(cfg, tc, mesh, device="cpu")
    bad = bad_shards(state, specs, param_shapes(cfg), mesh)
    whole = col.gather_state(state, specs, mesh, cfg.n_ssm_heads)
    whole = [t.float().numpy().copy() for t in tree_leaves(whole["params"])
             + tree_leaves(whole["opt"]["master"])]
    metrics = [step(state, batch)[1] for batch in data]
    return {"grads": grads, "whole": whole, "gnorm": gnorm,
            "losses": [float(m["loss"]) for m in metrics],
            "bf16_gnorm": float(metrics[0]["grad_norm"]), "bad": bad}


def _work(rank, world, out_dir):
    out = {}
    for arch, mesh, zero in CASES:
        res = _case(arch, mesh, zero)
        key = _key(arch, mesh, zero)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{key}.npz"), *res["grads"])
            np.savez(os.path.join(out_dir, f"{key}-whole.npz"),
                     *res["whole"])
        out[key] = {k: res[k] for k in ("gnorm", "losses", "bf16_gnorm",
                                         "bad")}
    return out


def _single():
    """{(arch, d): (fp32 step-1 grads, grad norm, bf16 losses, the fresh
    params and master weights)} of the single-process step at
    microbatches of MB * d rows."""
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        data = batches(cfg)
        for d in sorted({p * d for p, d, _ in MESHES}):
            tc = train_config(1, microbatch=MB * d)
            state = as_fp32(make_train_state(cfg, tc, device="cpu"))
            grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                        resolve_microbatches(tc, B))
            gnorm = float(global_norm(grads))
            grads = [g.numpy() for g in tree_leaves(grads)]
            step, _ = build_train_step(cfg, tc, B, S)
            state = make_train_state(cfg, tc, device="cpu")
            whole = [t.float().numpy().copy()
                     for t in tree_leaves(state["params"])
                     + tree_leaves(state["opt"]["master"])]
            losses = [float(step(state, batch)[1]["loss"]) for batch in data]
            out[arch, d] = (grads, gnorm, losses, whole)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(out_dir, [each rank's results], single, the JAX runs): one spawn
    of 4 ranks for every case, the JAX subprocess and the single-process
    reference beside it."""
    out_dir = tmp_path_factory.mktemp("pod")
    jax_run = start_jax(out_dir, JAX_JOBS)
    try:
        ctx = spawn_ranks(_work, WORLD, out_dir)
        single = _single()
        res = join_ranks(ctx, WORLD, out_dir)
    except BaseException:
        jax_run.kill()
        raise
    return out_dir, res, single, jax_results(jax_run)


IDS = [_key(*c) for c in CASES]


@pytest.mark.parametrize("arch,mesh,zero", CASES, ids=IDS)
def test_step1_grads_match_single_process(runs, arch, mesh, zero):
    out_dir, res, single, _ = runs
    key = _key(arch, mesh, zero)
    got = np.load(out_dir / f"{key}.npz")
    want, want_norm, _, _ = single[arch, mesh[0] * mesh[1]]
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), i
    for r in res:
        assert abs(r[key]["gnorm"] - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("arch,mesh,zero", CASES, ids=IDS)
def test_bf16_losses_match_single_process(runs, arch, mesh, zero):
    _, res, single, _ = runs
    want = single[arch, mesh[0] * mesh[1]][2]
    for r in res:
        got = r[_key(arch, mesh, zero)]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got[-1] < got[0]


@pytest.mark.parametrize("arch,mesh,zero", CASES, ids=IDS)
def test_shards_have_the_specs_shapes(runs, arch, mesh, zero):
    _, res, _, _ = runs
    for r in res:
        assert r[_key(arch, mesh, zero)]["bad"] == []


@pytest.mark.parametrize("arch,mesh,zero", CASES, ids=IDS)
def test_gather_state_is_the_single_process_state(runs, arch, mesh, zero):
    """``gather_state`` of the pod plan's fresh shards: the single-process
    params and master weights, bit for bit."""
    out_dir, _, single, _ = runs
    got = np.load(out_dir / f"{_key(arch, mesh, zero)}-whole.npz")
    want = single[arch, mesh[0] * mesh[1]][3]
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        assert np.array_equal(got[f"arr_{i}"], w), i


@pytest.mark.parametrize("job", range(len(JAX_JOBS)),
                         ids=[_key(j["arch"], j["mesh"], j["zero"])
                              for j in JAX_JOBS])
def test_bf16_losses_match_the_jax_sharded_step(runs, job):
    """Every rank's four bf16 losses and step 1's bf16 grad norm against
    the JAX package's sharded step on the same (pod, data, model) mesh of
    4 host devices, from the same parameters and batches."""
    _, res, _, jax_out = runs
    arch, mesh = JAX_JOBS[job]["arch"], JAX_JOBS[job]["mesh"]
    want = jax_out[job]
    assert len(want["losses"]) == len(res[0][_key(arch, mesh, JAX_ZERO)][
        "losses"])
    for r in res:
        got = r[_key(arch, mesh, JAX_ZERO)]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got["bf16_gnorm"] - want["grad_norm"]) \
            <= LOSS_TOL * want["grad_norm"]
