"""The sharded train step on the CPU: 2 and 4 ``gloo`` processes against the
single-process port step (itself held to the JAX package's in
tests/test_torch_train.py), from the same seed and batches.

Configs: llama3.2-3b smoke (GQA, RoPE, SwiGLU, vocab 512: the embed is
vocab-sharded on the model axis) and gpt2-350m smoke with an odd vocabulary
of 509 (tied head, the embed sharded over d_model).  Meshes (data, model):
(2, 1) and (1, 2) in one spawn of 2 processes, (2, 2) in one spawn of 4,
each at ZeRO 0, 1 and 3.  Tolerances and their reasons
(tests/test_torch_multirank_harness.py, shared by the multi-rank files):

* params cast to float32, step 1's accumulated gradients, gathered from
  the ranks' optimizer shards: max |d| <= 1e-5 max |g| per leaf, and the
  grad norm within 1e-5 relative -- the ranks sum the same products in
  other orders (over the data axis, over the model axis's heads and FFN
  columns).
* bf16, four steps: losses within 2e-2, the JAX package's own
  multi-device tolerance (tests/test_multidevice.py:77), and the loss
  falls.
* every rank's shards have the shapes the ported specs give, and at ZeRO
  >= 1 its optimizer bytes are 1/d of the (1, t) run's, but for the leaves
  ``enforce_divisibility`` keeps whole (counted from the specs).
"""
import os

import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, S, as_fp32, bad_shards, batches,
    join_ranks, nbytes, one_thread, paths, spawn_ranks, train_config)

ARCHS = ["llama3.2-3b", "gpt2-350m"]
ZEROS = [0, 1, 3]
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
CASES = [(world, arch, d, t, zero) for world, meshes in MESHES.items()
         for arch in ARCHS for d, t in meshes for zero in ZEROS]


def config(arch):
    cfg = smoke_config(arch)
    return cfg.scaled(vocab_size=509) if arch == "gpt2-350m" else cfg


def _case(rank, arch, d, t, zero):
    """One (arch, mesh, zero) case on this rank: step 1's accumulated
    gradients (fp32 params) gathered, its grad norm, four bf16 losses, the
    shard shapes that differ from the specs' and the optimizer bytes."""
    cfg, tc = config(arch), train_config(zero)
    mesh = make_plan_mesh(d, t, device_type="cpu")
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)
    data = batches(cfg, step.rows)

    state = as_fp32(make_local_state(cfg, tc, mesh, device="cpu"))
    acc, _ = step.accumulate(state["params"], data[0])
    o_specs = tree_leaves(specs["opt"]["master"])
    grads = [col.gather_leaf(g, s, mesh).numpy() for g, s in zip(acc, o_specs)]
    _, metrics = step(state, data[0])
    gnorm = float(metrics["grad_norm"])

    state = make_local_state(cfg, tc, mesh, device="cpu")
    bad = bad_shards(state, specs, param_shapes(cfg), mesh)
    opt_bytes = nbytes(state["opt"])
    losses = [float(step(state, batch)[1]["loss"]) for batch in data]
    return {"grads": grads, "gnorm": gnorm, "losses": losses, "bad": bad,
            "opt_bytes": opt_bytes}


def _work(rank, world, out_dir):
    out = {}
    for w, arch, d, t, zero in CASES:
        if w != world:
            continue
        res = _case(rank, arch, d, t, zero)
        key = f"{arch}-{d}x{t}-zero{zero}"
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{key}.npz"), *res["grads"])
        out[key] = {k: res[k] for k in ("gnorm", "losses", "bad",
                                        "opt_bytes")}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: (out_dir, [each rank's results])}: one spawn per world size,
    every case of that size inside it."""
    out = {}
    for world in MESHES:
        d = tmp_path_factory.mktemp(f"world{world}")
        out[world] = (d, join_ranks(spawn_ranks(_work, world, d), world, d))
    return out


@pytest.fixture(scope="module")
def single():
    """{arch: (fp32 step-1 grads, grad norm, bf16 losses, opt bytes)} of
    the single-process port step."""
    out = {}
    for arch in ARCHS:
        cfg, tc = config(arch), train_config(1)
        data = batches(cfg)
        state = as_fp32(make_train_state(cfg, tc, device="cpu"))
        grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                    resolve_microbatches(tc, B))
        grads = [g.numpy() for g in tree_leaves(grads)]
        step, _ = build_train_step(cfg, tc, B, S)
        state = as_fp32(make_train_state(cfg, tc, device="cpu"))
        gnorm = float(step(state, data[0])[1]["grad_norm"])
        state = make_train_state(cfg, tc, device="cpu")
        opt_bytes = nbytes(state["opt"])
        losses = [float(step(state, batch)[1]["loss"]) for batch in data]
        out[arch] = (grads, gnorm, losses, opt_bytes)
    return out


def _key(arch, d, t, zero):
    return f"{arch}-{d}x{t}-zero{zero}"


IDS = [_key(a, d, t, z) for _, a, d, t, z in CASES]


@pytest.mark.parametrize("world,arch,d,t,zero", CASES, ids=IDS)
def test_step1_grads_match_single_process(ranks, single, world, arch, d, t,
                                          zero):
    out_dir, res = ranks[world]
    key = _key(arch, d, t, zero)
    got = np.load(out_dir / f"{key}.npz")
    want, want_norm, _, _ = single[arch]
    names = list(paths(param_shapes(config(arch))))
    assert len(got.files) == len(want) == len(names)
    for i, (name, w) in enumerate(zip(names, want)):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err, np.abs(w).max())
    for r in res:
        assert abs(r[key]["gnorm"] - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("world,arch,d,t,zero", CASES, ids=IDS)
def test_bf16_losses_match_single_process(ranks, single, world, arch, d, t,
                                          zero):
    _, res = ranks[world]
    want = single[arch][2]
    for r in res:
        got = r[_key(arch, d, t, zero)]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got[-1] < got[0]


@pytest.mark.parametrize("world,arch,d,t,zero", CASES, ids=IDS)
def test_shards_have_the_specs_shapes(ranks, world, arch, d, t, zero):
    _, res = ranks[world]
    for r in res:
        assert r[_key(arch, d, t, zero)]["bad"] == []


@pytest.mark.parametrize("world,arch,d,t,zero",
                         [c for c in CASES if c[2] > 1 and c[4] >= 1],
                         ids=[_key(*c[1:]) for c in CASES
                              if c[2] > 1 and c[4] >= 1])
def test_optimizer_bytes_shard_over_data(ranks, single, world, arch, d, t,
                                         zero):
    """At ZeRO >= 1 a rank's optimizer bytes are 1/d of the (1, t) run's,
    but for the leaves whose dims d does not divide (kept whole)."""
    _, res = ranks[world]
    cfg = config(arch)
    if t == 1:
        base = single[arch][3]
    else:
        base = ranks[t][1][0][_key(arch, 1, t, zero)]["opt_bytes"]
    whole = 0                       # the (1, t) bytes of leaves kept whole
    mesh = {"data": d, "model": t}
    specs = state_specs(cfg, train_config(zero), mesh, param_shapes(cfg))
    for shape, spec in zip(tree_leaves(param_shapes(cfg)),
                           tree_leaves(specs["opt"]["master"])):
        if col.data_dim(spec) is None:
            whole += 3 * 4 * int(np.prod(col.local_shape(shape, spec, mesh)))
    for r in res:
        got = r[_key(arch, d, t, zero)]["opt_bytes"]
        assert got == (base - whole) // d + whole
        assert got < base
