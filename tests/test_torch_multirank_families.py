"""The sharded train step for MLA, MoE and Mamba2 on the CPU: 2 and 4 ``gloo``
processes against the single-process port step (itself held to the JAX
package's in tests/test_torch_train.py and
tests/test_torch_train_jamba_and_driver.py), from the same seed and
batches -- tests/test_torch_multirank.py's pattern for the dense family.

Configs: deepseek-v2 smoke (MLA, expert-parallel MoE at t=2 -- 4 experts
-- with a shared expert, 8 heads), mamba2-130m smoke (16 SSM heads),
jamba smoke cut to one 8-layer block (Mamba2 + GQA + MoE + dense SwiGLU)
and mixtral smoke at 3 experts (ffn-sharded experts at t=2).  Meshes
(data, model): (2, 1) and (1, 2) in one spawn of 2 processes, (2, 2) in
one spawn of 4, each at ZeRO 0, 1 and 3.  mamba2 at ZeRO 3 with d = 2
splits its per-head and per-channel vectors over data on the stacked
layer axis only: the step gathers those leaves whole once, before the
blocks.

The single-process reference takes microbatches of MB * d rows: the JAX
step's microbatch on d data shards is the global one (mb rows a shard),
and the MoE's load-balance loss is a mean over it, so the sharded step
averages its statistics over the data axis.  mamba2 at ZeRO 3 on (2, 2)
also runs in the JAX package's sharded step on 4 host devices, from the
same parameters and batches.  Tolerances and their reasons, as
tests/test_torch_multirank_harness.py's:

* params cast to float32, step 1's accumulated gradients, gathered from
  the ranks' optimizer shards: max |d| <= 1e-5 max |g| per leaf (4e-5 for
  Mamba2's per-head and per-channel vectors, see ``VECTOR_TOL``), and the
  grad norm within 1e-5 relative -- the ranks sum the same products in
  other orders (over the data axis, over the model axis's heads, experts
  and columns, the gated norm's sum of squares).
* bf16, four steps: losses within 2e-2, the JAX package's own
  multi-device tolerance (tests/test_multidevice.py:77), and the loss
  falls; against the JAX package's sharded step, the losses and step 1's
  bf16 grad norm within 2e-2.
* every rank's shards have the shapes the ported specs give, and at ZeRO
  >= 1 its optimizer bytes are 1/d of the (1, t) run's, but for the leaves
  ``enforce_divisibility`` keeps whole (counted from the specs).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import forward, init_params, param_shapes
from repro_torch.models.transformer import SSM_VECTORS
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train.train_loop import (AUX_WEIGHT, accumulate_grads,
                                          build_train_step,
                                          check_sharded_supported,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, MB, S, STEPS, as_fp32, bad_shards,
    batches, jax_results, join_ranks, nbytes, one_thread, paths,
    spawn_ranks, start_jax, train_config)

ARCHS = ["deepseek-v2-236b", "mamba2-130m", "jamba-1.5-large-398b",
         "mixtral-8x22b"]
ZEROS = [0, 1, 3]
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
CASES = [(world, arch, d, t, zero) for world, meshes in MESHES.items()
         for arch in ARCHS for d, t in meshes for zero in ZEROS]
# Mamba2's per-head and per-channel vectors: each gradient sums over every
# (row, position[, channel]) with cancellation, so it moves further under a
# reordering: the single-process step's own jamba-smoke gradients move by
# up to 4.95e-6 max |g| (A_log) between one and four intra-op threads, and
# its model-axis split by 1.05e-5.  Every other leaf stays at GRAD_TOL.
VECTOR_TOL = 4e-5
# mamba2 at ZeRO 3 with d = 2 (its vectors gathered on the stacked layer
# axis) also runs in the JAX package's sharded step
JAX_JOB = {"arch": "mamba2-130m", "fields": {}, "mesh": (2, 2), "zero": 3}


def config(arch):
    cfg = smoke_config(arch)
    if arch == "jamba-1.5-large-398b":
        return cfg.scaled(num_layers=cfg.block_period)
    if arch == "mixtral-8x22b":
        return cfg.scaled(num_experts=3)
    return cfg


def stacked_data_leaves(arch, d, t, zero):
    """The block leaves whose only data-sharded dim is the stacked layer
    axis under the plan's ZeRO-3 param specs."""
    cfg = config(arch)
    specs = state_specs(cfg, train_config(zero), {"data": d, "model": t},
                        param_shapes(cfg))["params"]["blocks"]
    return [p for p, s in zip(paths(specs), tree_leaves(specs))
            if col.data_dim(s) == 0]


def _case(arch, d, t, zero):
    """One (arch, mesh, zero) case on this rank: step 1's accumulated
    gradients (fp32 params) gathered, its grad norm, four bf16 losses and
    step 1's bf16 grad norm, the shards that differ from the specs' shapes
    and the optimizer bytes."""
    cfg, tc = config(arch), train_config(zero)
    mesh = make_plan_mesh(d, t, device_type="cpu")
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)
    data = batches(cfg, step.rows)

    state = as_fp32(make_local_state(cfg, tc, mesh, device="cpu"))
    acc, _ = step.accumulate(state["params"], data[0])
    o_specs = tree_leaves(specs["opt"]["master"])
    names = [p.split("/")[-1] for p in paths(param_shapes(cfg))]
    grads = [col.gather_leaf(g, s, mesh, name, cfg.n_ssm_heads).numpy()
             for g, s, name in zip(acc, o_specs, names)]
    gnorm = float(step.global_norm(acc))

    state = make_local_state(cfg, tc, mesh, device="cpu")
    bad = bad_shards(state, specs, param_shapes(cfg), mesh)
    opt_bytes = nbytes(state["opt"])
    metrics = [step(state, batch)[1] for batch in data]
    return {"grads": grads, "gnorm": gnorm, "bad": bad,
            "opt_bytes": opt_bytes,
            "losses": [float(m["loss"]) for m in metrics],
            "bf16_gnorm": float(metrics[0]["grad_norm"])}


def _in_zx_round_trip(d, t):
    """mamba2 smoke's stacked ``in_zx`` cut to this rank's shard under its
    ZeRO 0 and ZeRO 3 specs and gathered back: equal to the leaf."""
    cfg = config("mamba2-130m")
    mesh = make_plan_mesh(d, t, device_type="cpu")
    coords = col.mesh_coords(mesh)
    full = init_params(cfg, 0, device="cpu")["blocks"]["sub0"]["mixer"][
        "in_zx"]
    ok = []
    for zero in (0, 3):
        spec = sh.param_specs(cfg, param_shapes(cfg), mesh,
                              zero_data=zero >= 3)["blocks"]["sub0"][
                                  "mixer"]["in_zx"]
        shard = col.shard_leaf(full, spec, mesh, coords, name="in_zx",
                               ssm_heads=cfg.n_ssm_heads)
        ok.append(torch.equal(col.gather_leaf(shard, spec, mesh, "in_zx",
                                              cfg.n_ssm_heads), full))
    return ok


def _pod_round_trip():
    """A leaf cut over ("pod", "data") on a (2, 2, 1) pod mesh and
    gathered back (``gather_leaf``, as a checkpoint of a pod plan gathers
    it): equal to the leaf, on this rank."""
    mesh = make_plan_mesh(2, 1, device_type="cpu", pods=2)
    full = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    spec = (("pod", "data"), None)
    shard = col.shard_leaf(full, spec, mesh, col.mesh_coords(mesh))
    return torch.equal(col.gather_leaf(shard, spec, mesh), full)


def _aux_grads(rank, d):
    """deepseek smoke's gradients of AUX_WEIGHT * aux alone on the rank's
    rows of each (MB * d)-row microbatch of (d, 1), summed over data and
    divided by n_micro * d as the step does, gathered to rank 0."""
    cfg, tc = config("deepseek-v2-236b"), train_config(0)
    mesh = make_plan_mesh(d, 1, device_type="cpu")
    specs = sh.param_specs(cfg, param_shapes(cfg), mesh)
    par = col.ModelParallel(mesh, specs["embed"], specs.get("lm_head"))
    params = tree_map(lambda p: p.float().requires_grad_(True),
                      init_params(cfg, tc.seed, device="cpu"))
    tokens = batches(cfg)[0]["tokens"]
    n_micro = resolve_microbatches(tc, B, mesh)
    for i in range(n_micro):
        lo = (i * d + rank) * MB
        _, _, aux = forward(cfg, params, {"tokens": tokens[lo:lo + MB]},
                            want_aux=True, par=par)
        (AUX_WEIGHT * aux).backward()
    out = []
    for p in tree_leaves(params):
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        dist.all_reduce(g)
        out.append((g / (n_micro * d)).numpy())
    return out


def _work(rank, world, out_dir):
    out = {}
    for w, arch, d, t, zero in CASES:
        if w != world:
            continue
        res = _case(arch, d, t, zero)
        key = _key(arch, d, t, zero)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{key}.npz"), *res["grads"])
        out[key] = {k: res[k] for k in ("gnorm", "losses", "bf16_gnorm",
                                         "bad", "opt_bytes")}
    for d, t in MESHES[world]:
        out[f"in_zx-{d}x{t}"] = _in_zx_round_trip(d, t)
    if world == 4:
        out["pod-gather"] = _pod_round_trip()
    if world == 2:
        grads = _aux_grads(rank, 2)
        if rank == 0:
            np.savez(os.path.join(out_dir, "aux.npz"), *grads)
    return out


def _single():
    """{(arch, d): (fp32 step-1 grads, grad norm, bf16 losses, opt bytes)}
    of the single-process port step at microbatches of MB * d rows."""
    out = {}
    for arch in ARCHS:
        cfg = config(arch)
        data = batches(cfg)
        for d in (1, 2):
            tc = train_config(1, microbatch=MB * d)
            state = as_fp32(make_train_state(cfg, tc, device="cpu"))
            grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                        resolve_microbatches(tc, B))
            gnorm = float(global_norm(grads))          # the step's grad norm
            grads = [g.numpy() for g in tree_leaves(grads)]
            step, _ = build_train_step(cfg, tc, B, S)
            state = make_train_state(cfg, tc, device="cpu")
            opt_bytes = nbytes(state["opt"])
            losses = [float(step(state, batch)[1]["loss"]) for batch in data]
            out[arch, d] = (grads, gnorm, losses, opt_bytes)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks, single, the JAX run): ranks {world: (out_dir, [each rank's
    results])} from one spawn per world size, every case of that size
    inside it; the single-process results (``_single``) and the JAX
    package's sharded step on ``JAX_JOB``, all at once."""
    dirs = {world: tmp_path_factory.mktemp(f"world{world}")
            for world in MESHES}
    jax_run = start_jax(dirs[4], [JAX_JOB])
    try:
        spawns = {world: spawn_ranks(_work, world, dirs[world])
                  for world in MESHES}
        single = _single()
        ranks = {world: (dirs[world], join_ranks(ctx, world, dirs[world]))
                 for world, ctx in spawns.items()}
    except BaseException:
        jax_run.kill()
        raise
    return ranks, single, jax_results(jax_run)[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _key(arch, d, t, zero):
    return f"{arch}-{d}x{t}-zero{zero}"


RUN = CASES
RUN_IDS = [_key(*c[1:]) for c in RUN]


@pytest.mark.parametrize("world,arch,d,t,zero", RUN, ids=RUN_IDS)
def test_step1_grads_match_single_process(ranks, single, world, arch, d, t,
                                          zero):
    out_dir, res = ranks[world]
    key = _key(arch, d, t, zero)
    got = np.load(out_dir / f"{key}.npz")
    want, want_norm, _, _ = single[arch, d]
    names = list(paths(param_shapes(config(arch))))
    assert len(got.files) == len(want) == len(names)
    for i, (name, w) in enumerate(zip(names, want)):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        tol = VECTOR_TOL if name.split("/")[-1] in SSM_VECTORS else GRAD_TOL
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())
    for r in res:
        assert abs(r[key]["gnorm"] - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("world,arch,d,t,zero", RUN, ids=RUN_IDS)
def test_bf16_losses_match_single_process(ranks, single, world, arch, d, t,
                                          zero):
    _, res = ranks[world]
    want = single[arch, d][2]
    for r in res:
        got = r[_key(arch, d, t, zero)]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got[-1] < got[0]


@pytest.mark.parametrize("world,arch,d,t,zero", RUN, ids=RUN_IDS)
def test_shards_have_the_specs_shapes(ranks, world, arch, d, t, zero):
    _, res = ranks[world]
    for r in res:
        assert r[_key(arch, d, t, zero)]["bad"] == []


OPT = [c for c in RUN if c[2] > 1 and c[4] >= 1]


@pytest.mark.parametrize("world,arch,d,t,zero", OPT,
                         ids=[_key(*c[1:]) for c in OPT])
def test_optimizer_bytes_shard_over_data(ranks, single, world, arch, d, t,
                                         zero):
    """At ZeRO >= 1 a rank's optimizer bytes are 1/d of the (1, t) run's,
    but for the leaves whose dims d does not divide (kept whole)."""
    _, res = ranks[world]
    cfg = config(arch)
    if t == 1:
        base = single[arch, 1][3]
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


@pytest.mark.parametrize("world,d,t", [(w, d, t) for w, m in MESHES.items()
                                       for d, t in m])
def test_mamba2_zero3_over_data_is_refused(ranks, world, d, t):
    """mamba2 smoke at ZeRO 3 is no longer refused: with d = 2 its specs
    shard some block leaves over data on the stacked layer axis only, and
    every rank ran the case (its gradients and losses are held by the
    tests above) on shards of the specs' shapes."""
    _, res = ranks[world]
    if d > 1:
        assert stacked_data_leaves("mamba2-130m", d, t, 3)
    for r in res:
        got = r[_key("mamba2-130m", d, t, 3)]
        assert got["bad"] == [] and len(got["losses"]) == STEPS


@pytest.mark.parametrize("world,d,t", [(w, d, t) for w, m in MESHES.items()
                                       for d, t in m])
def test_in_zx_shards_gather_back(ranks, world, d, t):
    """``gather_leaf(shard_leaf(in_zx)) == in_zx`` at ZeRO 0 and 3 on every
    rank."""
    _, res = ranks[world]
    for r in res:
        assert r[f"in_zx-{d}x{t}"] == [True, True]


@pytest.mark.parametrize("t", [2, 4])
def test_in_zx_shard_holds_its_heads_z_and_x(t):
    """Rank r's ``in_zx`` shard is [z | x] of its own heads: its first half
    the z columns of heads r h/t .. (r+1) h/t, its second half their x
    columns; the shard has the spec's shape."""
    cfg = config("mamba2-130m")
    di, hp = cfg.d_inner, cfg.ssm_head_dim
    h_local = cfg.n_ssm_heads // t
    mesh = {"data": 1, "model": t}
    full = torch.arange(3 * 2 * di, dtype=torch.float32).view(3, 2 * di)
    spec = sh.leaf_spec(cfg, ("blocks", "sub0", "mixer", "in_zx"),
                        (1, 3, 2 * di), mesh)[1:]
    assert spec == (None, "model")
    for r in range(t):
        shard = col.shard_leaf(full, spec, mesh, {"data": 0, "model": r},
                               name="in_zx", ssm_heads=cfg.n_ssm_heads)
        assert tuple(shard.shape) == col.local_shape(full.shape, spec, mesh)
        cols = slice(r * h_local * hp, (r + 1) * h_local * hp)
        half = shard.shape[1] // 2
        assert torch.equal(shard[:, :half], full[:, :di][:, cols])
        assert torch.equal(shard[:, half:], full[:, di:][:, cols])
    # a leaf of another name is cut into plain contiguous columns
    plain = col.shard_leaf(full, spec, mesh, {"data": 0, "model": 0})
    assert torch.equal(plain, full[:, :2 * di // t])


@pytest.mark.parametrize("name", ["in_zx", "conv_x_b", "out_proj"])
def test_ssm_leaf_shard_needs_the_head_count(name):
    """A Mamba2 leaf over d_inner on a model axis of 2 has one layout,
    placed by the SSD head count: cut or gathered without it, it raises
    rather than fall back to contiguous columns."""
    cfg = config("mamba2-130m")
    mesh = {"data": 1, "model": 2}
    full = init_params(cfg, 0, device="cpu")["blocks"]["sub0"]["mixer"][name]
    spec = sh.param_specs(cfg, param_shapes(cfg), mesh)["blocks"]["sub0"][
        "mixer"][name]
    assert "model" in spec
    with pytest.raises(ValueError, match="SSD head count"):
        col.shard_leaf(full, spec, mesh, {"data": 0, "model": 0}, name=name)
    with pytest.raises(ValueError, match="SSD head count"):
        col._ssm_index(full.shape[spec.index("model")], name, 0, 2, "cpu",
                       None)


def test_aux_loss_grads_over_data_match_single_process(ranks):
    """The MoE load-balance loss's gradients alone under (2, 1): each rank
    averages me and ce over the data axis, so the gradients summed over
    the ranks (and divided by n_micro * d) equal the single process's over
    the global microbatches."""
    out_dir, _ = ranks[2]
    got = np.load(out_dir / "aux.npz")
    cfg, tc = config("deepseek-v2-236b"), train_config(0, microbatch=2 * MB)
    params = tree_map(lambda p: p.float().requires_grad_(True),
                      init_params(cfg, tc.seed, device="cpu"))
    tokens = batches(cfg)[0]["tokens"]
    n_micro = resolve_microbatches(tc, B)
    for i in range(n_micro):
        _, _, aux = forward(cfg, params,
                            {"tokens": tokens[i * 2 * MB:(i + 1) * 2 * MB]},
                            want_aux=True)
        (AUX_WEIGHT * aux).backward()
    names = list(paths(param_shapes(cfg)))
    for i, (name, p) in enumerate(zip(names, tree_leaves(params))):
        w = (torch.zeros_like(p) if p.grad is None
             else p.grad / n_micro).detach().numpy()
        g = got[f"arr_{i}"]
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), \
            name
        if name.endswith("router"):        # every layer's router has one
            assert (np.abs(w).reshape(cfg.num_layers, -1).max(axis=1)
                    > 0).all()


@pytest.mark.parametrize("arch,t", [("deepseek-v2-236b", 16),
                                    ("jamba-1.5-large-398b", 8),
                                    ("mamba2-130m", 8),
                                    ("mixtral-8x22b", 8)])
def test_the_families_are_accepted_on_the_model_axis(arch, t):
    """MLA, MoE (both layouts) and Mamba2 at t > 1 and MoE at d > 1, whole
    configs, on mapping stand-ins of the mesh (no process group)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    for zero in (0, 1):
        check_sharded_supported(cfg, train_config(zero),
                                {"data": 2, "model": t})


@pytest.mark.parametrize("arch,mesh,zero,match", [
    ("deepseek-v2-236b", {"data": 1, "model": 16}, 1, "qk head dim"),
    ("deepseek-v2-236b", {"pod": 2, "data": 1, "model": 16}, 3,
     "qk head dim"),
], ids=["fallback", "pod"])
def test_deferred_plans_still_raise(arch, mesh, zero, match):
    """deepseek-v2 smoke's 8 MLA heads at t=16 take the head_dim / seq
    fallback, which MLA now runs: accepted on a (data, model) mesh and on
    one with the pod axis (tests/test_torch_mla_seq.py runs the
    fallback).  What the fallback still refuses -- an MLA head width the
    model axis does not divide (dn + dr = 40 at t = 16) -- raises naming
    ``sharding.DEFERRED``, never run replicated."""
    cfg = smoke_config(arch)
    assert not sh.attn_head_sharded(cfg, mesh["model"])
    check_sharded_supported(cfg, train_config(zero), mesh)
    with pytest.raises(NotImplementedError, match=sh.DEFERRED) as e:
        check_sharded_supported(cfg.scaled(qk_rope_head_dim=8),
                                train_config(zero), mesh)
    assert e.match(match)


def test_zero3_over_the_stacked_axis_still_raises():
    """ZeRO 3 over the stacked layer axis no longer raises: mamba2 smoke on
    (2, 2) and whole mamba2-130m on (2, 4) and, with the pod axis, (2, 2,
    4) are accepted, and their specs do shard block leaves over data on
    that axis alone (the step gathers them whole before the blocks)."""
    from repro_torch.configs import get_arch
    assert stacked_data_leaves("mamba2-130m", 2, 2, 3)
    check_sharded_supported(config("mamba2-130m"), train_config(3),
                            {"data": 2, "model": 2})
    for mesh in ({"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 4}):
        cfg = get_arch("mamba2-130m")
        specs = state_specs(cfg, train_config(3), mesh, param_shapes(cfg))
        assert any(col.data_dim(s) == 0
                   for s in tree_leaves(specs["params"]["blocks"]))
        check_sharded_supported(cfg, train_config(3), mesh)


def test_sharded_checkpoint_still_raises(ranks):
    """A leaf sharded over the pod axis, ("pod", "data"), gathers back to
    the whole leaf on every rank of a (2, 2, 1) mesh: checkpoints of pod
    plans are written (``gather_state``; whole states in
    tests/test_torch_multirank_pod.py)."""
    _, res = ranks[4]
    assert [r["pod-gather"] for r in res] == [True] * 4


def test_mamba2_zero3_losses_match_the_jax_sharded_step(runs):
    """mamba2 smoke at ZeRO 3 on (2, 2), its per-head and per-channel
    vectors gathered on the stacked layer axis: every rank's four bf16
    losses and step 1's bf16 grad norm against the JAX package's sharded
    step on 4 host devices, from the same parameters and batches."""
    ranks, _, want = runs
    d, t = JAX_JOB["mesh"]
    for r in ranks[d * t][1]:
        got = r[_key(JAX_JOB["arch"], d, t, JAX_JOB["zero"])]
        assert len(got["losses"]) == len(want["losses"])
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got["bf16_gnorm"] - want["grad_norm"]) \
            <= LOSS_TOL * want["grad_norm"]
