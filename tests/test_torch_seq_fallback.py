"""The sharded train step on the head_dim / seq fallback, on the CPU: GQA
whose head counts do not divide the model axis t shards its weights'
head_dim and its attention's sequence (the JAX package's ``"seq"``
activation sharding), so each rank attends its s/t query rows against every
key at a query offset.  One spawn of 4 ``gloo`` processes against the
single-process port step (tests/test_torch_multirank.py's pattern), and
against the JAX package's own sharded step on 4 host devices.

Plans (data, model):

* starcoder2-3b smoke (8/2 heads of 32, window 16) on (1, 4) at ZeRO 0, 1
  and 3: s = 64, so 16 rows a rank, and the window crosses the ranks'
  boundaries;
* mixtral-8x22b smoke with 2 KV heads on (1, 4) at ZeRO 1 (its smoke
  config's 8/4 heads divide t = 4, so ``num_kv_heads`` is cut to 2 to put
  its attention on the fallback beside its expert-parallel MoE);
* starcoder2-3b smoke with 1 KV head on (2, 2) at ZeRO 1 and 3 (the
  fallback beside the data axis; at ZeRO 3 the data gather of the
  head_dim-sharded attention weights and its reduce-scatter backward run
  with it, as on the (16, 16) plans of mixtral, jamba and llava).

Tolerances, as tests/test_torch_multirank.py's and for the same reasons:
step 1's accumulated fp32 gradients within 1e-5 max |g| per leaf and the
grad norm within 1e-5 relative (the ranks sum the same products in other
orders); bf16 losses over four steps within 2e-2, the JAX package's own
multi-device tolerance (tests/test_multidevice.py:77), against the
single-process step and against the JAX package's sharded step on (1, 4)
from the same parameters; every rank's shards have the specs' shapes.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.inputs import default_train_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          check_sharded_supported,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, S, STEPS, as_fp32, bad_shards,
    batches, jax_results, join_ranks, one_thread, spawn_ranks, start_jax,
    train_config)

WORLD = 4
# (name, arch, replaced config fields, d, t, zero)
CASES = [("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 0),
         ("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 1),
         ("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 3),
         ("mixtral-kv2", "mixtral-8x22b", dict(num_kv_heads=2), 1, 4, 1),
         ("starcoder2-kv1", "starcoder2-3b", dict(num_kv_heads=1), 2, 2, 1),
         ("starcoder2-kv1", "starcoder2-3b", dict(num_kv_heads=1), 2, 2, 3)]
# the JAX package's sharded step on the same plan
JAX_JOB = {"arch": "starcoder2-3b", "fields": {}, "mesh": (1, 4), "zero": 1}
# the GQA configs of the assigned set whose head counts do not divide t = 16
FALLBACK_ARCHS = ["starcoder2-3b", "starcoder2-7b", "stablelm-12b",
                  "mixtral-8x22b", "jamba-1.5-large-398b", "llama3.2-3b",
                  "llava-next-34b", "musicgen-medium"]


def config(name):
    arch, fields = next((a, f) for n, a, f, *_ in CASES if n == name)
    return dataclasses.replace(smoke_config(arch), **fields)


def _key(name, d, t, zero):
    return f"{name}-{d}x{t}-zero{zero}"


def _case(name, d, t, zero):
    cfg, tc = config(name), train_config(zero)
    mesh = make_plan_mesh(d, t, device_type="cpu")
    assert not sh.attn_head_sharded(cfg, t)
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
    losses = [float(step(state, batch)[1]["loss"]) for batch in data]
    return {"grads": grads, "gnorm": gnorm, "losses": losses, "bad": bad}


def _work(rank, world, out_dir):
    out = {}
    for name, _, _, d, t, zero in CASES:
        res = _case(name, d, t, zero)
        key = _key(name, d, t, zero)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{key}.npz"), *res["grads"])
        out[key] = {k: res[k] for k in ("gnorm", "losses", "bad")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(out_dir, [each rank's results], the JAX run's losses): the JAX
    subprocess and the one spawn of 4 ranks run at once."""
    tmp = tmp_path_factory.mktemp("seq_fallback")
    jax_run = start_jax(tmp, [JAX_JOB])
    try:
        res = join_ranks(spawn_ranks(_work, WORLD, tmp), WORLD, tmp)
    except BaseException:
        jax_run.kill()
        raise
    return tmp, res, jax_results(jax_run)[0]["losses"]


@pytest.fixture(scope="module")
def single():
    """{name: (fp32 step-1 grads, grad norm, bf16 losses)} of the
    single-process port step."""
    out = {}
    for name in dict.fromkeys(n for n, *_ in CASES):
        cfg, tc = config(name), train_config(1)
        data = batches(cfg)
        state = as_fp32(make_train_state(cfg, tc, device="cpu"))
        grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                    resolve_microbatches(tc, B))
        grads = [g.numpy() for g in tree_leaves(grads)]
        step, _ = build_train_step(cfg, tc, B, S)
        state = as_fp32(make_train_state(cfg, tc, device="cpu"))
        gnorm = float(step(state, data[0])[1]["grad_norm"])
        state = make_train_state(cfg, tc, device="cpu")
        losses = [float(step(state, batch)[1]["loss"]) for batch in data]
        out[name] = (grads, gnorm, losses)
    return out


IDS = [_key(n, d, t, z) for n, _, _, d, t, z in CASES]
PARAMS = [(n, d, t, z) for n, _, _, d, t, z in CASES]


@pytest.mark.parametrize("name,d,t,zero", PARAMS, ids=IDS)
def test_step1_grads_match_single_process(runs, single, name, d, t, zero):
    out_dir, res, _ = runs
    key = _key(name, d, t, zero)
    got = np.load(out_dir / f"{key}.npz")
    want, want_norm, _ = single[name]
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, i
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (i, err, np.abs(w).max())
    for r in res:
        assert abs(r[key]["gnorm"] - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("name,d,t,zero", PARAMS, ids=IDS)
def test_bf16_losses_match_single_process(runs, single, name, d, t, zero):
    _, res, _ = runs
    want = single[name][2]
    for r in res:
        got = r[_key(name, d, t, zero)]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got[-1] < got[0]


@pytest.mark.parametrize("name,d,t,zero", PARAMS, ids=IDS)
def test_shards_have_the_specs_shapes(runs, name, d, t, zero):
    _, res, _ = runs
    for r in res:
        assert r[_key(name, d, t, zero)]["bad"] == []


def test_bf16_losses_match_the_jax_sharded_step(runs):
    """starcoder2-3b smoke on (1, 4) at ZeRO 1: the port's four ranks'
    bf16 losses against the JAX package's sharded step on 4 host devices,
    from the same parameters and batches."""
    _, res, jax_losses = runs
    assert len(jax_losses) == STEPS
    for r in res:
        np.testing.assert_allclose(r[_key("starcoder2-3b", 1, 4, 1)]["losses"],
                                   jax_losses, rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("arch", FALLBACK_ARCHS)
def test_production_mesh_plans_are_supported(arch):
    """Every GQA config of the assigned set whose head counts do not
    divide t = 16 runs sharded on (16, 16), at the serverless default
    ZeRO stage (3 above 20e9 parameters, else 1)."""
    cfg = get_arch(arch)
    assert not sh.attn_head_sharded(cfg, 16)
    tc = default_train_config(cfg, dataclasses.replace(
        INPUT_SHAPES["train_4k"], global_batch=16))
    check_sharded_supported(cfg, tc, {"data": 16, "model": 16})


def test_mla_on_the_fallback_still_raises():
    """deepseek-v2 smoke's 8 MLA heads on a model axis of 16 take the
    head_dim / seq fallback, which MLA now runs
    (tests/test_torch_mla_seq.py holds it): accepted, its widths checked
    against t on that path (dn + dr = 48, dn = 32, dv = 32), not
    ``head_dim``; a width t does not divide is still refused."""
    cfg = smoke_config("deepseek-v2-236b")
    assert not sh.attn_head_sharded(cfg, 16)
    check_sharded_supported(cfg, train_config(1), {"data": 1, "model": 16})
    with pytest.raises(NotImplementedError, match="v head dim"):
        check_sharded_supported(cfg.scaled(v_head_dim=24), train_config(1),
                                {"data": 1, "model": 16})
