"""MLA off its head-sharded layout, on the CPU: a decode cache split over the
sequence (a global batch the data axes do not divide) and the head_dim /
seq fallback (a model axis that does not divide the heads), one spawn of
4 ``gloo`` processes, held against the single-process port and the JAX
package's sharded step and serving on 4 host devices.

Plans (deepseek-v2 smoke, MLA with MoE; ``HEADS`` replaces its 8 heads):

* ``seq-2x2``: 8 heads on (2, 2), a global batch of 1: the heads split
  over the model axis, the latent cache's slots over the data axis; each
  rank decodes its slots with their log-sum-exp (``flash_decode_mla``'s
  ``return_lse``) and the ranks merge over the data axis;
* ``h6-1x4``: 6 heads on (1, 4), the fallback: ``wq_b``, ``wk_b`` and
  ``wv_b`` split their columns, the attention the sequence (train and
  prefill), and a decode rank takes S/t of the slots, merged over the
  model axis;
* ``h3-2x2``: 3 heads on (2, 2), both at once: the fallback over the
  model axis and, at a global batch of 1, the slots over the data axis.

Train ``h6-1x4`` at ZeRO 1 and 3 and ``h3-2x2`` at ZeRO 1; serve all
three: a prompt, then four decode steps.  Tolerances as
tests/test_torch_multirank_ssm_split.py's: step 1's float32 gradients
within 1e-5 of max |g| a leaf, the grad norm within 1e-5 relative, four
bf16 losses within 2e-2 of the single process's and of the JAX sharded
step's (with step 1's bf16 grad norm); float32 logits and caches within
2e-5 of max |value| of the single process's and of each JAX device's
cache shard; the float32 greedy tokens equal.  This file also holds the
plain MLA decodes' ``return_lse`` against a log-sum-exp computed
directly.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_decode import mla_decode_ref, mla_decode_splitk
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import init_params, param_shapes
from repro_torch.models.transformer import cache_shapes, local_cache_specs
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.serve import greedy_decode, serve_parallel
from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          check_sharded_supported,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, MB, S, as_fp32, bad_shards, batches,
    close, jax_results, join_ranks, one_thread, paths, serve_run, spawn_ranks,
    start_jax, start_jax_serve, train_config)

ARCH = "deepseek-v2-236b"
WORLD = 4
# key: (replaced config fields, mesh (data, model), serving: global batch,
# prompt length, cache length)
PLANS = {"seq-2x2": ({}, (2, 2), (1, 12, 32)),
         "h6-1x4": ({"num_heads": 6, "num_kv_heads": 6}, (1, 4),
                    (2, 8, 16)),
         "h3-2x2": ({"num_heads": 3, "num_kv_heads": 3}, (2, 2),
                    (1, 12, 32))}
TRAIN = [("h6-1x4", 1), ("h6-1x4", 3), ("h3-2x2", 1)]
JAX_TRAIN = [("h6-1x4", 1), ("h3-2x2", 1)]
DECODES = 4
SEED = 5
FP32_TOL = 2e-5


def config(key):
    return dataclasses.replace(smoke_config(ARCH), **PLANS[key][0])


def _tkey(key, zero):
    return f"{key}-zero{zero}"


def _mesh(key):
    d, t = PLANS[key][1]
    return make_plan_mesh(d, t, device_type="cpu")


def _train_case(key, zero):
    """Step 1's gathered fp32 gradients, their norm, four bf16 losses and
    step 1's bf16 grad norm, the shards off their specs' shapes."""
    cfg, tc = config(key), train_config(zero)
    mesh = _mesh(key)
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)
    data = batches(cfg, step.rows)
    state = as_fp32(make_local_state(cfg, tc, mesh, device="cpu"))
    acc, _ = step.accumulate(state["params"], data[0])
    grads = [col.gather_leaf(g, s, mesh).numpy() for g, s in
             zip(acc, tree_leaves(specs["opt"]["master"]))]
    gnorm = float(step.global_norm(acc))
    state = make_local_state(cfg, tc, mesh, device="cpu")
    bad = bad_shards(state, specs, param_shapes(cfg), mesh)
    metrics = [step(state, batch)[1] for batch in data]
    return grads, {"gnorm": gnorm, "bad": bad,
                   "losses": [float(m["loss"]) for m in metrics],
                   "bf16_gnorm": float(metrics[0]["grad_norm"])}


def prompts(cfg, b, s):
    return torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s)))


def fp32_params(cfg):
    return tree_map(lambda p: p.float(), init_params(cfg, SEED, device="cpu"))


def rows_of(key, coords):
    """A rank's rows of the global batch: all of them when the data axis
    does not divide it (the cache splits its slots instead)."""
    b = PLANS[key][2][0]
    d = PLANS[key][1][0]
    if b % d:
        return slice(None)
    return slice(coords["data"] * b // d, (coords["data"] + 1) * b // d)


def _serve_case(key, out_dir, rank):
    """One serving plan on this rank: its float32 run and greedy tokens
    (saved), the cache leaves off their specs' shapes."""
    cfg = config(key)
    b, p, L = PLANS[key][2]
    mesh = _mesh(key)
    coords = col.mesh_coords(mesh)
    par = serve_parallel(cfg, mesh, b, L)
    specs = sh.param_specs(cfg, param_shapes(cfg), mesh)
    local = col.map_specs(lambda t, s, name: col.shard_leaf(
        t, s, mesh, coords, name=name, ssm_heads=cfg.n_ssm_heads),
        fp32_params(cfg), specs)
    rows = rows_of(key, coords)
    res = serve_run(cfg, local, prompts(cfg, b, p)[rows], L, DECODES, par)
    res["greedy"] = greedy_decode(cfg, local, prompts(cfg, b, p)[rows],
                                  DECODES + 1, L, par).numpy()
    np.savez(os.path.join(out_dir, f"serve-{key}-r{rank}.npz"), **res)
    sizes = sh.axis_sizes(mesh)
    cspecs = local_cache_specs(cfg, b, L, sizes)
    bad = []
    for sub, leaves in cache_shapes(cfg, b, L).items():
        for name, whole in leaves.items():
            want = col.local_shape(whole, cspecs[sub][name], sizes)
            for tag in ("prefill", "decode"):
                if res[f"{tag}/{sub}/{name}"].shape != want:
                    bad.append(f"{tag}/{sub}/{name}")
    return {"coords": coords, "bad": bad,
            "seq_split": par.seq_split,
            "head_sharded": par.attn_head_sharded}


def _work(rank, world, out_dir):
    out = {}
    for key, zero in TRAIN:
        grads, res = _train_case(key, zero)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{_tkey(key, zero)}.npz"),
                     *grads)
        out[_tkey(key, zero)] = res
    for key in PLANS:
        out[f"serve-{key}"] = _serve_case(key, out_dir, rank)
    return out


def _single():
    """The single-process results: {key: (fp32 step-1 grads, grad norm,
    bf16 losses)} at microbatches of MB d rows, {key: serving run}."""
    train, serve = {}, {}
    for key in PLANS:
        cfg = config(key)
        if any(k == key for k, _ in TRAIN):
            data = batches(cfg)
            d = PLANS[key][1][0]
            tc = train_config(1, microbatch=MB * d)
            state = as_fp32(make_train_state(cfg, tc, device="cpu"))
            grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                        resolve_microbatches(tc, B))
            gnorm = float(global_norm(grads))
            step, _ = build_train_step(cfg, tc, B, S)
            state = make_train_state(cfg, tc, device="cpu")
            losses = [float(step(state, batch)[1]["loss"]) for batch in data]
            train[key] = ([g.numpy() for g in tree_leaves(grads)], gnorm,
                          losses)
        b, p, L = PLANS[key][2]
        serve[key] = serve_run(cfg, fp32_params(cfg), prompts(cfg, b, p), L,
                               DECODES)
    return train, serve


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(out_dir, [each rank's results], single train, single serve, JAX
    train results): one spawn of 4 ranks for every case, the JAX
    subprocesses and the single-process runs beside it."""
    out_dir = tmp_path_factory.mktemp("mla_seq")
    jax_train = start_jax(out_dir, [
        {"arch": ARCH, "fields": PLANS[key][0], "mesh": PLANS[key][1],
         "zero": zero} for key, zero in JAX_TRAIN])
    jax_serve = start_jax_serve(out_dir, [
        {"name": f"serve-{key}", "arch": ARCH, "fields": PLANS[key][0],
         "mesh": PLANS[key][1], "batch": b, "cache_len": L,
         "params": fp32_params(config(key)),
         "prompt": prompts(config(key), b, p)}
        for key, (_, _, (b, p, L)) in PLANS.items()])
    try:
        ctx = spawn_ranks(_work, WORLD, out_dir)
        train, serve = _single()
        res = join_ranks(ctx, WORLD, out_dir)
        _, err = jax_serve.communicate(timeout=600)
        assert jax_serve.returncode == 0, err[-3000:]
        want_jax = jax_results(jax_train)
    finally:
        for proc in (jax_train, jax_serve):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out_dir, res, train, serve, want_jax


def _close(got, want):
    return close(got, want, FP32_TOL)


@pytest.mark.parametrize("key,seq_split,head_sharded", [
    ("seq-2x2", True, True), ("h6-1x4", False, False),
    ("h3-2x2", True, False)])
def test_the_plans_take_the_paths(key, seq_split, head_sharded):
    """Each plan is accepted and takes its path: the slots split over the
    data axis where the data axis does not divide the batch, the head_dim
    / seq fallback where the model axis does not divide the heads."""
    cfg = config(key)
    d, t = PLANS[key][1]
    b, _, L = PLANS[key][2]
    mesh = {"data": d, "model": t}
    check_sharded_supported(cfg, None, mesh)
    assert (b % d != 0) == seq_split
    assert sh.attn_head_sharded(cfg, t) == head_sharded


@pytest.mark.parametrize("key,zero", TRAIN, ids=[_tkey(*c) for c in TRAIN])
def test_step1_grads_match_single_process(runs, key, zero):
    out_dir, res, train, _, _ = runs
    got = np.load(out_dir / f"{_tkey(key, zero)}.npz")
    want, want_norm, _ = train[key]
    names = list(paths(param_shapes(config(key))))
    assert len(got.files) == len(want) == len(names)
    for i, (name, w) in enumerate(zip(names, want)):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err,
                                                   np.abs(w).max())
    for r in res:
        got_norm = r[_tkey(key, zero)]["gnorm"]
        assert abs(got_norm - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("key,zero", TRAIN, ids=[_tkey(*c) for c in TRAIN])
def test_bf16_losses_match_single_process(runs, key, zero):
    _, res, train, _, _ = runs
    want = train[key][2]
    for r in res:
        got = r[_tkey(key, zero)]
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert got["bad"] == []


@pytest.mark.parametrize("i,key,zero", [(i, *c) for i, c in
                                        enumerate(JAX_TRAIN)],
                         ids=[_tkey(*c) for c in JAX_TRAIN])
def test_losses_match_the_jax_sharded_step(runs, i, key, zero):
    """Every rank's four bf16 losses and step 1's bf16 grad norm against
    the JAX package's sharded step on the same mesh, from the same
    parameters and batches."""
    _, res, _, _, want_jax = runs
    want = want_jax[i]
    for r in res:
        got = r[_tkey(key, zero)]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got["bf16_gnorm"] - want["grad_norm"]) \
            <= LOSS_TOL * want["grad_norm"]


def _local(key, arr, what, coords):
    """The shard of a single-process array the rank at ``coords`` holds."""
    cfg = config(key)
    d, t = PLANS[key][1]
    b, _, L = PLANS[key][2]
    if what in ("logits", "tokens"):
        out = arr[rows_of(key, coords)]
        if what == "logits" and cfg.vocab_size % t == 0:
            w = cfg.vocab_size // t
            out = out[..., coords["model"] * w:(coords["model"] + 1) * w]
        return out
    _, sub, name = what.split("/")
    sizes = {"data": d, "model": t}
    spec = local_cache_specs(cfg, b, L, sizes)[sub][name]
    return col.shard_leaf(torch.from_numpy(arr), spec, sizes, coords).numpy()


def _each_rank(out_dir, res, key):
    for r, rank in enumerate(res):
        yield (rank[f"serve-{key}"]["coords"],
               np.load(out_dir / f"serve-{key}-r{r}.npz"))


@pytest.mark.parametrize("key", list(PLANS))
def test_serving_matches_single_process(runs, key):
    """Every rank's float32 logits of the prefill and four decode steps
    (its rows, its V/t columns) and its caches after the prefill, the
    first and the last decode step (its spec's shard: the slots it holds)
    within 2e-5 of the single process's; its greedy tokens, from the steps
    and from ``greedy_decode``, equal them; the shards have their specs'
    shapes."""
    out_dir, res, _, serve, _ = runs
    want = serve[key]
    for coords, got in _each_rank(out_dir, res, key):
        for i in range(DECODES + 1):
            ok, err = _close(got[f"logits{i}"],
                             _local(key, want[f"logits{i}"], "logits",
                                    coords))
            assert ok, (coords, i, err)
        names = [n for n in want if "/" in n]
        assert sorted(n for n in got.files if "/" in n) == sorted(names)
        for n in names:
            ok, err = _close(got[n], _local(key, want[n], n, coords))
            assert ok, (coords, n, err)
        mine = _local(key, want["tokens"], "tokens", coords)
        assert np.array_equal(got["tokens"], mine), coords
        assert np.array_equal(got["greedy"], mine), coords
    for r in res:
        assert r[f"serve-{key}"]["bad"] == []


@pytest.mark.parametrize("key", list(PLANS))
def test_caches_match_the_jax_sharded_serving(runs, key):
    """Each JAX device's shard of the prefill caches and of one decode
    step's, from the same float32 parameters, prompt and first token: the
    port's rank at the same mesh coordinates holds it within 2e-5; the
    JAX logits match the single process's."""
    out_dir, res, _, serve, _ = runs
    jax_out = np.load(out_dir / f"jax-serve-{key}.npz")
    want = serve[key]
    assert np.array_equal(jax_out["tokens"], want["tokens"][:, :1])
    for i in (0, 1):
        ok, err = _close(want[f"logits{i}"], jax_out[f"logits{i}"])
        assert ok, (i, err)
    seen = 0
    for coords, got in _each_rank(out_dir, res, key):
        at = str((coords["data"], coords["model"]))
        for n in jax_out.files:
            if n.endswith("@" + at):
                ok, err = _close(got[n.split("@")[0]], jax_out[n])
                assert ok, (n, err)
                seen += 1
    assert seen and seen == sum(1 for n in jax_out.files if "@" in n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_lse_is_the_whole_softmax(dtype):
    """``mla_decode_ref`` and ``mla_decode_splitk`` with ``return_lse``: the
    float32 output of the whole-cache softmax over the latent and its
    log-sum-exp (``torch.logsumexp`` of the masked float32 scores); a row
    with no valid slot gives 0 and -inf exactly; without the flag the
    output keeps c_kv's dtype."""
    g = torch.Generator().manual_seed(4)
    b, S, H, r, dr = 3, 96, 8, 32, 16
    denom = math.sqrt(32 + dr)
    q_lat = torch.randn(b, H, r, generator=g).to(dtype)
    q_rope = torch.randn(b, H, dr, generator=g).to(dtype)
    c_kv = torch.randn(b, S, r, generator=g).to(dtype)
    k_rope = torch.randn(b, S, dr, generator=g).to(dtype)
    valid = torch.rand(b, S, generator=g) < 0.5
    valid[2] = False
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                             k_rope.float())) / denom
    scores = scores.masked_fill(~valid[:, None], -math.inf)
    p = torch.softmax(scores[:2], dim=-1)
    want_o = torch.einsum("bhs,bsr->bhr", p, c_kv[:2].float())
    want_lse = torch.logsumexp(scores[:2], dim=-1)
    for o, lse in (mla_decode_ref(q_lat, q_rope, c_kv, k_rope, valid,
                                  denom=denom, return_lse=True),
                   mla_decode_splitk(q_lat, q_rope, c_kv, k_rope, valid,
                                     denom=denom, block_s=32,
                                     return_lse=True)):
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        assert tuple(o.shape) == (b, H, r) and tuple(lse.shape) == (b, H)
        assert (o[:2] - want_o).abs().max() <= tol * want_o.abs().max()
        assert (lse[:2] - want_lse).abs().max() <= (
            1e-5 if dtype == torch.float32 else 2e-2)
        assert (o[2] == 0).all() and (lse[2] == -math.inf).all()
    assert mla_decode_ref(q_lat, q_rope, c_kv, k_rope, valid,
                          denom=denom).dtype == dtype
